#!/usr/bin/env bash
# Stage-3 refinement training launcher on CUDA cards (the PyTorch port's
# counterpart of run_stage3.sh, the reference's run_stage3.sh: bs 16,
# lr 1e-5, tensorboard reporting): one process per card through torchrun;
# NPROC cards (default: all that nvidia-smi lists).
set -euo pipefail

torchrun --nproc_per_node "${NPROC:-$(nvidia-smi -L | wc -l)}" -m pcdms_tpu_torch.cli.stage3_train \
  --pretrained_model_name_or_path="${SD21_PATH:?set SD21_PATH}" \
  --image_encoder_p_path="${DINOV2_PATH:?set DINOV2_PATH}" \
  --json_path="${DATA_JSON:?set DATA_JSON}" \
  --image_root_path="${IMAGE_ROOT:?set IMAGE_ROOT}" \
  --gen_dir="${GEN_DIR:?set GEN_DIR (stage-2 outputs)}" \
  --output_dir="${OUTPUT_DIR:-out_stage3}" \
  --learning_rate=1e-5 \
  --train_batch_size=16 \
  --max_train_steps=1000000 \
  --mixed_precision=bf16 \
  --checkpointing_steps=5000 \
  --noise_offset=0.1 \
  --report_to=tensorboard \
  --seed 42 \
  "$@"
