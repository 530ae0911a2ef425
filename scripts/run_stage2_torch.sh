#!/usr/bin/env bash
# Stage-2 inpainting training launcher on CUDA cards (the PyTorch port's
# counterpart of run_stage2.sh, the reference's run_stage2.sh: accelerate
# launch --num_processes 8 --use_deepspeed ...): one process per card
# through torchrun (data parallel, NCCL; add --zero1 to shard the AdamW
# state); NPROC cards (default: all that nvidia-smi lists).
set -euo pipefail

torchrun --nproc_per_node "${NPROC:-$(nvidia-smi -L | wc -l)}" -m pcdms_tpu_torch.cli.stage2_train \
  --pretrained_model_name_or_path="${SD21_PATH:?set SD21_PATH}" \
  --image_encoder_p_path="${DINOV2_PATH:?set DINOV2_PATH}" \
  --image_encoder_g_path="${CLIP_PATH:?set CLIP_PATH}" \
  --json_path="${DATA_JSON:?set DATA_JSON}" \
  --image_root_path="${IMAGE_ROOT:?set IMAGE_ROOT}" \
  --output_dir="${OUTPUT_DIR:-out_stage2}" \
  --img_height=512 \
  --img_width=512 \
  --learning_rate=1e-4 \
  --train_batch_size=8 \
  --max_train_steps=1000000 \
  --mixed_precision=bf16 \
  --checkpointing_steps=5000 \
  --noise_offset=0.1 \
  --lr_warmup_steps 5000 \
  --seed 42 \
  "$@"
