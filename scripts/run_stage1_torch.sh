#!/usr/bin/env bash
# Stage-1 prior training launcher on CUDA cards (the PyTorch port's
# counterpart of run_stage1.sh, the reference's run_stage1.sh: bs 128,
# lr 1e-5, 100k steps): one process per card through torchrun; NPROC
# cards (default: all that nvidia-smi lists).
set -euo pipefail

torchrun --nproc_per_node "${NPROC:-$(nvidia-smi -L | wc -l)}" -m pcdms_tpu_torch.cli.stage1_train \
  --image_encoder_path="${CLIP_PATH:?set CLIP_PATH}" \
  --prior_path="${PRIOR_PATH:-}" \
  --json_path="${DATA_JSON:?set DATA_JSON}" \
  --image_root_path="${IMAGE_ROOT:?set IMAGE_ROOT}" \
  --output_dir="${OUTPUT_DIR:-out_stage1}" \
  --learning_rate=1e-5 \
  --train_batch_size=128 \
  --max_train_steps=100000 \
  --checkpointing_steps=5000 \
  --noise_offset=0.1 \
  --lr_warmup_steps 5000 \
  --seed 42 \
  "$@"
