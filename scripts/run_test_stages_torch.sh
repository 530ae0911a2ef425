#!/usr/bin/env bash
# Full 3-stage inference sweep on a CUDA card (the PyTorch port's
# counterpart of run_test_stages.sh, the reference's
# run_test_stage{1,2,3}.sh): stage-1 .npy embeddings -> stage-2 best-of-4
# PNGs -> stage-3 refined PNGs -> metric sweep.
set -euo pipefail

OUT="${OUT:-results}"

python -m pcdms_tpu_torch.cli.stage1_batchtest \
  --json_path="${TEST_JSON:?set TEST_JSON}" \
  --image_root_path="${IMAGE_ROOT:?set IMAGE_ROOT}" \
  --weights_name="${STAGE1_CKPT:?set STAGE1_CKPT}" \
  --image_encoder_path="${CLIP_PATH:?set CLIP_PATH}" \
  --save_path="${OUT}/stage1" \
  --num_inference_steps 20 --guidance_scale 0

python -m pcdms_tpu_torch.cli.stage2_batchtest \
  --json_path="${TEST_JSON}" \
  --image_root_path="${IMAGE_ROOT}" \
  --weights_name="${STAGE2_CKPT:?set STAGE2_CKPT}" \
  --pretrained_model_name_or_path="${SD21_PATH:?set SD21_PATH}" \
  --image_encoder_p_path="${DINOV2_PATH:?set DINOV2_PATH}" \
  --prior_embeds_dir="${OUT}/stage1" \
  --save_path="${OUT}/stage2" \
  --num_inference_steps 20 --guidance_scale 2.0 --num_images_per_prompt 4

python -m pcdms_tpu_torch.cli.stage3_batchtest \
  --json_path="${TEST_JSON}" \
  --image_root_path="${IMAGE_ROOT}" \
  --weights_name="${STAGE3_CKPT:?set STAGE3_CKPT}" \
  --pretrained_model_name_or_path="${SD21_PATH}" \
  --image_encoder_p_path="${DINOV2_PATH}" \
  --gen_dir="${OUT}/stage2" \
  --save_path="${OUT}/stage3" \
  --num_inference_steps 20 --guidance_scale 2.0 --num_images_per_prompt 4

python -m pcdms_tpu_torch.cli.calculate_metrics \
  --fid_real_path="${FID_TRAIN_DIR:?set FID_TRAIN_DIR}" \
  --test_path="${TEST_GT_DIR:?set TEST_GT_DIR}" \
  --generated_path="${OUT}/stage3" \
  --resolution 512 --save_name "${OUT}/metrics" \
  ${INCEPTION_WEIGHTS:+--inception_weights "$INCEPTION_WEIGHTS"} \
  ${LPIPS_WEIGHTS:+--lpips_weights "$LPIPS_WEIGHTS"}
