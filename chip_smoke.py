"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. build the CUDA kernels from ``pcdms_tpu_torch/ops/csrc`` with nvcc (one
     process per source, started together: the flash-attention forward and
     backward kernels and the fused GroupNorm + SiLU + conv3x3 kernel), with
     each kernel's registers, spills and ptxas warnings (a short-kv or bf16
     fused-conv kernel that spills or has its wgmma serialised fails);
  2. hold each forward attention kernel against its plain PyTorch version on
     the card at the main path's shapes (bf16, with f32 spot checks; the
     short-kv kernel also at CLIP ViT-H's head_dim 80, at ragged shapes
     too; the frozen, online and
     online[exp_bf16] kernels, which in bf16 are warp-specialised, a TMA ring
     feeding wgmma, also at ragged shapes on both sides of their 128-row
     blocks and 128-key stages), and time the kernel, the plain version, and
     ``scaled_dot_product_attention`` as a yardstick at the three levels,
     and the frozen kernel, the LSE forward and SDPA at the reference
     protocol's batch 8 (B*H = 80); the short-kv kernel (in bf16
     persistent, k and v resident, TMA feeding wgmma) at its six head_dim-64
     shapes and at CLIP ViT-H's over 2, 4 and 8 images (``phase_shortkv``),
     it and SDPA timed by device time (CUDA-graph replay) beside ten
     back-to-back calls, which at these sizes read the host; CLIP ViT-H's
     full-width forward (batch 2, 224 px, random weights) under
     PCDMS_SHORTKV=pallas (32 short-kv launches at head_dim 80) against
     plain attention (``phase_clip``); then the fused conv kernel (in bf16
     an 8 x 16 pixel tile activated once per 64-channel chunk, weights by
     TMA, wgmma, split-K at the small levels) against its plain version at
     the 14 conv shapes of the full-width UNet (bf16, in the mode the UNet
     uses there), mode 0 and apply_act=False at level 0, f32, and ragged,
     split-K, smaller-than-a-tile and border shapes, each UNet shape timed
     by device time (CUDA-graph replay) beside the port's unfused route
     (GroupNorm -> SiLU -> cuDNN conv -> add), cuDNN's conv alone, the
     weight re-lay and the bound, the wrapper by ten back-to-back calls,
     and all of them summed over the 44 convs of a forward
     (``phase_fused_conv``); then kernels 1, 3 and 7 at the shapes the
     stage-3 UNet gives them at 512x512 (``phase_stage3_kernels``: the
     frozen kernel at 10 / 20 x 4096 / 1024 tokens and at the batch
     test's UNet batch 8, short-kv at 257 / 256 / 64 keys, the fused conv
     at the square levels down to 8x8), each against its plain version and
     timed beside SDPA's forward or the unfused route, and the bound;
  3. one full-width stage-2 UNet forward (512x1024 canvas, one pair,
     CFG-doubled to 2, bf16, random weights) with the kernels and with plain
     attention, compared by the relative L2 error of eps; the same under
     PCDMS_SHORTKV=pallas (17 short-kv launches); then the same weights with
     ``fused_conv=True`` (44 fused-conv launches) against the unfused
     forward, at batch 2 and at UNet batch 16 (the batch test's, where the
     device is the limit), both forwards timed (``phase_unet_batch16``);
  4. the sampler path: ``stage2_generate`` at full width (DDIM 4 steps and
     UniPC 3 steps at default routing, DDIM 2 steps under
     PCDMS_FROZEN_MAX=0 PCDMS_SHORTKV=pallas, and DDIM 4 steps with the
     fused UNet), with decode;
  4b. stage 3 (``phase_stage3``): the 8-channel stage-3 UNet at full width
     (64x64 latents, CFG batch 2, bf16) through the kernels against plain
     attention (10 frozen launches), under PCDMS_SHORTKV=pallas (22
     short-kv launches) and with the fused convs against the unfused
     forward (44 launches); then ``stage3_generate`` (UniPC 3 steps, 4
     samples, decode);
  4c. stage 1 (``phase_stage1``): the full PriorConfig() (about 1.0B
     parameters, f32, TF32 off) through ``stage1_generate``, 20 UnCLIP
     steps at batch 2, finite and the same bits for the same generator,
     one run profiled;
     the prior cut to 2 layers at full width on the card against the CPU;
  4d. ``cascade_generate`` at full width for one pair (``phase_cascade``):
     the prior 20 steps, stages 2 and 3 at UniPC 3 steps, 75 frozen
     launches, seconds per stage;
  4e. the sampler options (``phase_sampler_options``): encoder propagation
     in ``stage2_generate`` (DDIM 4 at interval 2: 48 frozen launches,
     136 fused-conv ones with the fused UNet, 52 short-kv ones under
     PCDMS_SHORTKV=pallas; the cached run through the kernels against plain
     attention; interval 2 over 1 step is interval 1 bit for bit) and in
     ``stage3_generate`` (UniPC 3 at interval 2: 26 frozen launches); a key
     step, a decode-only step and the full forward timed at UNet batch 2
     and 16; ancestral DDIM (eta 0.5); FreeU (neutral against none, SD-2.1's
     values); LCM on a w-conditioned copy of the stage-2 UNet (4 steps, no
     CFG doubling, the same bits twice);
  5. the backward kernels (LSE forward, dq, dk/dv) against their plain
     versions at the training shapes and at ragged ones on both sides of
     the block and stage sizes (bf16, one f32 spot check; the bf16 dq and
     dk/dv kernels are warp-specialised: a TMA ring in shared memory feeding
     wgmma), timed at the three levels against the plain versions and SDPA's
     forward / backward;
  6. one full-width UNet gradient (batch 1, 64x128 latents, bf16 compute,
     f32 master weights) through the kernels and through plain attention:
     relative L2 of the whole gradient and of level 0's to_q / to_k / to_v,
     every trainable parameter's gradient finite, 15 launches of each
     backward kernel;
  7. the training path at full width (512x1024 canvas, batch 2, bf16,
     lr 1e-4, warmup 1): from the random init, 5 steps on one batch with
     fixed draws (the loss must fall); then, from the same init,
     ``run_training`` with the stage-2 loss as ``cli/stage2_train.main``
     calls it: 4 steps, 2 steps with ``remat``, and 7 steps with a
     ``profile_dir`` trace of steps 3-6 (device time by kernel, busy
     share);
  7b. kernels 4-6 at the stage-3 trainer's shapes (``phase_bwd_stage3``:
     10 x 4096², 20 x 1024², 80 x 4096², bf16) against their plain versions,
     timed by CUDA-graph replay beside SDPA's forward and backward; the
     stage-3 trainer (``phase_train_stage3``): the 8-channel stage-3 UNet at
     512x512, f32 master weights, bf16 compute, one batch's loss and
     gradient through the kernels against plain attention, then
     ``run_training`` 4 steps at batch 2 and 2 steps at the CLI's batch 16
     with remat (10 launches of each kernel a step, 20 of the LSE forward
     with remat);
  7c. the stage-1 trainer (``phase_train_stage1``): the full PriorConfig()
     at the CLI's batch 128, 4 steps, bf16 compute on f32 weights; a
     2-layer full-width prior's loss and gradient, card vs CPU;
  7d. the three trainer CLIs' ``main`` at full width on DeepFashion-layout
     images (``phase_train_data``: 512x512, 2 pairs, batch 2, 2 steps):
     stage 2 with DINOv2-giant and CLIP ViT-H on the fly, stage 3 with
     DINOv2 and ``--gen_dir`` PNGs, stage 1 with CLIP ViT-H, then each from
     ``--cache_embeddings``: the cache's rows against the encoders' outputs,
     the memory held with and without the cache (the final checkpoint
     write is skipped there: 10-12 GB at full width);
  8. ``cli/stage2_train.main`` at the tiny config on the card, 2 steps, then
     resumed from its checkpoint to step 3;
  9. ``cli/stage2_batchtest.main`` at full width with random weights
     (DINOv2-giant, the SD-2.1 stage-2 UNet, the full VAE) on 2 synthetic
     512x512 pairs in the DeepFashion layout: test mode (UniPC 20 steps,
     best of 4, batch 2) with host selection and with ``--device_select``
     (the same files), then train mode (CLIP ViT-H) under
     PCDMS_SHORTKV=pallas, where the short-kv kernel runs at head_dim 64
     and 80;
 10. the reference protocol chained through the disk (``phase_protocol``)
     on 2 synthetic pairs: ``cli/stage1_batchtest.main`` (CLIP ViT-H and
     the prior) writes the .npy embeddings, ``cli/stage2_batchtest.main
     --prior_embeds_dir`` reads them, ``cli/stage3_batchtest.main
     --gen_dir`` refines stage 2's PNGs (UniPC 20, best of 4) with host and
     with device selection; seconds per pair and peak GiB per CLI;
 11. weight loading (``phase_weights``): phase 9's ``--random_init`` models
     saved as f32 files in the reference's layouts (a DeepSpeed-wrapped
     monolithic checkpoint, an SD-2.1 dir with the VAE's old attention
     names, an HF DINOv2 dir; 8.4 GB), then ``cli/stage2_batchtest.main``
     from the files: PNGs byte-identical to the ``--random_init`` run's;
 12. serving (``phase_serve``): ``Stage2Service`` at 512x1024 behind
     ``ServingServer`` (8 concurrent HTTP requests, the same bits for the
     same request in the same bucket, bucket 4 against bucket 1, 45 frozen
     launches per batch), ``CascadeService`` (the same seed twice, its stage
     2 against ``Stage2Service``) and the serve CLI's deployment
     (``cli/serve.py::build_deployment``): a ``ShapeRouter`` over two
     canvases sharing one set of bf16 modules, both engines launching at
     once. Its images/s is a smoke reading of 8 requests at 3 steps, not a
     serving rate;
 13. data-parallel training (``phase_data_parallel``): two gloo ranks share
     the card (NCCL takes one rank per device) and take 2 full-width
     stage-2 steps with ZeRO-1 and remat at one row each, against a world
     of 1 on the 2-row global batch with the same draws (the loss and the
     gradient norm per step within 1e-2, step 0's reduced gradient within
     rel L2 5e-3, each rank's optimizer state about half), then one step of
     a world of 1 on NCCL; a smoke reading of time, not a multi-card speed;
 14. LCM distillation (``phase_lcm``): ``cli/lcm_distill.main`` at full
     width (batch 2, bf16, remat, 4 steps, the profile of step 4), the
     student's eps against the teacher's before the first update, 30
     frozen, 30 LSE, 15 dq and 15 dk/dv launches a step, then 4 LCM steps
     of ``stage2_generate`` from the student;
 15. data-parallel serving (``phase_serve_dp``): ``Stage2Service`` over
     ``mesh=[cuda:0]`` and over ``mesh=[cuda:0, cuda:0]`` (two replicas at
     bucket 2) against ``mesh=None``, bit for bit; then the images/s of a
     burst on one replica against two, a shared-card reading;
 16. the metrics protocol (``phase_metrics``, before phase 10, which then
     scores its stage-3 PNGs with the same weight files): seeded
     full-width FID InceptionV3 and LPIPS-Alex saved in their published
     layouts, the card's pool3 features and LPIPS values against the CPU's
     (8 images, f32, TF32 off), images/s of both networks by CUDA events,
     and ``cli/calculate_metrics.main`` at --resolution 256 and 512 on 32
     synthetic generated / GT pairs and 32 FID reference images, with the
     host seconds of sqrtm and of the reconstruction metrics per pair;
 16b. the DWPose extraction path (``phase_dwpose``, after phase 16):
     seeded random YOLOX-l and RTMPose-l saved as mm checkpoints and loaded
     by ``DWposeTorch.from_torch``, run with both TF32 switches on around
     the port's own f32 scope; both networks card vs CPU through
     ``DWposeTorch._forward`` (rel L2 <= 1e-4: YOLOX-l's raw outputs at a
     640 letterbox, RTMPose-l's SimCC logits at 384x288); ``detect_persons``
     on 16 synthetic 512x512 person images (network images/s by CUDA events
     at batch 1 and 16, the call by the host clock, the host's share, the
     boxes); ``__call__`` with the detection pinned to 1 and 4 boxes an
     image (persons/s, the host's share), the whole call card vs CPU on one
     image, bit for bit where every SimCC top-two margin on the CPU exceeds
     1e-3; ``cli/extract_pose.main`` on 8 images (an 18-line ``.txt`` and
     a 512x512 ``_pose.jpg`` each, s an image). No kernel of the repository
     lies on this path;
 16c. the single-image demo (``phase_demo``, after phase 11):
     ``cli/demo.main`` at full width with ``--random_init`` (the stage-2
     UNet without class embedding, DINOv2-giant, the VAE; DDIM 50, CFG
     2.0: 750 frozen launches), then from files (the same seeded UNet and
     projections as a monolithic checkpoint, with phase 11's SD-2.1 and
     DINOv2 dirs: the PNG byte-identical to ``--random_init`` with phase
     11's VAE and DINOv2), then the code cells of
     ``examples/demo_torch.ipynb`` read with ``json``; s per denoise step,
     peak GiB. The fast-path drift table (``phase_fastpath_drift``):
     ``cli/fastpath_drift.py``'s random-weights mode at 512x1024 and batch
     2, each variant's PSNR, cosine and frozen launches. The annotators
     (``phase_annotators``): seeded OpenPose body / hand / face, HED,
     PiDiNet and LineArt saved as controlnet-aux files, each network card
     vs CPU (rel L2 <= 1e-4) and its images/s at a 512 input, then every
     ``Processor`` id of the slice on 4 synthetic 512x512 images on the
     card and the first on the CPU, the OpenPose ids on a crafted
     two-person body output (``pose/detectors/openpose_scene.py``), so that
     the hand and face networks run on real crops. The depth, normal and
     line annotators (``phase_annotators_depth``): seeded LineArt-Anime,
     M-LSD, MiDaS, NormalBAE, ZoeDepth, LeReS and the LeReS++ merge
     network saved in their published layouts and loaded back, each card
     vs CPU and its images/s at 512, every ``Processor`` id of the slice as
     above (the CPU half taking its networks' outputs from the card's calls
     where its inputs match) with each discrete step's input held card vs
     CPU, and the LeReS++ patch loop on a crafted image on the card and on
     the CPU. Phase 12 also sends one ``cli/serve_client.main`` request at
     full width;
 16d. SAM (``phase_sam``, after the depth annotators): seeded vit_h (641M
     parameters) and MobileSAM saved in their published layouts and loaded
     back through ``Processor("sam")``; a windowed and a global vit_h
     block, the neck, TinyViT at 1024 and a 64-point decoder batch card vs
     CPU; the encoders' images/s and the decoder's prompts/s; the default
     automatic mask generator (32 x 32 points) on 2 synthetic 512x512
     images with the masks left after each filter and the host's share;
     then a run with the thresholds lowered and one crop layer on the card
     and on the CPU (the CPU half taking the networks' outputs from the
     card's calls), its kept masks and canvas equal;
 17. the learning proof (``phase_learning_proof``):
     ``cli/learning_proof.main(["--quick", "--assert_improves"])`` on the
     card, the VAE and the three trainers from scratch at the tiny
     configurations; it fails unless every stage beats its 1-step init by
     the JAX package's thresholds.
Launch counters are reset just before each path runs and read just after.
The phases run in this order: 1 to 7c, 9, 16, 16b, 11, 16c (the demo and
the annotators; the drift table below), 16d, 14; then the learning proof
starts in a child process on the same card (host-bound at its tiny
configurations, it leaves the card idle most of its time) and runs beside
the phases that read only the host's clock: 7d, 8, 10, the drift table,
12, 13 and 15. The run waits for it, and fails with it, before the result
lines.

The last three lines are the card's name and power limit (nvidia-smi), a
JSON object with one record per kernel (every TPU kernel of the
repository: the seven that reach ``pl.pallas_call``), and
``{"ok": true, "device": ...}``. Any failed check exits non-zero before the
result lines. The script needs CUDA and the repository beside it; it
imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
SEED = 0
# (B*H, Lq, Lk) of the UNet self-attention at a 512x1024 canvas, one pair
# CFG-doubled: 64x128, 32x64 and 16x32 latent tokens with 5 / 10 / 20 heads
PATH_SHAPES = [(10, 8192, 8192), (20, 2048, 2048), (40, 512, 512)]
# the short-kv kernel's calls: the 258-token cross-attention at the same
# levels and in the mid block (8x16 latents), the mid block's 128-token
# self-attention, and level 0 at the batch test's UNet batch 16
SHORTKV_SHAPES = [(10, 8192, 258), (20, 2048, 258), (40, 512, 258),
                  (40, 128, 258), (40, 128, 128), (80, 8192, 258)]
# CLIP ViT-H's 257-token self-attention, 16 heads of 80, over 2 images (the
# batch test's train mode), 4 (the JAX batch test's default --batch_size 4)
# and 8 (the stage-2 trainer's --train_batch_size 8)
SHORTKV_D80_SHAPES = [(32, 257, 257), (64, 257, 257), (128, 257, 257)]
# ragged head_dim-80 shapes: both sides of the 128-row pairs, every tail
# width (16, 64, 128 keys) behind 0 to 3 full tiles, one row, one key
SHORTKV_D80_EDGES = [(3, 1, 1), (3, 127, 129), (3, 129, 257), (3, 300, 100),
                     (3, 129, 200), (3, 70, 384), (3, 129, 460),
                     (3, 200, 512)]
# kernel vs plain version. f32 outputs: max abs error <= 2e-5. bf16 outputs
# (and the bf16-softmax variant): max abs error <= 1e-2 * max|plain|. The
# two round the same f32 sum to bf16 after a different accumulation order,
# so they may differ by one bf16 ulp, at most 2^-7 = 7.8e-3 of the value;
# 1e-2 admits that at any magnitude. An absolute bar would not scale with
# the output: at L = 8192 its RMS is about sqrt(e / L) = 0.018, and a kernel
# that dropped one 64-key tile there would be off by about 0.01.
BAR_REL, BAR_F32 = 1e-2, 2e-5
# relative L2 of the full-width UNet eps, kernels vs plain attention. Both
# run the same bf16 network; they differ only in where the attention
# weights are rounded to bf16 (the frozen kernel rounds exp2(s - m0) with
# m0 = rowmax + 24, the plain path rounds softmax(s)), about 2^-9 relative
# per weight, carried through 15 attention layers and bf16 activations:
# expected around 1e-2, so 5e-2 leaves headroom and still catches a kernel
# that is wrong on any one layer.
BAR_UNET_REL_L2 = 5e-2

# backward kernels vs plain versions, each bar scaled to its output: bf16
# dq / dk / dv max abs error <= 1e-2 x max|plain| (one bf16 ulp, as above)
# and relative L2 <= 5e-3 (measured about 5e-4; a kernel that drops one of
# the 128 k or q tiles at level 0 is off by about sqrt(1/128) = 9e-2);
# f32 max abs error <= 2e-5 x max|plain|; the LSE (f32 in both cases) max
# abs error <= 1e-4 x max|plain|.
BAR_BWD_REL_L2, BAR_F32_REL, BAR_LSE_REL = 5e-3, 2e-5, 1e-4
# the full-width UNet gradient, kernels vs plain attention (relative L2)
BAR_GRAD_REL_L2 = 5e-2
# (B*H, Lq, Lk) of the training self-attention, batch 2 at 512x1024
TRAIN_SHAPES = PATH_SHAPES + [(10, 640, 600)]
# lengths on both sides of the bf16 kernels' 128-row blocks and 64- /
# 128-row ring stages, one row, a long ragged kv, and fewer keys than the
# 128 the frozen max is taken of
EDGE_SHAPES = [(3, 129, 127), (3, 1, 64), (3, 70, 130), (3, 192, 8200),
               (3, 200, 100)]
# the reference protocol's batch 8, CFG-doubled, at level 0 (kernel time only)
BATCH8_SHAPE = (80, 8192, 8192)

CSRC = "pcdms_tpu_torch/ops/csrc/"
KERNELS = {   # name -> (source, TPU kernel it replaces)
    "flash_frozen": (CSRC + "flash_attention.cu",
                     "pcdms_tpu/ops/flash_attention.py:154"),
    "flash_online": (CSRC + "flash_attention.cu",
                     "pcdms_tpu/ops/flash_attention.py:71"),
    "flash_shortkv": (CSRC + "flash_attention.cu",
                      "pcdms_tpu/ops/flash_attention.py:316"),
    "flash_fwd_lse": (CSRC + "flash_attention.cu",
                      "pcdms_tpu/ops/flash_attention_bwd.py:53"),
    "flash_dq": (CSRC + "flash_attention_bwd.cu",
                 "pcdms_tpu/ops/flash_attention_bwd.py:154"),
    "flash_dkv": (CSRC + "flash_attention_bwd.cu",
                  "pcdms_tpu/ops/flash_attention_bwd.py:190"),
    "fused_gn_silu_conv": (CSRC + "fused_conv.cu",
                           "pcdms_tpu/ops/fused_conv.py:67"),
}

# the 44 resnet convs of one full-width stage-2 UNet forward (64x128
# latents, batch 2): (H, W, Cin, Cout, count). conv1 adds the time
# embedding (mode "temb"), conv2 the shortcut (mode "residual"); the shapes
# with Cin == Cout are checked in the residual mode, the others are conv1s.
CONV_SHAPES = [
    (64, 128, 320, 320, 7), (64, 128, 640, 320, 2), (64, 128, 960, 320, 1),
    (32, 64, 320, 640, 1), (32, 64, 640, 640, 6), (32, 64, 960, 640, 1),
    (32, 64, 1280, 640, 1), (32, 64, 1920, 640, 1),
    (16, 32, 640, 1280, 1), (16, 32, 1280, 1280, 6), (16, 32, 1920, 1280, 1),
    (16, 32, 2560, 1280, 2),
    (8, 16, 1280, 1280, 11), (8, 16, 2560, 1280, 3)]
# the stage-3 UNet at 512x512 (64x64 latents): the frozen kernel's
# self-attentions, 4096 tokens with 5 heads and 1024 with 10, at CFG batch 2
# and at the batch test's UNet batch 8 (one pair, best of 4, CFG-doubled)
STAGE3_PATH_SHAPES = [(10, 4096, 4096), (20, 1024, 1024), (40, 4096, 4096),
                      (80, 1024, 1024)]
# its short-kv calls at CFG batch 2: the 257-token cross-attention on the
# conditional half at the four levels, the 16x16 level's and the 8x8 mid
# block's self-attention
STAGE3_SHORTKV_SHAPES = [(5, 4096, 257), (10, 1024, 257), (20, 256, 257),
                         (20, 64, 257), (40, 256, 256), (40, 64, 64)]
# its 44 resnet convs: the stage-2 UNet's at square levels
STAGE3_CONV_SHAPES = [(h, h, cin, cout, count)
                      for h, _, cin, cout, count in CONV_SHAPES]
# the prior cut to 2 layers at full width, f32 with TF32 off, card vs CPU
# (relative L2): the two differ only in the order of f32 sums
BAR_PRIOR_REL_L2 = 1e-4
# fused conv vs its plain version: bf16 max abs error <= 1e-2 x max|plain|
# (one bf16 ulp after another summation order) and relative L2 <= 5e-3
# (dropping one of the 9 taps moves it by about 1/3); f32 max abs error
# <= 2e-5 x max|plain|
BAR_CONV_REL_L2 = 5e-3
# the full-width UNet eps, fused_conv=True vs False (same weights, same
# attention kernels): they differ only where the activation is rounded to
# bf16, 44 times
BAR_FUSED_UNET_REL_L2 = 5e-2
# the sampler options (phase_sampler_options): launches of kernels 1, 3 and 7
# in one stage-2 UNet forward at 64x128 latents, and in its up blocks alone,
# all that a decode-only step of encoder propagation runs
FORWARD_LAUNCHES = {"flash_frozen": 15, "flash_shortkv": 17,
                    "fused_gn_silu_conv": 44}
DECODE_LAUNCHES = {"flash_frozen": 9, "flash_shortkv": 9,
                   "fused_gn_silu_conv": 24}
# kernel 1 in the stage-3 UNet at 64x64 latents: a forward, its up blocks
STAGE3_FORWARD_FROZEN, STAGE3_DECODE_FROZEN = 10, 6
# neutral FreeU (1, 1, 1, 1) against none, the UNet in f32: only the skips'
# f32 FFT round trip, which moves a value by about 1e-7 of the largest. In
# bf16 the same round trip moves a few of the smallest values by an ulp, and
# GroupNorm's statistics spread that to every value's rounding: eps then
# sits at the bf16 floor of BAR_UNET_REL_L2, as kernels vs plain attention
BAR_FREEU_NEUTRAL_REL_L2 = 5e-3
SD21_FREEU = (0.9, 0.2, 1.4, 1.6)   # SD-2.1's published (s1, s2, b1, b2)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph and replayed between two events (the median of ``replays``),
    so that the host's enqueue of each call is not in it. ``fn`` must have
    run once outside the graph (the nvcc build, the shared-memory opt-in,
    the tensor maps)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return sorted(times)[replays // 2]


def bound(flops: float, nbytes: float):
    """Least time on an H100 SXM: bytes over the HBM rate vs bf16 flops over
    the tensor-core peak. Returns (ms, 'bytes' | 'operations')."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def bound_ms(bh: int, lq: int, lk: int, d: int = 64, itemsize: int = 2):
    """The attention forward: q, k, v read once, o written once; 4.Lq.Lk.d
    flops per (batch, head)."""
    return bound(4 * bh * lq * lk * d,
                 (2 * bh * lq * d + 2 * bh * lk * d) * itemsize)


def _kernel_name(mangled: str) -> str:
    try:
        out = subprocess.run(["c++filt", mangled], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return mangled
    name = out.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ").strip() or mangled


# kernels whose build fails on a spill or a ptxas C75xx warning (wgmma
# serialised)
STRICT_KERNELS = ("flash_shortkv_hopper", "fused_conv_hopper")


def phase_build():
    """Build the kernels; print, per kernel, the registers and spills that
    ptxas reports and every ptxas warning. Fails if a short-kv or bf16
    fused-conv kernel spills or ptxas serialises its wgmma (C75xx)."""
    from pcdms_tpu_torch.ops import _build
    bad = []
    for stem, seconds in _build.build().items():
        print(f"[build] {stem}.cu: {seconds:.1f} s (nvcc, sm_90a)")
        entry = None
        for line in _build.build_log(stem).splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                entry = _kernel_name(found.group(1))
            elif "spill" in line or "Used" in line:
                print(f"[build]   {entry}: {line.strip()}")
                spills = re.search(r"(\d+) bytes spill stores", line)
                if (entry and any(k in entry for k in STRICT_KERNELS)
                        and spills and spills.group(1) != "0"):
                    bad.append(f"{entry} spills: {line.strip()}")
            elif "warning" in line or "(C75" in line:
                print(f"[build]   {line.strip()}")
                if "C75" in line and any(k in line for k in STRICT_KERNELS):
                    bad.append(line.strip())
    if bad:
        fail("short-kv / fused-conv kernel build: " + "; ".join(bad))


def phase_shortkv(fa, shapes):
    """The bf16 short-kv kernel vs its plain version at ``shapes`` ((B*H,
    Lq, Lk, head_dim)), each timed by device time (``graph_ms``) and by ten
    back-to-back calls (``cuda_ms``, which at these sizes reads the host's
    enqueue), beside SDPA's forward timed both ways, the plain version and
    the bound. Takes any tree's ``flash_attention`` module, so that the old
    and the new kernel are timed by one script in turns. Returns one record
    a shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    records = []
    for bh, lq, lk, d in shapes:
        q, k, v = (torch.randn((bh, n, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for n in (lq, lk, lk))
        scale = 1.0 / math.sqrt(d)
        got = fa.shortkv_attention(q, k, v, scale)
        want = fa.shortkv_plain(q, k, v, scale)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        amax = want.float().abs().max().item()
        finite = bool(torch.isfinite(got).all())
        del got, want

        def kernel():
            return fa.shortkv_attention(q, k, v, scale)

        def library():
            return sdpa(q[None], k[None], v[None], scale=scale)

        ms, lib_ms = graph_ms(kernel), graph_ms(library)
        ms_stream, lib_stream = cuda_ms(kernel, 10), cuda_ms(library, 10)
        plain_ms = cuda_ms(lambda: fa.shortkv_plain(q, k, v, scale), 3, 1)
        b_ms, b_by = bound_ms(bh, lq, lk, d)
        line = (f"[shortkv] bf16 bh={bh} lq={lq} lk={lk} d={d}: max_abs_err="
                f"{err:.3e} (bar {BAR_REL:g} x max|want| {amax:.3e}); "
                f"device ms (CUDA graph): kernel {ms:.4f} library {lib_ms:.4f}"
                f"; host-bound ms (10 calls): kernel {ms_stream:.4f} library "
                f"{lib_stream:.4f}; plain_ms={plain_ms:.4f} bound_ms="
                f"{b_ms:.4f} ({b_by}) = {b_ms / ms:.1%} of the kernel's")
        print(line, flush=True)
        if not finite or not err <= BAR_REL * amax:
            fail(f"flash_shortkv disagrees with its plain version: {line}")
        records.append(dict(shape=[bh, lq, lk], head_dim=d, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms,
                            ms_host_bound=ms_stream,
                            library_ms_host_bound=lib_stream))
        del q, k, v
        torch.cuda.empty_cache()
    return records


def phase_kernels(fa, fb):
    """Each kernel vs its plain version; returns per-kernel records at the
    level-0 shape for the JSON line, the frozen and online kernels' with the
    other two levels under ``other_levels``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    records = {}

    def inputs(bh, lq, lk, dtype, d):
        return [torch.randn((bh, n, d), generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
                for n in (lq, lk, lk)]

    def check(name, kernel, plain, bh, lq, lk, dtype, timed,
              bf16_softmax=False, d=64):
        q, k, v = inputs(bh, lq, lk, dtype, d)
        scale = 1.0 / math.sqrt(d)
        got = kernel(q, k, v, scale)
        want = plain(q, k, v, scale)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        amax = want.float().abs().max().item()
        rms = want.float().square().mean().sqrt().item()
        finite = bool(torch.isfinite(got).all())
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        if dtype == torch.bfloat16 or bf16_softmax:
            bar = BAR_REL * amax
            bar_text = f"{BAR_REL:g} x max|want| {amax:.3e}"
        else:
            bar, bar_text = BAR_F32, "f32"
        line = (f"[kernel] {name} {tag} bh={bh} lq={lq} lk={lk} d={d}: "
                f"max_abs_err={err:.3e} (bar {bar:.3e} = {bar_text}; "
                f"rms|want| {rms:.3e})")
        rec = None
        if timed:
            ms = cuda_ms(lambda: kernel(q, k, v, scale), 10)
            plain_ms = cuda_ms(lambda: plain(q, k, v, scale), 3, 1)
            q4, k4, v4 = q[None], k[None], v[None]
            lib_ms = cuda_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(q4, k4, v4), 10)
            b_ms, b_by = bound_ms(bh, lq, lk, d)
            line += (f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                     f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} "
                     f"({b_by})")
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        print(line, flush=True)
        if not finite or not err <= bar:
            fail(f"{name} disagrees with its plain version: {line}")
        return rec

    bf16, f32 = torch.bfloat16, torch.float32
    variants = [
        ("flash_frozen", fa.flash_frozen, fa.flash_frozen_plain,
         PATH_SHAPES + [(10, 640, 600)] + EDGE_SHAPES),
        ("flash_online", fa.flash_online, fa.flash_online_plain,
         PATH_SHAPES + [(10, 640, 600)] + EDGE_SHAPES),
        ("flash_shortkv", fa.shortkv_attention, fa.shortkv_plain,
         [(10, 300, 100), (3, 129, 512), (3, 1, 1)]),
    ]
    for name, kernel, plain, shapes in variants:
        for i, shape in enumerate(shapes):
            rec = check(name, kernel, plain, *shape, bf16,
                        timed=shape in PATH_SHAPES)
            if i == 0:
                records[name] = rec
            elif rec:
                records[name].setdefault("other_levels", []).append(
                    dict(rec, shape=list(shape)))
        bh, lq, lk = (2, 640, 258) if name == "flash_shortkv" else (2, 640,
                                                                     600)
        check(name, kernel, plain, bh, lq, lk, f32, False)
    # the short-kv kernel at its six shapes by device time, and at CLIP
    # ViT-H's head_dim 80 (the short-kv kernel alone takes it)
    shortkv = phase_shortkv(fa, [(*shape, 64) for shape in SHORTKV_SHAPES])
    d80 = phase_shortkv(fa, [(*shape, 80) for shape in SHORTKV_D80_SHAPES])
    records["flash_shortkv"] = dict(shortkv[0], other_levels=shortkv[1:],
                                    head_dim_80=d80)
    for shape in SHORTKV_D80_EDGES:
        check("flash_shortkv", fa.shortkv_attention, fa.shortkv_plain,
              *shape, bf16, False, d=80)
    check("flash_shortkv", fa.shortkv_attention, fa.shortkv_plain, 4, 257,
          257, f32, False, d=80)
    ob = (lambda q, k, v, s: fa.flash_online(q, k, v, s, True),
          lambda q, k, v, s: fa.flash_online_plain(q, k, v, s, True))
    for shape in [(10, 2048, 2048), (10, 640, 600)] + EDGE_SHAPES:
        check("flash_online[exp_bf16]", *ob, *shape, bf16, False, True)
    check("flash_online[exp_bf16]", *ob, 2, 640, 600, f32, False, True)

    # the reference protocol's batch at level 0: kernel times only
    q, k, v = inputs(*BATCH8_SHAPE, bf16, 64)
    ms = {"flash_frozen": cuda_ms(lambda: fa.flash_frozen(q, k, v, 0.125), 5),
          "flash_fwd_lse": cuda_ms(lambda: fb.flash_fwd_lse(q, k, v, 0.125),
                                   5),
          "library (SDPA forward)": cuda_ms(
              lambda: torch.nn.functional.scaled_dot_product_attention(
                  q[None], k[None], v[None]), 5)}
    bh, lq, lk = BATCH8_SHAPE
    print(f"[kernel] batch 8 (bh={bh} lq={lq} lk={lk}, bf16), kernel_ms: "
          + " ".join(f"{n}={t:.4f}" for n, t in ms.items())
          + f" bound_ms={bound_ms(bh, lq, lk)[0]:.4f}", flush=True)
    del q, k, v
    torch.cuda.empty_cache()
    return records


def phase_clip(fa, dev):
    """CLIP ViT-H at full width (32 layers, 16 heads of 80; batch 2 at 224
    px, random weights from the seed, bf16) as the batch test's train mode
    runs it (``train/encoders.clip_image_embed``): under
    PCDMS_SHORTKV=pallas every self-attention takes the short-kv kernel at
    head_dim 80 (32 launches); by default plain attention. The image
    embeddings must agree within BAR_UNET_REL_L2 (both run the same bf16
    network and differ only where the attention weights are rounded)."""
    from pcdms_tpu_torch.models.vit import (
        VisionTransformer, clip_vit_h14_config,
    )
    from pcdms_tpu_torch.train.encoders import clip_image_embed

    with torch.device(dev):
        torch.manual_seed(SEED)
        model = VisionTransformer(clip_vit_h14_config())
    model = model.to(torch.bfloat16).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    pixels = torch.randn((2, 224, 224, 3), generator=gen, device=dev)

    def embed():
        return clip_image_embed(model, pixels)

    os.environ["PCDMS_SHORTKV"] = "pallas"
    try:
        fa.reset_launches()
        got = embed()
        torch.cuda.synchronize()
        launches = {n: c for n, c in fa.LAUNCHES.items() if c}
        by_dim = dict(fa.SHORTKV_LAUNCHES)
        kernel_ms = cuda_ms(embed, 3, 1)
    finally:
        os.environ.pop("PCDMS_SHORTKV")
    want = embed()
    plain_ms = cuda_ms(embed, 3, 1)
    rel = _rel_l2(got, want)
    print(f"[clip] CLIP ViT-H forward, batch 2 at 224 px, bf16: image "
          f"embedding {tuple(got.shape)} rel_l2 short-kv kernel vs plain "
          f"attention = {rel:.3e} (bar {BAR_UNET_REL_L2:g}); launches "
          f"{launches}, by head_dim {by_dim}; forward ms (CUDA events over "
          f"3 calls): kernel {kernel_ms:.2f} plain {plain_ms:.2f}",
          flush=True)
    if got.shape != (2, 1024) or not torch.isfinite(got).all() or (
            not rel <= BAR_UNET_REL_L2):
        fail("CLIP ViT-H image embedding through the short-kv kernel "
             "disagrees with plain attention")
    if launches != {"flash_shortkv": 32} or by_dim != {64: 0, 80: 32}:
        fail(f"expected 32 short-kv launches at head_dim 80 per CLIP ViT-H "
             f"forward, got {launches} {by_dim}")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def phase_fused_conv(fc, conv_shapes=CONV_SHAPES, label="unet",
                     edges=True):
    """The fused conv kernel vs its plain version at the 14 conv shapes of
    the full-width UNet (``conv_shapes``: the stage-2 UNet's by default;
    ``label`` names the UNet; ``edges=False`` leaves out what follows the
    UNet shapes) (bf16, in the mode the UNet uses there), mode 0 and
    apply_act=False at level 0, one f32 case, and shapes that are ragged,
    split-K, smaller than the kernel's 8 x 16 tile, cut by the image border
    or with Cin not a multiple of 64. Each UNet shape is timed by device
    time (``graph_ms``): the kernel on prepared operands, the port's unfused
    route (GroupNorm -> SiLU -> cuDNN conv -> add) and cuDNN's conv alone,
    beside the wrapper (GroupNorm statistics, the weight re-lay where it is
    not kept, the launch) by ten back-to-back calls (``cuda_ms``, which read
    the host's enqueue) and the plain version; then their sums over the 44
    convs of a forward. Takes any tree's ``fused_conv`` module, so that the
    old and the new kernel are timed by one script in turns. Returns the
    level-0 record for the JSON line, with every shape under
    ``unet_shapes`` and the sums under ``sums_44``."""
    from pcdms_tpu_torch.nn.layers import GroupNorm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    bf16, f32 = torch.bfloat16, torch.float32
    batch, record, totals, shapes = 2, None, {}, []

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def case(h, w, cin, cout, mode, dtype, b=batch):
        x = (rand(b, cin, h, w) * 2 + 0.3).to(dtype)
        scale, shift = 1 + 0.1 * rand(cin), 0.1 * rand(cin)
        groups = 32 if cin % 32 == 0 else 8
        a, c = fc.gn_affine_coeffs(x, scale, shift, groups, 1e-5)
        weight = (rand(cout, cin, 3, 3) / math.sqrt(9 * cin)).to(dtype)
        bias = (0.1 * rand(cout)).to(dtype)
        temb = rand(b, cout).to(dtype) if mode == "temb" else None
        res = rand(b, cout, h, w).to(dtype) if mode == "residual" else None
        return x, (scale, shift, groups), a, c, weight, bias, temb, res

    def check(label, h, w, cin, cout, mode, dtype, act=True, b=batch):
        x, gn, a, c, weight, bias, temb, res = case(h, w, cin, cout, mode,
                                                    dtype, b)
        got = fc.fused_gn_silu_conv(x, a, c, weight, bias, temb, res, act)
        want = fc.fused_gn_silu_conv_plain(x, a, c, weight, bias, temb, res,
                                           act)
        torch.cuda.synchronize()
        mr, l2 = _max_rel(got, want), _rel_l2(got, want)
        err = (got.float() - want.float()).abs().max().item()
        bf = dtype == bf16
        ok = bool(torch.isfinite(got).all()) and (
            mr <= BAR_REL and l2 <= BAR_CONV_REL_L2 if bf
            else mr <= BAR_F32_REL)
        line = (f"[conv] {label} {'bf16' if bf else 'f32'} B={b} {h}x{w} "
                f"{cin}->{cout} mode={mode} act={act}: max_abs_err={err:.3e} "
                f"err/max|want|={mr:.2e} (bar "
                f"{BAR_REL if bf else BAR_F32_REL:g}) rel_l2={l2:.2e}"
                + (f" (bar {BAR_CONV_REL_L2:g})" if bf else ""))
        print(line, flush=True)
        if not ok:
            fail(f"the fused conv disagrees with its plain version: {line}")
        return x, gn, a, c, weight, bias, temb, res, err

    def timed(x, gn, a, c, weight, bias, temb, res):
        """Device times (graph replay) of the kernel on prepared operands,
        the GroupNorm statistics, the weight re-lay, the unfused route and
        cuDNN's conv alone; the wrapper and the plain version by the host's
        clock; the bound."""
        (b, cin, h, w), cout = x.shape, weight.shape[0]
        scale, shift, groups = gn
        extra = temb if temb is not None else res
        mode_id = 1 if temb is not None else 2
        wk = fc.relayout_weight(weight, bf16)
        a32, c32, b32 = a.contiguous(), c.contiguous(), bias.float()
        t = dict(ms=graph_ms(lambda: fc.launch_fused_conv(
            x, a32, c32, wk, b32, extra, mode_id, True)))
        t["wrapper_ms"] = cuda_ms(lambda: fc.gn_silu_conv3x3(
            x, scale, shift, weight, bias, num_groups=groups, temb=temb,
            residual=res), 10)
        t["relayout_ms"] = graph_ms(lambda: fc.relayout_weight(weight, bf16))
        t["stats_ms"] = graph_ms(lambda: fc.gn_affine_coeffs(
            x, scale, shift, groups, 1e-5))
        t["plain_ms"] = cuda_ms(lambda: fc.fused_gn_silu_conv_plain(
            x, a, c, weight, bias, temb, res), 3, 1)
        norm = GroupNorm(groups, cin).to(dev)
        with torch.no_grad():
            norm.weight.copy_(scale)
            norm.bias.copy_(shift)

        def unfused():
            y = torch.nn.functional.conv2d(
                torch.nn.functional.silu(norm(x)), weight, bias, padding=1)
            return y + (temb[:, :, None, None] if temb is not None else res)

        with torch.no_grad():
            xa = torch.nn.functional.silu(norm(x))
            t["unfused_ms"] = graph_ms(unfused)
            t["library_ms"] = graph_ms(lambda: torch.nn.functional.conv2d(
                xa, weight, bias, padding=1))
        flops = 2 * b * h * w * cin * cout * 9
        nbytes = 2 * (b * h * w * (cin + cout) + 9 * cin * cout) + (
            2 * b * h * w * cout if res is not None else 2 * b * cout)
        t["bound_ms"], t["bound_by"] = bound(flops, nbytes)
        plan = getattr(fc, "conv_plan", None)
        t["split"] = plan(b, cin, cout, h, w)["split"] if plan else None
        print(f"[conv]   B={b} {h}x{w} {cin}->{cout}: device ms (CUDA graph): "
              f"kernel {t['ms']:.4f} unfused_route {t['unfused_ms']:.4f} "
              f"library {t['library_ms']:.4f} (cuDNN conv alone) "
              f"weight_relay {t['relayout_ms']:.4f} gn_stats "
              f"{t['stats_ms']:.4f}; host-bound ms (10 calls): wrapper "
              f"{t['wrapper_ms']:.4f}; plain_ms={t['plain_ms']:.4f} "
              f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) = "
              f"{t['bound_ms'] / t['ms']:.1%} of the kernel's; "
              f"split={t['split']}", flush=True)
        return t

    for h, w, cin, cout, count in conv_shapes:
        mode = "residual" if cin == cout else "temb"
        *operands, err = check(label, h, w, cin, cout, mode, bf16)
        t = timed(*operands)
        del operands
        for key in ("ms", "wrapper_ms", "unfused_ms", "library_ms",
                    "stats_ms", "bound_ms"):
            totals[key] = totals.get(key, 0.0) + count * t[key]
        shapes.append(dict(t, shape=[batch, cin, cout, h, w], count=count,
                           max_abs_err=err))
        if record is None:
            record = dict(max_abs_err=err, **{k: t[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "unfused_ms", "wrapper_ms")})
    print(f"[conv] the {sum(c[-1] for c in conv_shapes)} convs of one "
          f"{label} forward, summed (ms; kernel, unfused route, cuDNN, "
          "GroupNorm statistics by device time, wrapper host-bound): "
          + " ".join(f"{k}={v:.4f}" for k, v in totals.items())
          + f"; bound / kernel = {totals['bound_ms'] / totals['ms']:.1%}",
          flush=True)
    if not edges:
        torch.cuda.empty_cache()
        return dict(record, unet_shapes=shapes, sums_44=totals)
    # level 0 at the batch test's UNet batch 16, where the device is the
    # limit
    *operands, _ = check("batch16", 64, 128, 320, 320, "residual", bf16, b=16)
    batch16 = timed(*operands)
    del operands
    check("level0", 64, 128, 320, 320, "none", bf16)
    check("level0", 64, 128, 320, 320, "none", bf16, act=False)
    check("level0", 64, 128, 320, 320, "temb", bf16, act=False)
    check("spot", 16, 32, 640, 1280, "temb", f32)
    check("ragged", 7, 9, 40, 24, "residual", bf16, b=3)
    check("ragged", 7, 9, 40, 24, "temb", f32, b=3)
    # Cin 200 in four chunks split over four blocks, W = 20 (stores one
    # pixel at a time); smaller than a tile; W = 40 cuts the third column of
    # tiles at the border
    check("split", 5, 20, 200, 320, "residual", bf16, b=3)
    check("small", 3, 5, 64, 160, "temb", bf16, b=1)
    check("border", 20, 40, 200, 200, "temb", bf16, b=1)
    torch.cuda.empty_cache()
    return dict(record, unet_shapes=shapes, sums_44=totals,
                level0_batch16=batch16)


def conv_kernel_ms(fc, shapes=CONV_SHAPES):
    """Device time (``graph_ms``) of ``fc``'s bf16 kernel at each (H, W,
    Cin, Cout, ...) of ``shapes``, batch 2, with the residual added, and its
    max abs error over max|plain|; no check. For diagnostic builds of the
    kernel (parts removed, wrong by design; each made in a copy of the tree
    and run from its root), so that what each part costs is read by the
    same clock as ``phase_fused_conv``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    out = []
    for h, w, cin, cout, *_ in shapes:
        x = (torch.randn((2, cin, h, w), generator=gen, device=dev) * 2
             ).to(torch.bfloat16)
        a = torch.randn((2, cin), generator=gen, device=dev).abs() + 0.5
        c = torch.randn((2, cin), generator=gen, device=dev) * 0.3
        weight = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
                  / math.sqrt(9 * cin)).to(torch.bfloat16)
        bias = torch.randn(cout, generator=gen, device=dev)
        res = torch.randn((2, cout, h, w), generator=gen, device=dev).to(
            torch.bfloat16)
        wk = fc.relayout_weight(weight, torch.bfloat16)
        got = fc.launch_fused_conv(x, a, c, wk, bias, res, 2, True)
        want = fc.fused_gn_silu_conv_plain(x, a, c, weight, bias, None, res)
        ms = graph_ms(lambda: fc.launch_fused_conv(x, a, c, wk, bias, res, 2,
                                                   True))
        out.append(dict(shape=[h, w, cin, cout], ms=ms,
                        err_rel=_max_rel(got, want)))
        print(f"[conv-diag] {h}x{w} {cin}->{cout}: kernel {ms:.4f} ms, "
              f"err/max|plain| {out[-1]['err_rel']:.2e}", flush=True)
    return out


def build_models(dev, with_class_embed=True):
    from pcdms_tpu_torch.models.projections import (
        ImageProjModel, PoseCondEmbedding,
    )
    from pcdms_tpu_torch.models.unet2d import (
        UNet2DConditionModel, stage2_unet_config,
    )
    from pcdms_tpu_torch.models.vae import AutoencoderKL
    torch.manual_seed(SEED)
    with torch.device(dev):
        models = {
            "unet": UNet2DConditionModel(stage2_unet_config(with_class_embed)),
            "vae": AutoencoderKL(),
            "image_proj": ImageProjModel(),
            "pose_proj": PoseCondEmbedding(),
        }
        # the zero-initialised pose conv_out would hide the pose path
        torch.nn.init.normal_(models["pose_proj"].conv_out.weight, std=0.02)
    return {k: m.to(torch.bfloat16).eval() for k, m in models.items()}


def phase_unet(fa, models, dev):
    unet = models["unet"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    sample, pose = rand(2, 64, 128, 9), rand(2, 64, 128, 320)
    ctx, labels = rand(2, 258, 1024), rand(2, 1024)
    ctx[:1] = 0
    labels[:1] = 0
    ts = torch.tensor([500, 500], device=dev)
    # the self-attentions of one forward by (B*H, Lq, Lk), read by a hook on
    # every transformer block's ``attn1`` (its input is (B, L, C), head
    # width 64)
    shapes = {}

    def count(module, args):
        b, length, _ = args[0].shape
        key = (b * module.heads, length, length)
        shapes[key] = shapes.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(count)
             for name, m in unet.named_modules() if name.endswith(".attn1")]
    with torch.inference_mode():
        fa.reset_launches()
        eps_k = unet(sample, ts, ctx, labels, pose, zero_ctx_prefix=1)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        for hook in hooks:
            hook.remove()
        unet.cfg = dataclasses.replace(unet.cfg, use_flash=False)
        try:
            eps_p = unet(sample, ts, ctx, labels, pose, zero_ctx_prefix=1)
        finally:
            unet.cfg = dataclasses.replace(unet.cfg, use_flash=True)
        fwd_ms = cuda_ms(lambda: unet(sample, ts, ctx, labels, pose,
                                      zero_ctx_prefix=1), 3, 1)
    rel = ((eps_k.float() - eps_p.float()).norm()
           / eps_p.float().norm()).item()
    print(f"[unet] stage2 UNet 512x1024 batch 2 bf16: eps rel_l2 kernels vs "
          f"plain = {rel:.3e} (bar {BAR_UNET_REL_L2:g}); launches {launches};"
          f" forward_ms={fwd_ms:.2f}; self-attentions by (B*H, Lq, Lk): "
          f"{shapes}", flush=True)
    if not torch.isfinite(eps_k).all() or not rel <= BAR_UNET_REL_L2:
        fail("full-width UNet eps: kernels disagree with plain attention")
    if launches["flash_frozen"] != 15 or sum(launches.values()) != 15:
        fail(f"expected 15 frozen-kernel launches per UNet forward, got "
             f"{launches}")

    # the same weights with the short-kv kernel on the 16 cross-attentions
    # and the mid block's self-attention (PCDMS_SHORTKV=pallas)
    with torch.inference_mode():
        os.environ["PCDMS_SHORTKV"] = "pallas"
        try:
            fa.reset_launches()
            eps_s = unet(sample, ts, ctx, labels, pose, zero_ctx_prefix=1)
            torch.cuda.synchronize()
            s_launches = {n: c for n, c in fa.LAUNCHES.items() if c}
            by_dim = dict(fa.SHORTKV_LAUNCHES)
        finally:
            os.environ.pop("PCDMS_SHORTKV")
    rel = _rel_l2(eps_s, eps_p)
    print(f"[unet] PCDMS_SHORTKV=pallas: eps rel_l2 kernels vs plain = "
          f"{rel:.3e} (bar {BAR_UNET_REL_L2:g}); launches {s_launches}, "
          f"short-kv by head_dim {by_dim}", flush=True)
    if not torch.isfinite(eps_s).all() or not rel <= BAR_UNET_REL_L2:
        fail("full-width UNet eps under PCDMS_SHORTKV=pallas: kernels "
             "disagree with plain attention")
    if s_launches != {"flash_frozen": 15, "flash_shortkv": 17} or by_dim[
            64] != 17:
        fail(f"expected 15 frozen and 17 short-kv launches (head_dim 64) per "
             f"UNet forward under PCDMS_SHORTKV=pallas, got {s_launches}")

    # the same weights and attention kernels with every resnet conv fused
    with torch.inference_mode():
        unet.cfg = dataclasses.replace(unet.cfg, fused_conv=True)
        try:
            fa.reset_launches()
            eps_f = unet(sample, ts, ctx, labels, pose, zero_ctx_prefix=1)
            torch.cuda.synchronize()
            f_launches = {n: c for n, c in fa.LAUNCHES.items() if c}
            fused_ms = cuda_ms(lambda: unet(sample, ts, ctx, labels, pose,
                                            zero_ctx_prefix=1), 3, 1)
        finally:
            unet.cfg = dataclasses.replace(unet.cfg, fused_conv=False)
    rel = _rel_l2(eps_f, eps_k)
    print(f"[unet] fused_conv=True vs False (same weights, attention "
          f"kernels): eps rel_l2 = {rel:.3e} (bar {BAR_FUSED_UNET_REL_L2:g});"
          f" launches {f_launches}; forward_ms fused={fused_ms:.2f} "
          f"unfused={fwd_ms:.2f}", flush=True)
    if not torch.isfinite(eps_f).all() or not rel <= BAR_FUSED_UNET_REL_L2:
        fail("full-width UNet eps: the fused convs disagree with the unfused")
    if f_launches != {"flash_frozen": 15, "fused_gn_silu_conv": 44}:
        fail(f"expected 44 fused-conv and 15 frozen launches per fused UNet "
             f"forward, got {f_launches}")
    phase_unet_batch16(fa, models, dev)


def phase_unet_batch16(fa, models, dev):
    """The same weights at UNet batch 16 (the batch test's best-of-4,
    CFG-doubled, at 64x128 latents, where the device and not the host is
    the limit): the forward with ``fused_conv=True`` against the unfused
    one, eps within BAR_FUSED_UNET_REL_L2, 44 fused-conv launches, each
    forward timed by CUDA events around 3 calls (unfused, fused, fused,
    unfused). Returns {"unfused_ms": [..], "fused_ms": [..]}."""
    unet = models["unet"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    b = 16
    sample, pose = rand(b, 64, 128, 9), rand(b, 64, 128, 320)
    ctx, labels = rand(b, 258, 1024), rand(b, 1024)
    ctx[: b // 2] = 0
    labels[: b // 2] = 0
    ts = torch.full((b,), 500, device=dev)

    def forward():
        return unet(sample, ts, ctx, labels, pose, zero_ctx_prefix=b // 2)

    def fused(on):
        unet.cfg = dataclasses.replace(unet.cfg, fused_conv=on)

    times = {"unfused_ms": [], "fused_ms": []}
    with torch.inference_mode():
        try:
            eps_u = forward()
            fused(True)
            fa.reset_launches()
            eps_f = forward()
            torch.cuda.synchronize()
            launches = {n: c for n, c in fa.LAUNCHES.items() if c}
            for on in (False, True, True, False):
                fused(on)
                times["fused_ms" if on else "unfused_ms"].append(
                    cuda_ms(forward, 3, 1))
            by_name = {}
            for on in (False, True):
                fused(on)
                key = "fused_kernel_ms" if on else "unfused_kernel_ms"
                times[key], by_name[on] = profile_kernels(
                    forward, f"UNet batch 16 forward, fused_conv={on}")
        finally:
            fused(False)
    # where the two forwards' device time differs, by kernel
    names = set(by_name[False]) | set(by_name[True])
    diff = {n: by_name[True].get(n, 0.0) - by_name[False].get(n, 0.0)
            for n in names}
    for name, ms in sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:10]:
        print(f"[profile]   fused - unfused {ms:+8.3f} ms  {name[:150]}",
              flush=True)
    rel = _rel_l2(eps_f, eps_u)
    print(f"[unet] batch 16 (64x128 latents, bf16): fused_conv=True vs False "
          f"eps rel_l2 = {rel:.3e} (bar {BAR_FUSED_UNET_REL_L2:g}); launches "
          f"{launches}; forward ms (CUDA events, 3 calls; unfused, fused, "
          f"fused, unfused): {times['unfused_ms'][0]:.2f} "
          f"{times['fused_ms'][0]:.2f} {times['fused_ms'][1]:.2f} "
          f"{times['unfused_ms'][1]:.2f}", flush=True)
    if not torch.isfinite(eps_f).all() or not rel <= BAR_FUSED_UNET_REL_L2:
        fail("UNet batch 16: the fused convs disagree with the unfused")
    if launches != {"flash_frozen": 15, "fused_gn_silu_conv": 44}:
        fail(f"expected 44 fused-conv and 15 frozen launches per fused UNet "
             f"forward at batch 16, got {launches}")
    del eps_u, eps_f
    torch.cuda.empty_cache()
    return times


def phase_pipeline(fa, models, dev):
    from pcdms_tpu_torch.pipelines.stage2_inpaint import stage2_generate
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    canvas = torch.rand((1, 512, 1024, 3), generator=gen, device=dev) * 2 - 1
    canvas[:, :, 512:] = -1.0
    pose = torch.rand((1, 512, 1024, 3), generator=gen, device=dev) * 2 - 1
    dino = torch.randn((1, 257, 1536), generator=gen, device=dev)
    emb = torch.randn((1, 1, 1024), generator=gen, device=dev)

    unet_ms, unhook = _step_timer(models["unet"])
    launches = {}
    unet = models["unet"]
    runs = [("ddim", 4, {}, False), ("unipc", 3, {}, False),
            ("ddim", 2, {"PCDMS_FROZEN_MAX": "0", "PCDMS_SHORTKV": "pallas"},
             False),
            ("ddim", 4, {}, True)]
    try:
        for scheduler, steps, env, fused in runs:
            restore = _with_env(env)
            unet.cfg = dataclasses.replace(unet.cfg, fused_conv=fused)
            unet_ms.clear()
            torch.cuda.reset_peak_memory_stats()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fa.reset_launches()
                images = stage2_generate(
                    models, canvas, pose, dino, emb,
                    generator=torch.Generator(device=dev).manual_seed(SEED),
                    num_steps=steps, scheduler=scheduler, guidance_scale=2.0,
                    compute_dtype=torch.bfloat16, decode=True)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = dict(fa.LAUNCHES)
            finally:
                unet.cfg = dataclasses.replace(unet.cfg, fused_conv=False)
                restore()
            step_s = sum(a.elapsed_time(b) for a, b in unet_ms) / 1e3 / steps
            peak = torch.cuda.max_memory_allocated() / 2**30
            ok = (tuple(images.shape) == (1, 512, 1024, 3)
                  and bool(torch.isfinite(images).all())
                  and images.abs().max().item() < 1e3)
            label = f"{scheduler}-{steps}" + (
                "[" + " ".join(f"{k}={v}" for k, v in env.items()) + "]"
                if env else "") + ("[fused_conv]" if fused else "")
            print(f"[pipeline] stage2_generate {label} 512x1024 1 pair CFG "
                  f"2.0 bf16: {seconds:.2f} s total, {step_s:.4f} s per "
                  f"denoise step (UNet, CUDA events), peak "
                  f"{peak:.2f} GiB, images min {images.min().item():.3f} "
                  f"max {images.max().item():.3f}, launches {counts}",
                  flush=True)
            if not ok:
                fail(f"stage2_generate {label}: images not finite / "
                     f"out of range, shape {tuple(images.shape)}")
            if not env and counts["flash_frozen"] != 15 * steps:
                fail(f"{label}: expected {15 * steps} frozen launches, "
                     f"got {counts}")
            if env.get("PCDMS_SHORTKV") == "pallas" and (
                    counts["flash_shortkv"] != 17 * steps):
                fail(f"{label}: expected {17 * steps} short-kv launches, "
                     f"got {counts}")
            if counts["fused_gn_silu_conv"] != (44 * steps if fused else 0):
                fail(f"{label}: expected {44 * steps if fused else 0} fused "
                     f"conv launches, got {counts}")
            for name, c in counts.items():
                if c:
                    launches.setdefault(name, c)
    finally:
        unhook()
    for name in ("flash_frozen", "flash_online", "flash_shortkv",
                 "fused_gn_silu_conv"):
        if not launches.get(name):
            fail(f"kernel {name} was not launched on the sampler path")
    return launches


def _max_rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def bwd_bounds(bh: int, lq: int, lk: int, d: int = 64):
    """Bounds of kernels 4-6 in bf16: the LSE forward (q, k, v read, o and
    the f32 LSE written; two products), dq (q, k, v, dO read, dq written,
    the LSE and D read; three products) and dk / dv (q, k, v, dO read, dk
    and dv written; four products). {kernel: (ms, bound_by)}."""
    pair = 2 * bh * lq * lk * d           # flops of one L_q x L_k x d mm
    io = 2 * (bh * lq * d + bh * lk * d)  # bytes of one q-sized + k-sized
    return {
        "flash_fwd_lse": bound(2 * pair, io * 2 + 4 * bh * lq),
        "flash_dq": bound(3 * pair, 2 * (3 * bh * lq * d + 2 * bh * lk * d)
                          + 8 * bh * lq),
        "flash_dkv": bound(4 * pair, 2 * (2 * bh * lq * d + 4 * bh * lk * d)
                           + 8 * bh * lq),
    }


def phase_bwd_kernels(fb):
    """Kernels 4-6 vs their plain versions on the same inputs, timed at the
    three training levels; returns the level-0 records for the JSON line,
    each with the other two levels under ``other_levels``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    records = {}

    def check(bh, lq, lk, dtype, timed, record=False):
        q, k, v, do = (torch.randn((bh, n, 64), generator=gen, device=dev)
                       .to(dtype) for n in (lq, lk, lk, lq))
        scale = 1.0 / math.sqrt(64)
        out, lse2 = fb.flash_fwd_lse(q, k, v, scale)
        dq, dk, dv = fb.flash_bwd(q, k, v, out, lse2, do, scale)
        torch.cuda.synchronize()
        dsum = fb.row_dot(do, out)
        p_out, p_lse2 = fb.flash_fwd_lse_plain(q, k, v, scale)
        p_dq = fb.flash_dq_plain(q, k, v, lse2, do, dsum, scale)
        p_dk, p_dv = fb.flash_dkv_plain(q, k, v, lse2, do, dsum, scale)
        bf16 = dtype == torch.bfloat16
        tag = "bf16" if bf16 else "f32"
        bars = {"out": (1e-2 if bf16 else BAR_F32_REL, None),
                "lse": (BAR_LSE_REL, None)}
        for name in ("dq", "dk", "dv"):
            bars[name] = ((1e-2, BAR_BWD_REL_L2) if bf16
                          else (BAR_F32_REL, None))
        pairs = {"out": (out, p_out), "lse": (lse2, p_lse2), "dq": (dq, p_dq),
                 "dk": (dk, p_dk), "dv": (dv, p_dv)}
        errs, parts, ok = {}, [], True
        for name, (got, want) in pairs.items():
            mr, l2 = _max_rel(got, want), _rel_l2(got, want)
            errs[name] = (got.float() - want.float()).abs().max().item()
            bar_max, bar_l2 = bars[name]
            ok &= bool(torch.isfinite(got).all()) and mr <= bar_max and (
                bar_l2 is None or l2 <= bar_l2)
            parts.append(f"{name} max_abs_err={errs[name]:.3e} "
                         f"err/max|want|={mr:.2e} (bar {bar_max:g}) "
                         f"rel_l2={l2:.2e}"
                         + (f" (bar {bar_l2:g})" if bar_l2 else ""))
        print(f"[bwd] {tag} bh={bh} lq={lq} lk={lk}: " + "; ".join(parts),
              flush=True)
        if not ok:
            fail(f"backward kernels disagree with their plain versions at "
                 f"{tag} bh={bh} lq={lq} lk={lk}")
        if not timed:
            return
        d = 64
        fwd_ms = cuda_ms(lambda: fb.flash_fwd_lse(q, k, v, scale), 10)
        dq_ms = cuda_ms(lambda: fb.launch_dq(q, k, v, lse2, do, dsum, scale),
                        10)
        dkv_ms = cuda_ms(
            lambda: fb.launch_dkv(q, k, v, lse2, do, dsum, scale), 10)
        bwd_ms = cuda_ms(lambda: fb.flash_bwd(q, k, v, out, lse2, do, scale),
                         10)
        plain_fwd = cuda_ms(lambda: fb.flash_fwd_lse_plain(q, k, v, scale),
                            2, 1)
        plain_dq = cuda_ms(
            lambda: fb.flash_dq_plain(q, k, v, lse2, do, dsum, scale), 2, 1)
        plain_dkv = cuda_ms(
            lambda: fb.flash_dkv_plain(q, k, v, lse2, do, dsum, scale), 2, 1)
        q4, k4, v4 = (x[None].detach().requires_grad_() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_fwd = cuda_ms(lambda: sdpa(q4, k4, v4), 10)
        lib_fwd_bwd = cuda_ms(lambda: sdpa(q4, k4, v4).backward(do[None]), 10)
        lib_bwd = lib_fwd_bwd - lib_fwd
        bounds = bwd_bounds(bh, lq, lk, d)
        rows = {
            "flash_fwd_lse": (fwd_ms, plain_fwd, lib_fwd,
                              bounds["flash_fwd_lse"], errs["out"]),
            "flash_dq": (dq_ms, plain_dq, lib_bwd, bounds["flash_dq"],
                         errs["dq"]),
            "flash_dkv": (dkv_ms, plain_dkv, lib_bwd, bounds["flash_dkv"],
                          max(errs["dk"], errs["dv"])),
        }
        for name, (ms, plain_ms, lib_ms, (b_ms, b_by), err) in rows.items():
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            if record:
                records[name] = dict(rec, other_levels=[])
            else:
                records[name]["other_levels"].append(
                    dict(rec, shape=[bh, lq, lk]))
            print(f"[bwd]   {name}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}"
                  f" library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})",
                  flush=True)
        pair = 2 * bh * lq * lk * d           # flops of one L_q x L_k x d mm
        io = 2 * (bh * lq * d + bh * lk * d)  # bytes of one q-sized + k-sized
        both, both_by = bound(5 * pair, 4 * io)
        print(f"[bwd]   flash_bwd (D + dq + dk/dv): kernel_ms={bwd_ms:.4f} "
              f"vs SDPA backward (fwd+bwd {lib_fwd_bwd:.4f} - fwd "
              f"{lib_fwd:.4f}) = {lib_bwd:.4f}; bound_ms={both:.4f} "
              f"({both_by}, 5 products)", flush=True)

    for i, (bh, lq, lk) in enumerate(TRAIN_SHAPES):
        check(bh, lq, lk, torch.bfloat16, timed=(bh, lq, lk) in PATH_SHAPES,
              record=i == 0)
        torch.cuda.empty_cache()
    for bh, lq, lk in EDGE_SHAPES:
        check(bh, lq, lk, torch.bfloat16, timed=False)
    check(2, 640, 600, torch.float32, timed=False)
    return records


def phase_unet_grad(fa, dev):
    """One loss and one backward of the full-width UNet (f32 master weights,
    bf16 compute) through the kernels, then through plain attention."""
    from pcdms_tpu_torch.models.unet2d import (
        UNet2DConditionModel, stage2_unet_config,
    )
    torch.manual_seed(SEED)
    with torch.device(dev):
        unet = UNet2DConditionModel(stage2_unet_config())
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    bf = torch.bfloat16
    sample, pose = rand(1, 64, 128, 9).to(bf), rand(1, 64, 128, 320).to(bf)
    ctx, labels = rand(1, 258, 1024).to(bf), rand(1, 1024).to(bf)
    target, ts = rand(1, 64, 128, 4), torch.tensor([500], device=dev)

    def grads(use_flash):
        unet.cfg = dataclasses.replace(unet.cfg, use_flash=use_flash)
        unet.zero_grad(set_to_none=True)
        eps = unet(sample, ts, ctx, labels, pose)
        loss = torch.mean(torch.square(eps.float() - target))
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: p.grad for n, p in unet.named_parameters()}

    fa.reset_launches()
    t0 = time.perf_counter()
    loss_k, g_k = grads(True)
    k_s = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    missing = [n for n, g in g_k.items()
               if g is None or not bool(torch.isfinite(g).all())]
    loss_p, g_p = grads(False)
    num = sum((g_k[n].float() - g_p[n].float()).square().sum() for n in g_p)
    den = sum(g_p[n].float().square().sum() for n in g_p)
    rel = (num.sqrt() / den.sqrt()).item()
    level0 = "down_blocks.0.attentions.0.transformer_blocks.0.attn1."
    rels = {w: _rel_l2(g_k[level0 + w + ".weight"], g_p[level0 + w
                                                          + ".weight"])
            for w in ("to_q", "to_k", "to_v")}
    print(f"[grad] stage2 UNet 64x128 latents batch 1 bf16 / f32 weights: "
          f"loss kernels {loss_k:.6f} plain {loss_p:.6f}; gradient rel_l2 "
          f"{rel:.3e} (bar {BAR_GRAD_REL_L2:g}); level-0 attn1 "
          + " ".join(f"{w} {r:.3e}" for w, r in rels.items())
          + f"; {len(g_k)} parameters, {len(missing)} without a finite "
          f"gradient; launches {launches}; loss+backward {k_s:.2f} s "
          f"(first call)", flush=True)
    if missing:
        fail(f"parameters without a finite gradient: {missing[:5]}")
    if not max([rel, *rels.values()]) <= BAR_GRAD_REL_L2:
        fail("full-width UNet gradient: kernels disagree with plain "
             "attention")
    want = {"flash_fwd_lse": 15, "flash_dq": 15, "flash_dkv": 15}
    if {n: c for n, c in launches.items() if c} != want:
        fail(f"expected {want} launches for one UNet gradient, got "
             f"{launches}")


def phase_train(fa, dev):
    """The training path at full width, as ``cli/stage2_train.main`` drives
    it (without an output_dir: no 14 GB checkpoint). Returns the launches of
    its first run."""
    from pcdms_tpu_torch.cli import stage2_train as cli
    from pcdms_tpu_torch.cli.common import (
        compute_dtype_from_args, train_config_from_args,
    )
    from pcdms_tpu_torch.train.common import (
        init_train_state, make_train_step,
    )
    from pcdms_tpu_torch.data.loader import prefetch_to_device
    from pcdms_tpu_torch.train.loop import run_training
    from pcdms_tpu_torch.train.stage2 import stage2_loss_fn

    args = cli.parse_args([
        "--output_dir", "unused", "--random_init", "--synthetic_data",
        "--img_height", "512", "--img_width", "512", "--train_batch_size",
        "2", "--learning_rate", "1e-4", "--lr_warmup_steps", "1",
        "--mixed_precision", "bf16", "--seed", str(SEED)])
    cli.check_supported(args)
    _, trainable, vae, _, _, aux = cli.build_models(args, dev)
    loss_fn = stage2_loss_fn(vae, noise_offset=args.noise_offset,
                             compute_dtype=compute_dtype_from_args(args))
    tcfg = train_config_from_args(args)
    n_params = sum(p.numel() for m in trainable.values()
                   for p in m.parameters())
    print(f"[train] stage-2 full width: {n_params / 1e6:.1f}M trainable "
          f"parameters (f32), VAE frozen, batch {args.train_batch_size} at "
          f"{args.img_height}x{2 * args.img_width}, bf16", flush=True)

    def drive(label, steps, lse_per_step):
        rows = []

        def on_step(step, metrics):
            loss = metrics["loss"].item()     # waits for the step
            rows.append((step, loss, metrics["grad_norm"].item(),
                         time.perf_counter()))

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        state = run_training(loss_fn, trainable, cli.synthetic_batches(
            args, aux), tcfg, device=dev, seed=args.seed,
            max_train_steps=steps, log_every=args.log_every,
            on_step=on_step)
        torch.cuda.synchronize()
        counts = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        del state
        prev = t0
        for step, loss, gnorm, t in rows:
            print(f"[train] {label} step {step}: loss {loss:.5f} grad_norm "
                  f"{gnorm:.4f} {t - prev:.3f} s/step "
                  f"{args.train_batch_size / (t - prev):.3f} examples/s",
                  flush=True)
            prev = t
        print(f"[train] {label}: {steps} steps, peak {peak:.2f} GiB, "
              f"launches {counts}", flush=True)
        want = {"flash_fwd_lse": lse_per_step * steps,
                "flash_dq": 15 * steps, "flash_dkv": 15 * steps}
        if len(rows) != steps or not all(math.isfinite(r[1]) and
                                         math.isfinite(r[2]) for r in rows):
            fail(f"{label}: expected {steps} finite steps, got {rows}")
        if {n: c for n, c in counts.items() if c} != want:
            fail(f"{label}: expected launches {want}, got {counts}")
        return counts, peak

    # first, from the random init: one batch, the same draws every step
    # (the loss must fall); the runs below start from the same init
    init = {k: copy.deepcopy(m.state_dict()) for k, m in trainable.items()}
    state = init_train_state(trainable, tcfg)
    step_fn = make_train_step(loss_fn, tcfg)
    batch = next(prefetch_to_device(cli.synthetic_batches(args, aux), dev))
    losses = [step_fn(state, batch, torch.Generator(device=dev).manual_seed(
        SEED))["loss"].item() for _ in range(5)]
    print(f"[train] fixed batch and draws, 5 steps (the first update has lr "
          f"0): losses {[round(x, 6) for x in losses]}", flush=True)
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        fail("training on a fixed batch did not lower the loss")
    del state, batch
    for k, m in trainable.items():
        m.load_state_dict(init[k])
    del init

    launches, peak = drive("run_training", 4, 15)
    unet = trainable["unet"]
    unet.cfg = dataclasses.replace(unet.cfg, remat=True)
    _, peak_remat = drive("run_training remat", 2, 30)
    unet.cfg = dataclasses.replace(unet.cfg, remat=False)
    print(f"[train] peak memory without / with remat: {peak:.2f} / "
          f"{peak_remat:.2f} GiB", flush=True)
    profile_window(run_training, loss_fn, trainable, cli, args, aux, tcfg,
                   dev)
    del trainable, vae
    gc.collect()
    torch.cuda.empty_cache()
    return {n: c for n, c in launches.items() if c}


def _kernel_times(events):
    """Device kernels of a chrome trace: {name: us}, the busy time (ms) and
    the window (ms) from the first kernel's start to the last one's end,
    and their count."""
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "kernel" and "dur" in e)
    if not kernels:
        fail("the profiler trace holds no device kernels")
    by_name, busy, end = {}, 0.0, kernels[0][0]
    for t0, t1, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return by_name, busy / 1e3, (end - kernels[0][0]) / 1e3, len(kernels)


def profile_kernels(fn, label, top=8):
    """One call of ``fn`` under torch.profiler: its device time by kernel
    (the ``top`` longest printed), summed, and the device's busy share of
    the call's window. Returns the sum (ms) and {kernel name: ms}."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    by_name, busy, window, n_kernels = _kernel_times(events)
    total = sum(by_name.values()) / 1e3
    print(f"[profile] {label}: {n_kernels} kernels, kernel time {total:.2f} "
          f"ms, window {window:.2f} ms, device busy {busy / window:.1%}",
          flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"[profile]   {us / 1e3:8.3f} ms {us / 1e3 / total:6.1%}  "
              f"{name[:110]}", flush=True)
    return total, {name: us / 1e3 for name, us in by_name.items()}


def profile_window(run_training, loss_fn, trainable, cli, args, aux, tcfg,
                   dev, label="run_training"):
    """``run_training``'s ``profile_dir`` trace of steps 3-6 (7 steps):
    device time by kernel, and the device's busy share of the window."""
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        run_training(loss_fn, trainable, cli.synthetic_batches(args, aux),
                     tcfg, device=dev, seed=args.seed, max_train_steps=7,
                     log_every=args.log_every, profile_dir=tmp)
        torch.cuda.synchronize()
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    by_name, busy, window, n_kernels = _kernel_times(events)
    total = sum(by_name.values()) / 1e3
    flash = sum(v for k, v in by_name.items() if "flash_" in k) / 1e3
    print(f"[profile] steps 3-6 of {label} (torch.profiler, "
          f"profile_dir): {n_kernels} kernels, window {window:.1f} ms "
          f"({window / 4:.1f} ms/step), device busy {busy:.1f} ms = "
          f"{busy / window:.1%}, kernel time {total:.1f} ms, of which "
          f"the flash kernels {flash:.1f} ms ({flash / total:.1%})",
          flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[profile]   {us / 1e3:9.2f} ms {us / 1e3 / total:6.1%}  "
              f"{name[:110]}", flush=True)


# kernels 4-6 at the stage-3 trainer's self-attentions, (B*H, L, L): 512x512
# images at batch 2 (5 heads at 4096 tokens, 10 at 1024) and level 0 at the
# CLI's default batch 16
STAGE3_TRAIN_SHAPES = [(10, 4096, 4096), (20, 1024, 1024), (80, 4096, 4096)]
# the stage-3 UNet's self-attentions that take kernels 4-6 under autograd:
# 5 at level 0 and 5 at level 1 (the 16x16 level's 256 tokens take plain
# attention)
STAGE3_TRAIN_ATTN = 10


def phase_bwd_stage3(fb, shapes=STAGE3_TRAIN_SHAPES):
    """Kernels 4-6 (bf16) against their plain versions at ``shapes``, each
    timed by device time (``graph_ms``) beside SDPA's forward and backward
    on the same inputs (also by graph replay: the backward is the captured
    forward + backward less the forward), its plain version (CUDA events)
    and its bound. Returns {kernel: records}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = 0.125
    out = {"flash_fwd_lse": [], "flash_dq": [], "flash_dkv": []}
    for bh, lq, lk in shapes:
        q, k, v, do = (torch.randn((bh, n, 64), generator=gen, device=dev)
                       .to(torch.bfloat16) for n in (lq, lk, lk, lq))
        o, lse2 = fb.flash_fwd_lse(q, k, v, scale)
        dsum = fb.row_dot(do, o)
        dq = fb.launch_dq(q, k, v, lse2, do, dsum, scale)
        dk, dv = fb.launch_dkv(q, k, v, lse2, do, dsum, scale)
        torch.cuda.synchronize()
        p_o, p_lse2 = fb.flash_fwd_lse_plain(q, k, v, scale)
        checks = {"flash_fwd_lse": [(o, p_o, 1e-2, None),
                                    (lse2, p_lse2, BAR_LSE_REL, None)]}
        del p_o, p_lse2
        p_dq = fb.flash_dq_plain(q, k, v, lse2, do, dsum, scale)
        checks["flash_dq"] = [(dq, p_dq, 1e-2, BAR_BWD_REL_L2)]
        p_dk, p_dv = fb.flash_dkv_plain(q, k, v, lse2, do, dsum, scale)
        checks["flash_dkv"] = [(dk, p_dk, 1e-2, BAR_BWD_REL_L2),
                               (dv, p_dv, 1e-2, BAR_BWD_REL_L2)]
        errs = {}
        for name, pairs in checks.items():
            errs[name] = 0.0
            for got, want, bar_max, bar_l2 in pairs:
                mr, l2 = _max_rel(got, want), _rel_l2(got, want)
                errs[name] = max(errs[name], (got.float() - want.float())
                                 .abs().max().item())
                if (not bool(torch.isfinite(got).all()) or mr > bar_max
                        or (bar_l2 is not None and l2 > bar_l2)):
                    fail(f"{name} disagrees with its plain version at the "
                         f"stage-3 shape bh={bh} lq={lq} lk={lk}: "
                         f"err/max|want| {mr:.2e}, rel_l2 {l2:.2e}")
        del checks, p_dq, p_dk, p_dv
        calls = {
            "flash_fwd_lse": (lambda: fb.flash_fwd_lse(q, k, v, scale),
                              lambda: fb.flash_fwd_lse_plain(q, k, v, scale)),
            "flash_dq": (lambda: fb.launch_dq(q, k, v, lse2, do, dsum, scale),
                         lambda: fb.flash_dq_plain(q, k, v, lse2, do, dsum,
                                                   scale)),
            "flash_dkv": (lambda: fb.launch_dkv(q, k, v, lse2, do, dsum,
                                                scale),
                          lambda: fb.flash_dkv_plain(q, k, v, lse2, do, dsum,
                                                     scale))}
        q4, k4, v4 = (x[None].detach().requires_grad_() for x in (q, k, v))
        do4 = do[None]

        def lib_fwd_bwd():
            q4.grad = k4.grad = v4.grad = None   # no accumulation kernels
            sdpa(q4, k4, v4, scale=scale).backward(do4)

        lib_fwd = graph_ms(lambda: sdpa(q4, k4, v4, scale=scale))
        lib_bwd = graph_ms(lib_fwd_bwd) - lib_fwd
        del q4, k4, v4, do4
        bounds = bwd_bounds(bh, lq, lk)
        for name, (kernel, plain) in calls.items():
            ms = graph_ms(kernel)
            plain_ms = cuda_ms(plain, 2, 1)
            b_ms, b_by = bounds[name]
            lib_ms = lib_fwd if name == "flash_fwd_lse" else lib_bwd
            print(f"[bwd-s3] {name} bf16 bh={bh} lq={lq} lk={lk}: "
                  f"max_abs_err={errs[name]:.3e}; kernel_ms={ms:.4f} (CUDA "
                  f"graph) plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                  f"(SDPA {'forward' if lib_ms is lib_fwd else 'backward'}, "
                  f"CUDA graph) bound_ms={b_ms:.4f} ({b_by}) = "
                  f"{b_ms / ms:.1%} of the kernel's", flush=True)
            out[name].append(dict(shape=[bh, lq, lk],
                                  max_abs_err=errs[name], ms=ms,
                                  plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=lib_ms))
        del q, k, v, do, o, lse2, dsum, dq, dk, dv, calls
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _train_cli_args(cli, *extra):
    """Full-width, random-init trainer flags (512x512, lr 1e-4 after one
    warmup step, bf16)."""
    return cli.parse_args([
        "--output_dir", "unused", "--random_init", "--img_height", "512",
        "--img_width", "512", "--learning_rate", "1e-4",
        "--lr_warmup_steps", "1", "--mixed_precision", "bf16", "--seed",
        str(SEED), *extra])


def _drive_training(fa, run_training, loss_fn, trainable, batches, tcfg, dev,
                    label, steps, batch_size, want):
    """``run_training`` for ``steps`` steps with every count at 0 before:
    s per step (host clock, each step waited for), peak GiB and the
    launches, which must be ``want``. Returns (launches, peak GiB, mean s
    per step after the first)."""
    rows = []

    def on_step(step, metrics):
        rows.append((step, metrics["loss"].item(),
                     metrics["grad_norm"].item(), time.perf_counter()))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    state = run_training(loss_fn, trainable, batches, tcfg, device=dev,
                         seed=SEED, max_train_steps=steps, log_every=1000,
                         on_step=on_step)
    torch.cuda.synchronize()
    counts = {n: c for n, c in fa.LAUNCHES.items() if c}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    prev, times = t0, []
    for step, loss, gnorm, t in rows:
        times.append(t - prev)
        print(f"[{label}] step {step}: loss {loss:.5f} grad_norm "
              f"{gnorm:.4f} {t - prev:.3f} s/step "
              f"{batch_size / (t - prev):.3f} examples/s", flush=True)
        prev = t
    later = times[1:] or times
    per_step = sum(later) / len(later)
    print(f"[{label}] {steps} steps at batch {batch_size}: "
          f"{per_step:.3f} s/step after the first, peak {peak:.2f} GiB, "
          f"launches {counts}", flush=True)
    if len(rows) != steps or not all(math.isfinite(r[1])
                                     and math.isfinite(r[2]) for r in rows):
        fail(f"{label}: expected {steps} finite steps, got {rows}")
    if counts != want:
        fail(f"{label}: expected launches {want}, got {counts}")
    return counts, peak, per_step


def phase_train_stage3(fa, dev):
    """The stage-3 trainer at full width, as ``cli/stage3_train.main``
    drives it (without an output_dir: no 10 GB checkpoint; stage 1's
    full-width one is written and resumed in ``phase_train_data``): the
    8-channel stage-3 UNet
    (f32 master weights, bf16 compute), the full VAE frozen and
    ``image_proj``, 512x512. One batch's loss and gradient through kernels
    4-6 against plain attention; ``run_training`` 4 steps at batch 2 and 2
    steps at the CLI's batch 16 with ``--gradient_checkpointing``. Returns
    the launches of the two runs."""
    from pcdms_tpu_torch.cli import stage3_train as cli
    from pcdms_tpu_torch.cli.common import (
        compute_dtype_from_args, train_config_from_args,
    )
    from pcdms_tpu_torch.data.loader import prefetch_to_device
    from pcdms_tpu_torch.diffusion.schedules import sd21_schedule
    from pcdms_tpu_torch.train.loop import run_training
    from pcdms_tpu_torch.train.stage3 import (
        stage3_draws, stage3_loss, stage3_loss_fn,
    )
    from pcdms_tpu_torch.utils.tree import (
        cast_tree, param_bytes, param_count,
    )

    args = _train_cli_args(cli, "--synthetic_data", "--train_batch_size", "2")
    cli.check_supported(args)
    _, trainable, vae, _, aux = cli.build_models(args, dev)
    dtype = compute_dtype_from_args(args)
    loss_fn = stage3_loss_fn(vae, noise_offset=args.noise_offset,
                             compute_dtype=dtype)
    tcfg = train_config_from_args(args)
    unet = trainable["unet"]
    print(f"[train-s3] stage-3 full width: "
          f"{param_count(trainable) / 1e6:.1f}M trainable "
          f"parameters (f32, {param_bytes(trainable) / 2**30:.2f} GiB), VAE "
          f"frozen, 512x512, bf16 compute", flush=True)

    # one batch's loss and gradient: kernels 4-6 vs plain attention
    batch = next(prefetch_to_device(cli.synthetic_batches(args, aux), dev))
    draws = stage3_draws(torch.Generator(device=dev).manual_seed(SEED), 2,
                         (64, 64), device=dev)
    vae_c = cast_tree(vae, dtype)

    def grads(use_flash):
        unet.cfg = dataclasses.replace(unet.cfg, use_flash=use_flash)
        for m in trainable.values():
            m.zero_grad(set_to_none=True)
        loss = stage3_loss(trainable, vae_c, batch, draws,
                           schedule=sd21_schedule(), compute_dtype=dtype)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {f"{k}.{n}": p.grad for k, m in trainable.items()
                             for n, p in m.named_parameters()}

    fa.reset_launches()
    loss_k, g_k = grads(True)
    counts = {n: c for n, c in fa.LAUNCHES.items() if c}
    loss_p, g_p = grads(False)
    unet.cfg = dataclasses.replace(unet.cfg, use_flash=True)
    missing = [n for n, g in g_k.items()
               if g is None or not bool(torch.isfinite(g).all())]
    num = sum((g_k[n].float() - g_p[n].float()).square().sum() for n in g_p)
    den = sum(g_p[n].float().square().sum() for n in g_p)
    rel = (num.sqrt() / den.sqrt()).item()
    print(f"[train-s3] one batch (2 x 512x512), fixed draws: loss kernels "
          f"{loss_k:.6f} plain {loss_p:.6f}; gradient rel_l2 {rel:.3e} (bar "
          f"{BAR_GRAD_REL_L2:g}); {len(g_k)} parameters, {len(missing)} "
          f"without a finite gradient; launches {counts}", flush=True)
    want = dict.fromkeys(("flash_fwd_lse", "flash_dq", "flash_dkv"),
                         STAGE3_TRAIN_ATTN)
    if missing:
        fail(f"stage-3 parameters without a finite gradient: {missing[:5]}")
    if not rel <= BAR_GRAD_REL_L2 or not math.isfinite(loss_k):
        fail("stage-3 gradient: kernels disagree with plain attention")
    if counts != want:
        fail(f"stage-3 gradient: expected launches {want}, got {counts}")
    for m in trainable.values():
        m.zero_grad(set_to_none=True)
    del batch, draws, vae_c, g_k, g_p

    total = {}
    counts, peak2, _ = _drive_training(
        fa, run_training, loss_fn, trainable,
        cli.synthetic_batches(args, aux), tcfg, dev, "train-s3", 4, 2,
        {k: 4 * v for k, v in want.items()})
    _add(total, counts)
    args16 = _train_cli_args(cli, "--synthetic_data",
                             "--gradient_checkpointing")
    unet.cfg = dataclasses.replace(unet.cfg, remat=True)
    counts, peak16, _ = _drive_training(
        fa, run_training, loss_fn, trainable,
        cli.synthetic_batches(args16, aux), tcfg, dev, "train-s3 b16 remat",
        2, args16.train_batch_size,
        {"flash_fwd_lse": 2 * 2 * STAGE3_TRAIN_ATTN,
         "flash_dq": 2 * STAGE3_TRAIN_ATTN,
         "flash_dkv": 2 * STAGE3_TRAIN_ATTN})
    unet.cfg = dataclasses.replace(unet.cfg, remat=False)
    _add(total, counts)
    print(f"[train-s3] peak memory: batch 2 {peak2:.2f} GiB, batch 16 with "
          f"remat {peak16:.2f} GiB", flush=True)
    profile_window(run_training, loss_fn, trainable, cli, args, aux, tcfg,
                   dev, "the stage-3 run_training, batch 2")
    del trainable, vae, unet, loss_fn
    gc.collect()
    torch.cuda.empty_cache()
    return total


def phase_train_stage1(fa, dev):
    """The stage-1 trainer at full width, as ``cli/stage1_train.main``
    drives it (no output_dir): the full PriorConfig() (f32 master weights,
    bf16 compute) at the CLI's batch 128, 4 steps of synthetic batches; then
    a 2-layer full-width prior's loss and gradient (f32, TF32 off), card
    against the CPU, within BAR_PRIOR_REL_L2: no kernel guards the prior.
    Returns the launches (none: six tokens take plain attention)."""
    import numpy as np
    from pcdms_tpu_torch.cli import stage1_train as cli
    from pcdms_tpu_torch.cli.common import (
        compute_dtype_from_args, train_config_from_args,
    )
    from pcdms_tpu_torch.diffusion.schedules import prior_schedule
    from pcdms_tpu_torch.models.prior_transformer import (
        PriorConfig, PriorTransformer,
    )
    from pcdms_tpu_torch.train.loop import run_training
    from pcdms_tpu_torch.train.stage1 import stage1_loss, stage1_loss_fn
    from pcdms_tpu_torch.utils.tree import param_count

    args = _train_cli_args(cli, "--synthetic_data")
    cli.check_supported(args)
    prior_cfg, trainable, _ = cli.build_models(args, dev)
    n_params = param_count(trainable)
    loss_fn = stage1_loss_fn(noise_offset=args.noise_offset,
                             compute_dtype=compute_dtype_from_args(args))
    print(f"[train-s1] PriorConfig() {n_params / 1e6:.1f}M parameters (f32), "
          f"bf16 compute, batch {args.train_batch_size}", flush=True)
    counts, _, _ = _drive_training(
        fa, run_training, loss_fn, trainable,
        cli.synthetic_batches(args, prior_cfg.embedding_dim),
        train_config_from_args(args), dev, "train-s1", 4,
        args.train_batch_size, {})
    del trainable, loss_fn
    gc.collect()
    torch.cuda.empty_cache()

    torch.manual_seed(SEED + 51)
    cpu_prior = PriorTransformer(dataclasses.replace(PriorConfig(),
                                                     num_layers=2))
    card_prior = copy.deepcopy(cpu_prior).to(dev)
    rng = np.random.default_rng(SEED + 52)
    batch = {k: torch.from_numpy(rng.standard_normal(
        (8, 1024)).astype(np.float32)) for k in ("s_embed", "t_embed")}
    batch.update({k: torch.from_numpy(rng.uniform(0, 1, (8, 36)).astype(
        np.float32)) for k in ("s_pose", "t_pose")})
    draws = {"noise": torch.from_numpy(rng.standard_normal(
        (8, 1024)).astype(np.float32)),
        "offset": torch.from_numpy(rng.standard_normal((8, 1)).astype(
            np.float32)),
        "timesteps": torch.from_numpy(rng.integers(0, 1000, 8))}

    def loss_and_grad(prior, device):
        loss = stage1_loss({"prior": prior},
                           {k: v.to(device) for k, v in batch.items()},
                           {k: v.to(device) for k, v in draws.items()},
                           schedule=prior_schedule(),
                           compute_dtype=torch.float32)
        loss.backward()
        return loss.item(), torch.cat([p.grad.reshape(-1).cpu()
                                       for p in prior.parameters()])

    loss_c, g_c = loss_and_grad(cpu_prior, "cpu")
    loss_g, g_g = loss_and_grad(card_prior, dev)
    rel = _rel_l2(g_g, g_c)
    print(f"[train-s1] the prior cut to 2 layers at full width, f32, batch "
          f"8: loss card {loss_g:.7f} CPU {loss_c:.7f}; gradient card vs "
          f"CPU rel_l2 = {rel:.3e} (bar {BAR_PRIOR_REL_L2:g})", flush=True)
    if (not torch.isfinite(g_g).all() or not rel <= BAR_PRIOR_REL_L2
            or not abs(loss_g - loss_c) <= BAR_PRIOR_REL_L2 * abs(loss_c)):
        fail("the stage-1 loss or gradient on the card disagrees with the "
             "CPU")
    del cpu_prior, card_prior
    return counts


def _gen_dir(root, names):
    """Stage-2 outputs for the stage-3 trainer: a random 512x512 PNG per
    pair, ``{src}_to_{tgt}.png``."""
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(SEED + 53)
    gen_dir = os.path.join(root, "stage2_out")
    os.makedirs(gen_dir)
    for name in names:
        Image.fromarray(rng.integers(0, 255, (512, 512, 3), dtype=np.uint8)
                        ).save(os.path.join(gen_dir, name))
    return gen_dir


def phase_train_data(fa, dev):
    """The three trainer CLIs' ``main`` at full width on the DeepFashion
    layout of ``_batchtest_dataset`` (512x512, 2 pairs, batch 2, 2 steps,
    random weights from the seed): stage 2 with DINOv2-giant and CLIP ViT-H
    on the fly, stage 3 with DINOv2 and ``--gen_dir`` PNGs, stage 1 with
    CLIP ViT-H; then each again with ``--cache_embeddings``. The caches'
    rows against the on-the-fly encoder outputs (the first batch each run's
    loss got) at the bf16 bar, the memory held at the last step with and
    without the cache (the encoders freed), s per step. The stage-1 cached
    run writes its full-width checkpoint (prior weights and AdamW moments,
    f32) and a third run resumes it for one step: the restored parameters
    are the saved ones bit for bit, and AdamW goes on from step 2. The
    other runs' checkpoint writes at the end of ``main`` are skipped (10-12
    GB each). Returns the launches."""
    from pcdms_tpu_torch.cli import stage1_train, stage2_train, stage3_train
    from pcdms_tpu_torch.train import checkpoint
    from pcdms_tpu_torch.train import stage1, stage2, stage3
    from pcdms_tpu_torch.utils.profiling import timed

    clis = {"stage2": (stage2_train, stage2, "stage2_loss_fn"),
            "stage3": (stage3_train, stage3, "stage3_loss_fn"),
            "stage1": (stage1_train, stage1, "stage1_loss_fn")}
    kernel_steps = {"stage2": 15, "stage3": STAGE3_TRAIN_ATTN, "stage1": 0}
    embeds = {"stage2": ("dino_features", "clip_embed"),
              "stage3": ("dino_features",), "stage1": ("s_embed", "t_embed")}
    saves, written = [], []
    orig_save = checkpoint.save_checkpoint

    def save(directory, step, state, **kw):
        saves.append(step)
        if write_checkpoint:
            path, seconds = timed(orig_save, directory, step, state,
                                  sync_output=False, **kw)
            written.append((path, os.path.getsize(path), seconds))

    checkpoint.save_checkpoint = save
    total = {}
    try:
        with tempfile.TemporaryDirectory() as root:
            names = _batchtest_dataset(root)
            gen_dir = _gen_dir(root, names)
            for stage, (cli, loss_mod, loss_name) in clis.items():
                seen = {}
                modes = ("on the fly", "cache") + (
                    ("resume",) if stage == "stage1" else ())
                for mode in modes:
                    steps = 1 if mode == "resume" else 2
                    argv = [
                        "--random_init", "--json_path",
                        os.path.join(root, "train_pairs.json"),
                        "--image_root_path", root, "--output_dir",
                        os.path.join(root, f"out_{stage}"), "--img_height",
                        "512", "--img_width", "512", "--train_batch_size",
                        "2", "--max_train_steps", str(2 + (mode == "resume")),
                        "--seed", str(SEED), "--log_every", "1",
                        "--lr_warmup_steps", "1"]
                    if stage == "stage3":
                        argv += ["--gen_dir", gen_dir]
                    if mode != "on the fly":
                        argv += ["--cache_embeddings",
                                 os.path.join(root, "cache")]
                    if mode == "resume":
                        argv += ["--resume_from_checkpoint"]
                    write_checkpoint = stage == "stage1" and mode == "cache"
                    batches, held, first_params = [], [], []
                    orig_fn = getattr(loss_mod, loss_name)

                    def factory(*a, _orig=orig_fn, _b=batches, _h=held,
                                _p=first_params if mode == "resume" else None,
                                **k):
                        fn = _orig(*a, **k)

                        def loss_fn(models, batch, gen):
                            _h.append((time.perf_counter(),
                                       torch.cuda.memory_allocated()))
                            if not _b:
                                _b.append({n: batch[n].float().cpu()
                                           for n in embeds[stage]})
                            if _p is not None and not _p:
                                # the parameters the resumed run starts
                                # from, in TrainState.params order
                                _p.extend(p.detach().cpu().clone()
                                          for m in models.values()
                                          for p in m.parameters()
                                          if p.requires_grad)
                            return fn(models, batch, gen)
                        return loss_fn

                    setattr(loss_mod, loss_name, factory)
                    gc.collect()
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    torch.cuda.synchronize()
                    fa.reset_launches()
                    t0 = time.perf_counter()
                    try:
                        state = cli.main(argv)
                    finally:
                        setattr(loss_mod, loss_name, orig_fn)
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                    counts = {n: c for n, c in fa.LAUNCHES.items() if c}
                    peak = torch.cuda.max_memory_allocated() / 2**30
                    last = held[-1][1] / 2**30
                    seen[mode] = (batches[0], last)
                    # the loss is read at every step (--log_every 1), so
                    # the loss calls lie one whole step apart
                    step_s = (f"step 1 {held[1][0] - held[0][0]:.3f} s (its "
                              f"batch's data and encoders included)"
                              if len(held) > 1 else "one step")
                    print(f"[train-data] {stage}_train.main {mode}: "
                          f"{state.step - (mode == 'resume') * 2} steps in "
                          f"{seconds:.2f} s (build, encoders and data "
                          f"included), {step_s}, peak {peak:.2f} GiB, "
                          f"{last:.2f} GiB held at the last step; launches "
                          f"{counts}", flush=True)
                    want = {k: steps * kernel_steps[stage] for k in (
                        "flash_fwd_lse", "flash_dq", "flash_dkv")
                        if kernel_steps[stage]}
                    if state.step != 2 + (mode == "resume") or not all(
                            bool(torch.isfinite(p).all())
                            for p in state.params):
                        fail(f"{stage}_train.main {mode}: not {steps} "
                             f"finite steps")
                    if counts != want:
                        fail(f"{stage}_train.main {mode}: expected launches "
                             f"{want}, got {counts}")
                    _add(total, counts)
                    if write_checkpoint:
                        saved = [p.detach().cpu().clone()
                                 for p in state.params]
                        path, size, save_s = written[-1]
                        print(f"[train-data] {stage}_train.main {mode}: "
                              f"{path.name} {size / 2**30:.2f} GiB written "
                              f"in {save_s:.2f} s", flush=True)
                    if mode == "resume":
                        adam_step = int(state.optimizer.state[
                            state.params[0]]["step"])
                        same = len(saved) == len(first_params) and all(
                            torch.equal(x, y)
                            for x, y in zip(saved, first_params))
                        print(f"[train-data] {stage}_train.main resumed "
                              f"from step 2: parameters restored bit for "
                              f"bit {same}, AdamW step {adam_step} after "
                              f"one step", flush=True)
                        if not same or adam_step != 3:
                            fail(f"{stage}: the resumed run does not start "
                                 f"from the saved checkpoint")
                        del saved
                    first_params.clear()
                    del state
                for key in embeds[stage]:
                    got = seen["cache"][0][key]
                    want_ = seen["on the fly"][0][key]
                    mr, l2 = _max_rel(got, want_), _rel_l2(got, want_)
                    print(f"[train-data] {stage} {key}: cache vs on the fly "
                          f"err/max|want| {mr:.2e} (bar {BAR_REL:g}) rel_l2 "
                          f"{l2:.2e}", flush=True)
                    if not mr <= BAR_REL:
                        fail(f"{stage}: the cache's {key} disagrees with the "
                             f"encoder run on the fly")
                freed = seen["on the fly"][1] - seen["cache"][1]
                print(f"[train-data] {stage}: {freed:.2f} GiB less held "
                      f"with the cache (the encoders freed)", flush=True)
                if not freed > 1.0:
                    fail(f"{stage}: the encoders were not freed after the "
                         f"cache was built")
    finally:
        checkpoint.save_checkpoint = orig_save
    if sorted(saves) != [2] * 6 + [3] or len(written) != 1:
        fail(f"expected one final checkpoint per run, got {saves}")
    gc.collect()
    torch.cuda.empty_cache()
    return total


def phase_cli():
    """``cli/stage2_train.main`` on the card at the tiny config: 2 steps,
    then resumed from its checkpoint to step 3."""
    from pcdms_tpu_torch.cli.stage2_train import main as train_main
    from pcdms_tpu_torch.train.checkpoint import latest_step
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--tiny_config", "--synthetic_data", "--random_init",
                "--output_dir", tmp, "--img_height", "64", "--img_width",
                "64", "--train_batch_size", "2", "--lr_warmup_steps", "1",
                "--log_every", "1"]
        first = train_main(argv + ["--max_train_steps", "2"]).step
        saved = latest_step(tmp)
        state = train_main(argv + ["--max_train_steps", "3",
                                   "--resume_from_checkpoint"])
        on_card = state.params[0].is_cuda
        print(f"[cli] stage2_train --tiny_config on the card: {first} steps "
              f"(checkpoint {saved}), resumed to {state.step} (checkpoint "
              f"{latest_step(tmp)}), parameters on CUDA: {on_card}",
              flush=True)
        if (first, saved, state.step, latest_step(tmp), on_card) != (
                2, 2, 3, 3, True):
            fail("the trainer CLI did not train and resume on the card")


def _batchtest_dataset(root):
    """3 synthetic 512x512 images with pose renders and normalised pose
    keypoints in the DeepFashion layout, 2 pairs as test and train pair
    lists, and random stage-1 embeddings (1024-d) for the test pairs."""
    import numpy as np
    from PIL import Image
    from pcdms_tpu_torch.pose.keypoints import write_pose_txt
    rng = np.random.default_rng(SEED)
    names = ["im0", "im1", "im2"]
    for sub in ("train_all_png", "openpose_all_img", "normalized_pose_txt",
                "prior"):
        os.makedirs(os.path.join(root, sub))
    yy, xx = np.mgrid[0:512, 0:512] / 512.0
    for i, name in enumerate(names):
        # smooth colour fields plus noise: images with structure for SSIM
        phase = rng.uniform(0, 2 * np.pi, 3)
        img = 127 + 100 * np.sin(2 * np.pi * (i + 1) * xx[..., None]
                                 + 3 * yy[..., None] + phase)
        img = np.clip(img + rng.normal(0, 20, img.shape), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(root, "train_all_png", f"{name}.png"))
        pose = rng.integers(0, 255, (512, 512, 3), dtype=np.uint8)
        Image.fromarray(pose).save(
            os.path.join(root, "openpose_all_img", f"{name}_pose.jpg"))
        write_pose_txt(os.path.join(root, "normalized_pose_txt",
                                    f"{name}.txt"), rng.uniform(0, 1, 36))
    pairs = [{"source_image": f"train_all_png/{names[i]}.jpg",
              "target_image": f"train_all_png/{names[i + 1]}.jpg"}
             for i in range(2)]
    for json_name in ("test_pairs.json", "train_pairs.json"):
        with open(os.path.join(root, json_name), "w") as f:
            json.dump(pairs, f)
    for i in range(2):
        np.save(os.path.join(root, "prior", f"{names[i]}_to_{names[i + 1]}"
                             ".npy"),
                rng.standard_normal((1, 1024)).astype(np.float32))
    return [f"{names[i]}_to_{names[i + 1]}.png" for i in range(2)]


def _gap_recording(best_of_n, gaps):
    """``best_of_n`` (the batch tests' host selection) that also appends the
    SSIM gap between the best and the second candidate to ``gaps``."""
    import numpy as np
    from pcdms_tpu_torch.eval.metrics import compare_ssim

    def scored(cands, gt):
        scores = sorted(compare_ssim(c.astype(np.float32) / 255.0,
                                     (gt + 1.0) / 2.0) for c in cands)
        gaps.append(scores[-1] - scores[-2])
        return best_of_n(cands, gt)
    return scored


def _check_selection(tag, host_files, dev_files, gaps):
    """--device_select must write the host selection's bytes, pair by pair,
    unless the host's best two candidates tie (SSIM gap under 1e-5)."""
    same = [a == b for a, b in zip(host_files, dev_files)]
    print(f"[{tag}] --device_select vs host selection: files identical "
          f"{same}; host best-vs-second SSIM gaps "
          f"{[f'{g:.2e}' for g in gaps]}", flush=True)
    for i, ok in enumerate(same):
        if not ok and gaps[i] >= 1e-5:
            fail(f"{tag}: --device_select chose another candidate than the "
                 f"host for pair {i} (SSIM gap {gaps[i]:.2e}, not a tie)")
        if not ok:
            print(f"[{tag}] pair {i}: an SSIM tie ({gaps[i]:.2e}) chose "
                  f"another candidate", flush=True)


def phase_batchtest(fa):
    """``cli/stage2_batchtest.main`` at full width with --random_init
    (DINOv2-giant, the SD-2.1 stage-2 UNet, the full VAE) on 2 synthetic
    512x512 pairs: test mode (UniPC 20 steps, best of 4, batch 2) with host
    and with device selection, then train mode (CLIP ViT-H) under
    PCDMS_SHORTKV=pallas. Returns the short-kv launches by head_dim."""
    import numpy as np
    from PIL import Image

    import pcdms_tpu_torch.pipelines.stage2_inpaint as pipeline
    from pcdms_tpu_torch.cli import stage2_batchtest as cli
    from pcdms_tpu_torch.utils.profiling import sync

    sampler_s, gaps = [], []
    generate, best_of_n = pipeline.stage2_generate, cli.best_of_n_ssim
    scored_best_of_n = _gap_recording(best_of_n, gaps)

    def timed_generate(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(*args, **kwargs)
        sync(out)
        sampler_s.append(time.perf_counter() - t0)
        return out

    def run(root, json_name, out, extra):
        sampler_s.clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        written = cli.main(["--json_path", os.path.join(root, json_name),
                            "--image_root_path", root, "--save_path", out,
                            "--random_init", "--batch_size", "2",
                            "--seed", str(SEED)] + extra)
        return (written, time.perf_counter() - t0, sum(sampler_s),
                torch.cuda.max_memory_allocated() / 2**30)

    pipeline.stage2_generate, cli.best_of_n_ssim = (timed_generate,
                                                    scored_best_of_n)
    try:
        with tempfile.TemporaryDirectory() as root:
            names = _batchtest_dataset(root)
            test = ["--prior_embeds_dir", os.path.join(root, "prior"),
                    "--num_inference_steps", "20", "--scheduler", "unipc",
                    "--num_images_per_prompt", "4"]
            host_dir, dev_dir = (os.path.join(root, d) for d in ("host",
                                                                 "dev"))
            files = {}
            for label, out, extra in (("host selection", host_dir, []),
                                      ("--device_select", dev_dir,
                                       ["--device_select"])):
                written, wall, samp, peak = run(root, "test_pairs.json", out,
                                                test + extra)
                imgs = [np.asarray(Image.open(p)) for p in written]
                files[label] = [open(p, "rb").read() for p in written]
                print(f"[batchtest] test mode, {label}: UniPC 20 steps, best "
                      f"of 4, 2 pairs at 512x512 (canvas 512x1024), batch 2:"
                      f" {wall:.2f} s in main, {samp / 2:.3f} s per pair in "
                      f"stage2_generate, peak {peak:.2f} GiB; wrote "
                      f"{[os.path.basename(p) for p in written]}, pixel std "
                      f"{[round(float(i.std()), 2) for i in imgs]}",
                      flush=True)
                if ([os.path.basename(p) for p in written] != names
                        or any(i.shape != (512, 512, 3) or i.std() == 0
                               for i in imgs)):
                    fail(f"batch test ({label}): expected one 512x512 "
                         f"non-constant PNG per pair")
            _check_selection("batchtest", *files.values(), gaps)

            os.environ["PCDMS_SHORTKV"] = "pallas"
            try:
                fa.reset_launches()
                written, wall, samp, peak = run(
                    root, "train_pairs.json", os.path.join(root, "train"),
                    ["--num_inference_steps", "2", "--scheduler", "ddim",
                     "--num_images_per_prompt", "2"])
                torch.cuda.synchronize()
                by_dim = dict(fa.SHORTKV_LAUNCHES)
            finally:
                os.environ.pop("PCDMS_SHORTKV")
            print(f"[batchtest] train mode (CLIP ViT-H target embeddings), "
                  f"PCDMS_SHORTKV=pallas, DDIM 2 steps, 2 per prompt: "
                  f"{wall:.2f} s in main, peak {peak:.2f} GiB; short-kv "
                  f"launches by head_dim {by_dim}", flush=True)
            if len(written) != 2 or not all(by_dim.values()):
                fail("train-mode batch test: expected 2 PNGs and short-kv "
                     "launches at head_dim 64 and 80")
    finally:
        pipeline.stage2_generate, cli.best_of_n_ssim = generate, best_of_n
    return by_dim


def phase_frozen(fa, shapes):
    """The bf16 frozen kernel vs its plain version at ``shapes`` ((B*H, Lq,
    Lk), head_dim 64), each timed by device time (``graph_ms``) beside
    SDPA's forward, the plain version by CUDA events, and the bound.
    Returns one record a shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    records = []
    for bh, lq, lk in shapes:
        q, k, v = (torch.randn((bh, n, 64), generator=gen, device=dev)
                   .to(torch.bfloat16) for n in (lq, lk, lk))
        got = fa.flash_frozen(q, k, v, 0.125)
        want = fa.flash_frozen_plain(q, k, v, 0.125)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        amax = want.float().abs().max().item()
        finite = bool(torch.isfinite(got).all())
        del got, want
        ms = graph_ms(lambda: fa.flash_frozen(q, k, v, 0.125))
        lib_ms = graph_ms(lambda: sdpa(q[None], k[None], v[None],
                                       scale=0.125))
        plain_ms = cuda_ms(lambda: fa.flash_frozen_plain(q, k, v, 0.125), 3,
                           1)
        b_ms, b_by = bound_ms(bh, lq, lk)
        line = (f"[frozen] bf16 bh={bh} lq={lq} lk={lk}: max_abs_err="
                f"{err:.3e} (bar {BAR_REL:g} x max|want| {amax:.3e}); device "
                f"ms (CUDA graph): kernel {ms:.4f} library {lib_ms:.4f}; "
                f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) = "
                f"{b_ms / ms:.1%} of the kernel's")
        print(line, flush=True)
        if not finite or not err <= BAR_REL * amax:
            fail(f"flash_frozen disagrees with its plain version: {line}")
        records.append(dict(shape=[bh, lq, lk], max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=lib_ms))
        del q, k, v
        torch.cuda.empty_cache()
    return records


def phase_stage3_kernels(fa, fc):
    """Kernels 1, 3 and 7 at the shapes the stage-3 UNet gives them at
    512x512: the frozen kernel at its four self-attention shapes, the
    short-kv kernel at Lk 257 / 256 / 64, the fused conv at the 14 conv
    shapes of the square levels (64x64 down to 8x8, an image narrower than
    the 16-pixel tile), each against its plain version and timed. Returns
    {kernel: records}."""
    return {
        "flash_frozen": phase_frozen(fa, STAGE3_PATH_SHAPES),
        "flash_shortkv": phase_shortkv(
            fa, [(*shape, 64) for shape in STAGE3_SHORTKV_SHAPES]),
        "fused_gn_silu_conv": phase_fused_conv(fc, STAGE3_CONV_SHAPES,
                                               "stage3", edges=False)}


def build_stage3_models(dev):
    """The stage-3 UNet (8 channels, SD-2.1 widths), the full VAE and the
    image projection, random weights from the seed, bf16."""
    from pcdms_tpu_torch.models.projections import ImageProjModel
    from pcdms_tpu_torch.models.unet2d import (
        UNet2DConditionModel, stage3_unet_config,
    )
    from pcdms_tpu_torch.models.vae import AutoencoderKL
    torch.manual_seed(SEED + 20)
    with torch.device(dev):
        models = {"unet": UNet2DConditionModel(stage3_unet_config()),
                  "vae": AutoencoderKL(), "image_proj": ImageProjModel()}
    return {k: m.to(torch.bfloat16).eval() for k, m in models.items()}


def _with_env(env):
    """Set ``env`` in os.environ; returns a function that restores it."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)

    def restore():
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return restore


def _step_timer(unet):
    """CUDA events around every forward of ``unet``: returns (the list of
    [start, end] event pairs, a function that removes the hooks)."""
    pairs = []

    def pre(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        pairs.append([ev])

    def post(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        pairs[-1].append(ev)

    hooks = [unet.register_forward_pre_hook(pre),
             unet.register_forward_hook(post)]
    return pairs, lambda: [h.remove() for h in hooks]


def phase_stage3(fa, models, dev):
    """The stage-3 UNet at full width (512x512: 64x64 latents, one image
    CFG-doubled to 2, bf16): eps through the kernels against plain attention
    (10 frozen launches), the same under PCDMS_SHORTKV=pallas (22 short-kv
    launches), and with every resnet conv fused against the unfused forward
    (44 launches); then ``stage3_generate`` (UniPC 3 steps, 4 samples,
    decode). Returns the launches of these runs, summed."""
    from pcdms_tpu_torch.pipelines.stage3_refine import stage3_generate
    unet = models["unet"]
    base = unet.cfg
    n_params = sum(p.numel() for p in unet.parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    sample, ctx = rand(2, 64, 64, 8), rand(2, 257, 1024)
    ctx[:1] = 0
    ts = torch.tensor([500, 500], device=dev)

    def forward():
        return unet(sample, ts, ctx, zero_ctx_prefix=1)

    def run(env=None, **changes):
        restore = _with_env(env or {})
        unet.cfg = dataclasses.replace(base, **changes)
        try:
            fa.reset_launches()
            with torch.inference_mode():
                eps = forward()
                torch.cuda.synchronize()
                counts = {n: c for n, c in fa.LAUNCHES.items() if c}
                by_dim = dict(fa.SHORTKV_LAUNCHES)
                ms = cuda_ms(forward, 3, 1)
        finally:
            unet.cfg = base
            restore()
        return eps, counts, ms, by_dim

    eps_k, l_k, ms_k, _ = run()
    eps_p, _, ms_p, _ = run(use_flash=False)
    eps_s, l_s, ms_s, by_dim = run({"PCDMS_SHORTKV": "pallas"})
    eps_f, l_f, ms_f, _ = run(fused_conv=True)
    checks = [
        ("kernels vs plain attention", eps_k, eps_p, BAR_UNET_REL_L2, l_k,
         {"flash_frozen": 10}, ms_k),
        ("PCDMS_SHORTKV=pallas vs plain attention", eps_s, eps_p,
         BAR_UNET_REL_L2, l_s, {"flash_frozen": 10, "flash_shortkv": 22},
         ms_s),
        ("fused_conv=True vs False", eps_f, eps_k, BAR_FUSED_UNET_REL_L2,
         l_f, {"flash_frozen": 10, "fused_gn_silu_conv": 44}, ms_f)]
    print(f"[stage3] UNet {n_params / 1e6:.1f}M parameters, 8 channels, "
          f"64x64 latents batch 2 bf16; forward ms (CUDA events, 3 calls): "
          f"plain attention {ms_p:.2f}", flush=True)
    for label, got, want, bar, counts, expect, ms in checks:
        rel = _rel_l2(got, want)
        print(f"[stage3] {label}: eps rel_l2 = {rel:.3e} (bar {bar:g}); "
              f"launches {counts}; forward_ms={ms:.2f}", flush=True)
        if not torch.isfinite(got).all() or not rel <= bar:
            fail(f"stage-3 UNet eps, {label}: above the bar")
        if counts != expect:
            fail(f"stage-3 UNet, {label}: expected launches {expect}, got "
                 f"{counts}")
    if by_dim[64] != 22:
        fail(f"expected 22 short-kv launches at head_dim 64, got {by_dim}")
    del eps_k, eps_p, eps_s, eps_f

    gen_image = torch.rand((1, 512, 512, 3), generator=gen,
                           device=dev) * 2 - 1
    dino = torch.randn((1, 257, 1536), generator=gen, device=dev)
    steps, samples = 3, 4
    pairs, unhook = _step_timer(unet)
    torch.cuda.reset_peak_memory_stats()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fa.reset_launches()
        images = stage3_generate(
            models, gen_image, dino,
            generator=torch.Generator(device=dev).manual_seed(SEED),
            num_steps=steps, scheduler="unipc", guidance_scale=2.0,
            num_samples=samples, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {n: c for n, c in fa.LAUNCHES.items() if c}
    finally:
        unhook()
    step_s = sum(a.elapsed_time(b) for a, b in pairs) / 1e3 / steps
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[stage3] stage3_generate UniPC-{steps} 512x512 1 image x "
          f"{samples} samples (UNet batch {2 * samples}) CFG 2.0 bf16: "
          f"{seconds:.2f} s total, {step_s:.4f} s per denoise step (UNet, "
          f"CUDA events), peak {peak:.2f} GiB, images min "
          f"{images.min().item():.3f} max {images.max().item():.3f}, "
          f"launches {counts}", flush=True)
    if (tuple(images.shape) != (samples, 512, 512, 3)
            or not torch.isfinite(images).all()):
        fail(f"stage3_generate: images not finite or of shape "
             f"{tuple(images.shape)}")
    if counts != {"flash_frozen": 10 * steps}:
        fail(f"stage3_generate: expected {10 * steps} frozen launches, got "
             f"{counts}")
    total = {}
    for c in (l_k, l_s, l_f, counts):
        _add(total, c)
    return total


def _add(total, counts):
    for name, c in counts.items():
        total[name] = total.get(name, 0) + c
    return total


def build_prior(dev):
    """The full PriorConfig() prior, random weights from the seed, f32."""
    from pcdms_tpu_torch.models.prior_transformer import PriorTransformer
    torch.manual_seed(SEED + 30)
    with torch.device(dev):
        return PriorTransformer().eval()


def phase_stage1(dev):
    """The stage-1 prior at the full PriorConfig() (20 layers, 32 heads of
    64, d 2048; f32 with TF32 off, random weights from the seed) through
    ``stage1_generate``: 20 UnCLIP steps at batch 2, finite, of shape (2,
    1024), the same bits for the same generator; one run profiled. Then the
    prior cut to 2 layers at full width on the card against the CPU
    (relative L2 within BAR_PRIOR_REL_L2): no kernel guards the prior's
    numerics. Returns the full prior."""
    import numpy as np
    from pcdms_tpu_torch.models.prior_transformer import (
        PriorConfig, PriorTransformer,
    )
    from pcdms_tpu_torch.pipelines.stage1_prior import stage1_generate
    prior = build_prior(dev)
    n_params = sum(p.numel() for p in prior.parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    s_embed = torch.randn((2, 1024), generator=gen, device=dev)
    s_pose, t_pose = (torch.rand((2, 36), generator=gen, device=dev)
                      for _ in range(2))

    def run():
        return stage1_generate(
            {"prior": prior}, s_embed, s_pose, t_pose,
            generator=torch.Generator(device=dev).manual_seed(SEED),
            num_steps=20, guidance_scale=0.0)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    second = run()
    peak = torch.cuda.max_memory_allocated() / 2**30
    same = torch.equal(first, second)
    print(f"[stage1] PriorConfig() {n_params / 1e6:.1f}M parameters f32: "
          f"stage1_generate 20 UnCLIP steps, batch 2: {seconds:.3f} s "
          f"({seconds / 20 * 1e3:.2f} ms per step), peak {peak:.2f} GiB; "
          f"shape {tuple(first.shape)}, std {first.std().item():.4f}, same "
          f"bits for the same generator: {same}", flush=True)
    if (tuple(first.shape) != (2, 1024) or not torch.isfinite(first).all()
            or not same):
        fail("stage1_generate at the full PriorConfig: not finite, not "
             "(2, 1024) or not deterministic")
    # where a step's time goes: the prior reads 4.1 GB of f32 weights a
    # step, 1.2 ms at the HBM rate
    profile_kernels(run, "stage1_generate, the full prior, 20 steps, "
                    "batch 2", top=6)

    cfg2 = dataclasses.replace(PriorConfig(), num_layers=2)
    torch.manual_seed(SEED + 32)
    cpu_prior = PriorTransformer(cfg2).eval()
    card_prior = copy.deepcopy(cpu_prior).to(dev)
    rng = np.random.default_rng(SEED + 33)
    inputs = [torch.from_numpy(a) for a in (
        rng.standard_normal((4, 1024)).astype(np.float32),
        rng.integers(0, 1000, 4).astype(np.int32),
        rng.standard_normal((4, 1024)).astype(np.float32),
        rng.uniform(0, 1, (2, 36)).astype(np.float32),
        rng.uniform(0, 1, (2, 36)).astype(np.float32))]
    with torch.inference_mode():
        want = cpu_prior(*inputs, cfg_zero_cond=True)
        got = card_prior(*(x.to(dev) for x in inputs),
                         cfg_zero_cond=True).cpu()
    rel = _rel_l2(got, want)
    print(f"[stage1] the prior cut to 2 layers at full width, f32, "
          f"cfg_zero_cond: card vs CPU rel_l2 = {rel:.3e} (bar "
          f"{BAR_PRIOR_REL_L2:g})", flush=True)
    if not torch.isfinite(got).all() or not rel <= BAR_PRIOR_REL_L2:
        fail("the prior on the card disagrees with the CPU")
    del cpu_prior, card_prior
    return prior


def phase_cascade(fa, prior, s2_models, s3_models, dev):
    """``cascade_generate`` at full width for one pair: the prior (f32, 20
    UnCLIP steps), stages 2 and 3 at UniPC 3 steps, CFG 2.0, bf16; the
    three outputs' shapes and finiteness, the frozen launches (15 per
    stage-2 and 10 per stage-3 step), seconds per stage. Returns the
    launches."""
    import pcdms_tpu_torch.pipelines.cascade as cascade
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    s_embed = torch.randn((1, 1024), generator=gen, device=dev)
    s_pose, t_pose = (torch.rand((1, 36), generator=gen, device=dev)
                      for _ in range(2))
    canvas = torch.rand((1, 512, 1024, 3), generator=gen, device=dev) * 2 - 1
    canvas[:, :, 512:] = -1.0
    pose = torch.rand((1, 512, 1024, 3), generator=gen, device=dev) * 2 - 1
    dino = torch.randn((1, 257, 1536), generator=gen, device=dev)
    names = ("stage1_generate", "stage2_generate", "stage3_generate")
    originals = {name: getattr(cascade, name) for name in names}
    stage_s = {}

    def timed(name):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](*args, **kwargs)
            torch.cuda.synchronize()
            stage_s[name] = time.perf_counter() - t0
            return out
        return run

    for name in names:
        setattr(cascade, name, timed(name))
    steps = 3
    try:
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t0 = time.perf_counter()
        out = cascade.cascade_generate(
            {"prior": prior}, s2_models, s3_models, s_embed, s_pose, t_pose,
            canvas, pose, dino,
            generator=torch.Generator(device=dev).manual_seed(SEED),
            prior_steps=20, inpaint_steps=steps, refine_steps=steps,
            guidance_scale=2.0, scheduler="unipc",
            compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {n: c for n, c in fa.LAUNCHES.items() if c}
    finally:
        for name in names:
            setattr(cascade, name, originals[name])
    peak = torch.cuda.max_memory_allocated() / 2**30
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    print(f"[cascade] cascade_generate, one pair: prior 20 steps f32, "
          f"stages 2 / 3 UniPC-{steps} CFG 2.0 bf16: {seconds:.2f} s total; "
          f"seconds per stage "
          + " ".join(f"{k.split('_')[0]}={v:.3f}" for k, v in
                     stage_s.items())
          + f"; peak {peak:.2f} GiB; shapes {shapes}; launches {counts}",
          flush=True)
    want = {"embeds": (1, 1024), "inpainted": (1, 512, 1024, 3),
            "refined": (1, 512, 512, 3)}
    if shapes != want or not all(torch.isfinite(v).all()
                                 for v in out.values()):
        fail(f"cascade_generate: expected finite outputs of shapes {want}")
    if counts != {"flash_frozen": 15 * steps + 10 * steps}:
        fail(f"cascade_generate: expected {25 * steps} frozen launches "
             f"(15 + 10 per step), got {counts}")
    return counts


def _unet_inputs(dev, b, seed):
    """A stage-2 UNet call at 64x128 latents, batch b, bf16: (sample, ts,
    ctx, labels, pose, zero_ctx_prefix) with the first half CFG-zeroed."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    sample, pose = rand(b, 64, 128, 9), rand(b, 64, 128, 320)
    ctx, labels = rand(b, 258, 1024), rand(b, 1024)
    zp = b // 2
    ctx[:zp] = 0
    labels[:zp] = 0
    return sample, torch.full((b,), 500, device=dev), ctx, labels, pose, zp


def _step_ms(fa, unet, dev, b):
    """A key step (time embedding, encode, decode), a decode-only step on
    cached features (time embedding, decode) and the full forward of the
    stage-2 UNet at batch b, ms by CUDA events around 3 calls each, in
    turns (full, key, decode-only, decode-only, key, full); the kernel-1
    launches of one decode-only step."""
    sample, ts, ctx, labels, pose, zp = _unet_inputs(dev, b, SEED + 52)

    def embed():
        return unet.time_embed(ts, labels, None, torch.bfloat16)

    def full():
        return unet(sample, ts, ctx, labels, pose, zero_ctx_prefix=zp)

    def key():
        e = embed()
        return unet.decode(*unet.encode(sample, e, ctx, pose, zp), e, ctx,
                           zp)

    with torch.inference_mode():
        cache = unet.encode(sample, embed(), ctx, pose, zp)

        def decode_only():
            return unet.decode(*cache, embed(), ctx, zp)

        fa.reset_launches()
        decode_only()
        torch.cuda.synchronize()
        counts = {n: c for n, c in fa.LAUNCHES.items() if c}
        ms = {"full": [], "key": [], "decode_only": []}
        for name, fn in (("full", full), ("key", key),
                         ("decode_only", decode_only),
                         ("decode_only", decode_only), ("key", key),
                         ("full", full)):
            ms[name].append(cuda_ms(fn, 3, 1))
    del cache
    torch.cuda.empty_cache()
    return ms, counts


def _w_conditioned_copy(unet, dev, cond_dim=256):
    """The stage-2 UNet's weights, cloned, in a w-conditioned UNet
    (``time_cond_proj_dim=cond_dim``) with a seeded random ``cond_proj``:
    a second module of its own, built on the meta device so that no third
    865M UNet is initialised."""
    from pcdms_tpu_torch.models.unet2d import UNet2DConditionModel
    with torch.device("meta"):
        unet_w = UNet2DConditionModel(dataclasses.replace(
            unet.cfg, time_cond_proj_dim=cond_dim))
    state = {k: v.clone() for k, v in unet.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)
    state["time_embedding.cond_proj.weight"] = (0.02 * torch.randn(
        (unet.cfg.block_out_channels[0], cond_dim), generator=gen,
        device=dev)).to(torch.bfloat16)
    unet_w.load_state_dict(state, assign=True)
    return unet_w.eval()


def _relaid(unet):
    """{resnet conv name: its weight's kept re-lay (key, tensor) or None}."""
    return {name: getattr(m.weight, "_pcdms_relaid", None)
            for name, m in unet.named_modules()
            if ".resnets." in name and name.endswith(("conv1", "conv2"))}


def phase_sampler_options(fa, models, s3_models, dev):
    """The sampler options at full width with random weights (stage 2:
    512x1024 canvas, one pair CFG-doubled to batch 2, bf16):
    a. encoder propagation in ``stage2_generate`` (DDIM 4 steps at interval
       2: 2 key and 2 decode-only steps) through the kernels against plain
       attention, with the fused convs and under PCDMS_SHORTKV=pallas,
       launches counted; interval 2 over 1 step gives interval 1's bits; a
       key step, a decode-only step and the full forward timed at UNet
       batch 2 and 16;
    b. ``stage3_generate`` at UniPC 3 steps and interval 2;
    c. ancestral DDIM (eta 0.5, 4 steps): the same bits for the same
       generator, not those of eta 0;
    d. FreeU on the stage-2 UNet forward (neutral against none, SD-2.1's
       values) and in ``stage2_generate``;
    e. LCM on a w-conditioned copy of the stage-2 UNet (4 steps with decode,
       no CFG doubling, the same bits twice), and its fused convs against
       its unfused ones, each conv with its own re-laid weight.
    Returns the launches of the runs through the kernels, summed."""
    from pcdms_tpu_torch.nn.layers import guidance_scale_embedding
    from pcdms_tpu_torch.pipelines.stage2_inpaint import stage2_generate
    from pcdms_tpu_torch.pipelines.stage3_refine import stage3_generate
    t_phase = time.perf_counter()
    unet = models["unet"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    canvas = torch.rand((1, 512, 1024, 3), generator=gen, device=dev) * 2 - 1
    canvas[:, :, 512:] = -1.0
    pose = torch.rand((1, 512, 1024, 3), generator=gen, device=dev) * 2 - 1
    dino = torch.randn((1, 257, 1536), generator=gen, device=dev)
    emb = torch.randn((1, 1, 1024), generator=gen, device=dev)
    total = {}

    def s2(mods=models, env=None, changes=None, **kw):
        """One ``stage2_generate`` run (DDIM 4 steps, latents, unless kw
        says otherwise): (output, launches, seconds, UNet forward ms per
        full-forward step by CUDA events, or 0.0 where none ran)."""
        target = mods["unet"]
        saved = target.cfg
        restore = _with_env(env or {})
        target.cfg = dataclasses.replace(saved, **(changes or {}))
        pairs, unhook = _step_timer(target)
        kw = dict(dict(scheduler="ddim", num_steps=4, decode=False), **kw)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fa.reset_launches()
            out = stage2_generate(
                mods, canvas, pose, dino, emb,
                generator=torch.Generator(device=dev).manual_seed(SEED),
                guidance_scale=2.0, compute_dtype=torch.bfloat16, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = {n: c for n, c in fa.LAUNCHES.items() if c}
        finally:
            unhook()
            target.cfg = saved
            restore()
        if counts:
            _add(total, counts)
        ms = (sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)
              if pairs else 0.0)
        return out, counts, seconds, ms

    def check(label, ok, counts=None, want=None):
        if not ok:
            fail(f"sampler options, {label}")
        if want is not None and counts != want:
            fail(f"sampler options, {label}: expected launches {want}, got "
                 f"{counts}")

    def cached(names, keys, decodes):
        return {k: FORWARD_LAUNCHES[k] * keys + DECODE_LAUNCHES[k] * decodes
                for k in names}

    # a. encoder propagation, DDIM 4 steps at interval 2
    exact, l_e, sec_e, ms_e = s2()
    lat_k, l_k, sec_k, _ = s2(encoder_cache_interval=2)
    lat_p, l_p, _, _ = s2(encoder_cache_interval=2,
                          changes=dict(use_flash=False))
    lat_f, l_f, sec_f, _ = s2(encoder_cache_interval=2,
                              changes=dict(fused_conv=True))
    lat_s, l_s, _, _ = s2(encoder_cache_interval=2,
                          env={"PCDMS_SHORTKV": "pallas"})
    one_c, _, _, _ = s2(num_steps=1, encoder_cache_interval=2)
    one_e, _, _, _ = s2(num_steps=1)
    rels = {"kernels vs plain attention": _rel_l2(lat_k, lat_p),
            "fused_conv vs unfused": _rel_l2(lat_f, lat_k),
            "PCDMS_SHORTKV=pallas vs plain attention": _rel_l2(lat_s, lat_p),
            "interval 2 vs 1 (the approximation)": _rel_l2(lat_k, exact)}
    print(f"[options] stage2_generate DDIM-4 at encoder_cache_interval 2 "
          f"(2 key + 2 decode-only steps), 512x1024 1 pair CFG 2.0 bf16, "
          f"final latents rel_l2: "
          + "; ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + f"; launches {l_k} / fused {l_f} / shortkv {l_s}; seconds "
          f"(4 steps, no decode) cached {sec_k:.3f} fused {sec_f:.3f} exact "
          f"{sec_e:.3f}; interval 2 over 1 step == interval 1: "
          f"{torch.equal(one_c, one_e)}", flush=True)
    check("cached latents not finite", all(
        torch.isfinite(x).all() for x in (lat_k, lat_p, lat_f, lat_s)))
    check("cached run through the kernels vs plain attention",
          rels["kernels vs plain attention"] <= BAR_UNET_REL_L2
          and rels["PCDMS_SHORTKV=pallas vs plain attention"]
          <= BAR_UNET_REL_L2
          and rels["fused_conv vs unfused"] <= BAR_FUSED_UNET_REL_L2)
    check("interval 2 over 1 step differs from interval 1",
          torch.equal(one_c, one_e))
    check("cached run", True, l_k, cached(["flash_frozen"], 2, 2))
    check("cached run under plain attention", True, l_p, {})
    check("cached fused run", True, l_f,
          cached(["flash_frozen", "fused_gn_silu_conv"], 2, 2))
    check("cached run under PCDMS_SHORTKV=pallas", True, l_s,
          cached(["flash_frozen", "flash_shortkv"], 2, 2))
    for b in (2, 16):
        ms, counts = _step_ms(fa, unet, dev, b)
        print(f"[options] stage-2 UNet batch {b} (64x128 latents, bf16), ms "
              f"by CUDA events (3 calls; full, key, decode-only, "
              f"decode-only, key, full): full "
              f"{ms['full'][0]:.2f} / {ms['full'][1]:.2f}, key "
              f"{ms['key'][0]:.2f} / {ms['key'][1]:.2f}, decode-only "
              f"{ms['decode_only'][0]:.2f} / {ms['decode_only'][1]:.2f} "
              f"(decode-only / full = "
              f"{sum(ms['decode_only']) / sum(ms['full']):.3f}); one "
              f"decode-only step launches {counts}", flush=True)
        check(f"decode-only step at batch {b}", True, counts,
              {"flash_frozen": DECODE_LAUNCHES["flash_frozen"]})

    # b. stage 3 at interval 2
    gen_image = torch.rand((1, 512, 512, 3), generator=gen,
                           device=dev) * 2 - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fa.reset_launches()
    images = stage3_generate(
        s3_models, gen_image, dino,
        generator=torch.Generator(device=dev).manual_seed(SEED),
        num_steps=3, scheduler="unipc", guidance_scale=2.0,
        encoder_cache_interval=2, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {n: c for n, c in fa.LAUNCHES.items() if c}
    _add(total, counts)
    print(f"[options] stage3_generate UniPC-3 at encoder_cache_interval 2 "
          f"(2 key + 1 decode-only), 512x512 1 image CFG 2.0 bf16, decode: "
          f"{seconds:.3f} s, launches {counts}, images min "
          f"{images.min().item():.3f} max {images.max().item():.3f}",
          flush=True)
    check("stage-3 images not finite or of another shape",
          tuple(images.shape) == (1, 512, 512, 3)
          and bool(torch.isfinite(images).all()), counts,
          {"flash_frozen": 2 * STAGE3_FORWARD_FROZEN + STAGE3_DECODE_FROZEN})

    # c. ancestral DDIM
    anc, l_a, sec_a, ms_a = s2(eta=0.5)
    anc2, _, _, _ = s2(eta=0.5)
    rel = _rel_l2(anc, exact)
    print(f"[options] stage2_generate DDIM-4 eta 0.5: {sec_a:.3f} s (no "
          f"decode), {ms_a:.2f} ms UNet per step (CUDA events; eta 0: "
          f"{ms_e:.2f}), same bits for the same generator: "
          f"{torch.equal(anc, anc2)}, rel_l2 to eta 0 {rel:.3e}; launches "
          f"{l_a}", flush=True)
    check("ancestral DDIM not finite, not deterministic or equal to eta 0",
          bool(torch.isfinite(anc).all()) and torch.equal(anc, anc2)
          and rel > 1e-3, l_a, {"flash_frozen": 4 * 15})

    # d. FreeU on the forward and in the sampler
    sample, ts, ctx, labels, upose, zp = _unet_inputs(dev, 2, SEED + 54)
    saved = unet.cfg

    def forward(freeu):
        unet.cfg = dataclasses.replace(saved, freeu=freeu)
        try:
            with torch.inference_mode():
                fa.reset_launches()
                eps = unet(sample, ts, ctx, labels, upose, zero_ctx_prefix=zp)
                torch.cuda.synchronize()
                counts = {n: c for n, c in fa.LAUNCHES.items() if c}
                ms = cuda_ms(lambda: unet(sample, ts, ctx, labels, upose,
                                          zero_ctx_prefix=zp), 3, 1)
        finally:
            unet.cfg = saved
        return eps, counts, ms

    eps_n, l_n, ms_n = forward(None)
    eps_1, _, ms_1 = forward((1.0, 1.0, 1.0, 1.0))
    eps_sd, l_sd, ms_sd = forward(SD21_FREEU)
    _add(total, l_sd)
    rel_1, rel_sd = _rel_l2(eps_1, eps_n), _rel_l2(eps_sd, eps_n)
    # the same weights and inputs in f32 (the f32 attention kernels)
    unet32 = copy.deepcopy(unet).float()
    args32 = [x.float() if x.is_floating_point() else x
              for x in (sample, ts, ctx, labels, upose)]
    eps32 = {}
    with torch.inference_mode():
        for freeu in (None, (1.0, 1.0, 1.0, 1.0), SD21_FREEU):
            unet32.cfg = dataclasses.replace(saved, freeu=freeu)
            eps32[freeu] = unet32(*args32, zero_ctx_prefix=zp)
    rel32_1 = _rel_l2(eps32[(1.0, 1.0, 1.0, 1.0)], eps32[None])
    rel32_sd = _rel_l2(eps32[SD21_FREEU], eps32[None])
    del unet32, eps32
    torch.cuda.empty_cache()
    lat_fr, l_fr, sec_fr, ms_fr = s2(changes=dict(freeu=SD21_FREEU))
    print(f"[options] FreeU on the stage-2 UNet forward (batch 2), eps "
          f"rel_l2 against none: neutral (1, 1, 1, 1) f32 {rel32_1:.3e} (bar "
          f"{BAR_FREEU_NEUTRAL_REL_L2:g}), bf16 {rel_1:.3e} (bar "
          f"{BAR_UNET_REL_L2:g}); SD-2.1's {SD21_FREEU} f32 {rel32_sd:.3e}, "
          f"bf16 {rel_sd:.3e}, launches {l_sd} (none: {l_n}); bf16 forward "
          f"ms (CUDA events, 3 calls) none {ms_n:.2f} neutral {ms_1:.2f} "
          f"SD-2.1 {ms_sd:.2f}; stage2_generate DDIM-4 with FreeU: "
          f"{sec_fr:.3f} s, {ms_fr:.2f} ms UNet per step, launches {l_fr}",
          flush=True)
    check("neutral FreeU vs none", rel32_1 <= BAR_FREEU_NEUTRAL_REL_L2
          and rel_1 <= BAR_UNET_REL_L2)
    check("SD-2.1 FreeU not finite or within the bar of none",
          bool(torch.isfinite(eps_sd).all())
          and rel32_sd > BAR_FREEU_NEUTRAL_REL_L2, l_sd, l_n)
    check("stage2_generate with FreeU", bool(torch.isfinite(lat_fr).all()),
          l_fr, {"flash_frozen": 4 * 15})
    del eps_n, eps_1, eps_sd

    # e. LCM on a w-conditioned copy of the stage-2 UNet
    unet_w = _w_conditioned_copy(unet, dev)
    models_w = dict(models, unet=unet_w)
    batches = []
    hook = unet_w.register_forward_pre_hook(
        lambda _, args: batches.append(args[0].shape[0]))
    try:
        lcm, l_lcm, sec_lcm, ms_lcm = s2(models_w, scheduler="lcm",
                                         decode=True)
        lcm2, _, _, _ = s2(models_w, scheduler="lcm", decode=True)
    finally:
        hook.remove()
    cond = guidance_scale_embedding(
        torch.full((1,), 2.0, device=dev), 256).to(torch.bfloat16)
    sample, ts, ctx, labels, upose, _ = _unet_inputs(dev, 1, SEED + 55)
    with torch.inference_mode():
        eps_u = unet_w(sample, ts, ctx, labels, upose, timestep_cond=cond)
        unet_w.cfg = dataclasses.replace(unet_w.cfg, fused_conv=True)
        fa.reset_launches()
        eps_f = unet_w(sample, ts, ctx, labels, upose, timestep_cond=cond)
        torch.cuda.synchronize()
        l_wf = {n: c for n, c in fa.LAUNCHES.items() if c}
    _add(total, l_wf)
    rel_w = _rel_l2(eps_f, eps_u)
    mine, theirs = _relaid(unet_w), _relaid(unet)
    own = all(kept is not None
              and kept[0][0] == unet_w.get_submodule(name)
              .weight.untyped_storage().data_ptr()
              and (theirs[name] is None
                   or kept[1].data_ptr() != theirs[name][1].data_ptr())
              for name, kept in mine.items())
    print(f"[options] LCM, w-conditioned stage-2 UNet (time_cond_proj_dim "
          f"256), 4 steps with decode, guidance 2.0 embedded: "
          f"{sec_lcm:.3f} s, {ms_lcm:.2f} ms UNet per step at UNet batches "
          f"{sorted(set(batches))}, same bits twice: "
          f"{torch.equal(lcm, lcm2)}, images min {lcm.min().item():.3f} max "
          f"{lcm.max().item():.3f}, launches {l_lcm}; its fused convs vs "
          f"unfused eps rel_l2 {rel_w:.3e} (bar {BAR_FUSED_UNET_REL_L2:g}), "
          f"launches {l_wf}, each conv its own re-lay: {own}", flush=True)
    check("LCM images not finite, of another shape or not deterministic",
          tuple(lcm.shape) == (1, 512, 1024, 3)
          and bool(torch.isfinite(lcm).all()) and torch.equal(lcm, lcm2)
          and batches == [1] * 8, l_lcm, {"flash_frozen": 4 * 15})
    check("the w-conditioned UNet's fused convs",
          bool(torch.isfinite(eps_f).all()) and rel_w <= BAR_FUSED_UNET_REL_L2
          and own, l_wf, {"flash_frozen": 15, "fused_gn_silu_conv": 44})
    del unet_w, models_w, eps_u, eps_f
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[options] phase_sampler_options: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def phase_protocol(fa, metric_weights):
    """The reference protocol chained through the disk at full width with
    --random_init, on 2 synthetic 512x512 pairs: ``cli/stage1_batchtest``
    (CLIP ViT-H and the prior, 20 steps) writes the .npy embeddings,
    ``cli/stage2_batchtest --prior_embeds_dir`` reads them (UniPC 20, best
    of 4), ``cli/stage3_batchtest --gen_dir`` refines stage 2's PNGs (UniPC
    20, best of 4) with host selection and with --device_select (the same
    files but for SSIM ties), and ``cli/calculate_metrics`` scores the
    host-selected PNGs against their GT at --resolution 512 with
    ``phase_metrics``'s weight files. Seconds per pair and peak GiB per
    CLI."""
    import numpy as np
    from PIL import Image

    from pcdms_tpu_torch.cli import (
        stage1_batchtest, stage2_batchtest, stage3_batchtest,
    )

    gaps, best_of_n = [], stage3_batchtest.best_of_n_ssim

    def run(label, cli, argv):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        written = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = {n: c for n, c in fa.LAUNCHES.items() if c}
        print(f"[protocol] {label}: 2 pairs, {wall:.2f} s in main = "
              f"{wall / 2:.2f} s per pair, peak {peak:.2f} GiB; wrote "
              f"{[os.path.basename(p) for p in written]}; launches {counts}",
              flush=True)
        return written

    stage3_batchtest.best_of_n_ssim = _gap_recording(best_of_n, gaps)
    try:
        with tempfile.TemporaryDirectory() as root:
            names = _batchtest_dataset(root)
            stems = [name.rsplit(".", 1)[0] for name in names]
            base = ["--json_path", os.path.join(root, "test_pairs.json"),
                    "--image_root_path", root, "--random_init",
                    "--batch_size", "2", "--seed", str(SEED),
                    "--num_inference_steps", "20"]
            dirs = {k: os.path.join(root, k) for k in ("s1", "s2", "host",
                                                       "dev")}
            written = run("stage1_batchtest (CLIP ViT-H, prior 20 steps)",
                          stage1_batchtest, base + ["--save_path",
                                                    dirs["s1"]])
            embeds = [np.load(p) for p in written]
            with open(os.path.join(dirs["s1"], "a_results.txt")) as f:
                cosine = float(f.read().split()[-1])
            print(f"[protocol] stage 1 mean cosine to the target CLIP "
                  f"embeddings (random weights): {cosine:.4f}", flush=True)
            if ([os.path.basename(p) for p in written]
                    != [f"{s}.npy" for s in stems]
                    or any(e.shape != (1, 1024) or not np.isfinite(e).all()
                           for e in embeds) or not math.isfinite(cosine)):
                fail("stage-1 batch test: expected one finite (1, 1024) "
                     ".npy per pair and a finite cosine")
            sample = ["--scheduler", "unipc", "--num_images_per_prompt", "4"]
            written = run("stage2_batchtest --prior_embeds_dir (UniPC 20, "
                          "best of 4)", stage2_batchtest,
                          base + sample + ["--save_path", dirs["s2"],
                                           "--prior_embeds_dir", dirs["s1"]])
            if [os.path.basename(p) for p in written] != names:
                fail("stage-2 batch test on stage 1's .npy: expected one "
                     "PNG per pair")
            files = {}
            for label, extra in (("host", []), ("dev", ["--device_select"])):
                written = run(f"stage3_batchtest --gen_dir ({label} "
                              f"selection, UniPC 20, best of 4)",
                              stage3_batchtest,
                              base + sample + extra + [
                                  "--save_path", dirs[label], "--gen_dir",
                                  dirs["s2"]])
                imgs = [np.asarray(Image.open(p)) for p in written]
                if ([os.path.basename(p) for p in written] != names
                        or any(i.shape != (512, 512, 3) or i.std() == 0
                               for i in imgs)):
                    fail(f"stage-3 batch test ({label}): expected one "
                         f"512x512 non-constant PNG per pair")
                files[label] = [open(p, "rb").read() for p in written]
            _check_selection("protocol", files["host"], files["dev"], gaps)
            gt = os.path.join(root, "train_all_png")
            run_metrics_cli(
                ["--fid_real_path", gt, "--test_path", gt,
                 "--generated_path", dirs["host"], "--resolution", "512",
                 "--save_name", os.path.join(root, "protocol"),
                 "--inception_weights", metric_weights["inception"],
                 "--lpips_weights", metric_weights["lpips"]],
                "protocol: stage 3's PNGs against their GT")
    finally:
        stage3_batchtest.best_of_n_ssim = best_of_n


# the reference files phase_weights writes, f32: the stage-2 UNet (865M
# parameters), the VAE (84M) and DINOv2-giant (1.1B) at 4 bytes each, and
# a margin of 15 %
WEIGHT_FILE_BYTES = 4 * (865e6 + 84e6 + 1137e6)
OLD_VAE_NAMES = {"to_q": "query", "to_k": "key", "to_v": "value",
                 "to_out.0": "proj_attn"}


def _f32_state_dict(module, prefix=""):
    return {prefix + k: v.detach().float().cpu()
            for k, v in module.state_dict().items()}


def _write_monolithic(path, models):
    """The UNet and the projections as the reference's monolithic
    checkpoint: a DeepSpeed ``module`` wrapper with ``unet.`` /
    ``pose_proj.`` / ``image_proj_model_p.`` keys, f32."""
    torch.save({"module": {
        **_f32_state_dict(models["unet"], "unet."),
        **_f32_state_dict(models["pose_proj"], "pose_proj."),
        **_f32_state_dict(models["image_proj"], "image_proj_model_p.")}},
        path)


def _write_reference_layouts(root, models, dino):
    """The stage-2 batch test's modules in the reference's layouts under
    ``root``: the monolithic checkpoint (``_write_monolithic``), an SD-2.1
    dir whose VAE carries the old mid-attention names, and an HF DINOv2 dir
    (with its ``mask_token``, at the module's 16 x 16 grid, so that the
    load-time resize is the identity). -> (the CLI's weight flags, bytes
    written)."""
    ckpt = os.path.join(root, "pcdms_stage2.pt")
    sd21, dino_dir = (os.path.join(root, d) for d in ("sd21", "dinov2"))
    os.makedirs(os.path.join(sd21, "vae"))
    os.makedirs(dino_dir)
    _write_monolithic(ckpt, models)
    vae = {}
    for k, v in _f32_state_dict(models["vae"]).items():
        for new, old in OLD_VAE_NAMES.items():
            k = k.replace(f"attentions.0.{new}.", f"attentions.0.{old}.")
        vae[k] = v
    torch.save(vae, os.path.join(sd21, "vae", "diffusion_pytorch_model.bin"))
    dino_sd = _f32_state_dict(dino)
    dino_sd["embeddings.mask_token"] = torch.zeros(
        1, dino_sd["embeddings.cls_token"].shape[-1])
    torch.save(dino_sd, os.path.join(dino_dir, "pytorch_model.bin"))
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, files in os.walk(root) for f in files
                 if f.endswith((".pt", ".bin")))
    return ["--weights_name", ckpt, "--pretrained_model_name_or_path", sd21,
            "--image_encoder_p_path", dino_dir], nbytes


def phase_weights(fa, dev, root):
    """Weight loading at full width: the stage-2 batch test's
    ``--random_init`` models (phase 9's seed: DINOv2-giant, the stage-2
    UNet, the VAE, the projections) saved in the reference's layouts as f32
    files under ``root`` (``_write_reference_layouts``), then
    ``cli/stage2_batchtest.main`` once with ``--random_init`` and once from
    the files (no ``--random_init``) on 2 pairs (UniPC 3 steps, 2 per
    prompt): the PNGs must be byte-identical. Prints the bytes written and
    the seconds the CLI's ``build_models`` takes each way. Fails, never
    skips, when the disk lacks room for the files. Returns (the launches of
    the two runs, the SD-2.1 and DINOv2 dirs as the demo's ``--sd`` /
    ``--dinov2`` and the bf16 VAE and DINOv2 they hold, for
    ``phase_demo``)."""
    import shutil

    from pcdms_tpu_torch.cli import stage2_batchtest as cli

    build, build_s = cli.build_models, []

    def timed_build(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = build(*args, **kwargs)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)
        return out

    free = shutil.disk_usage(root).free
    if free < 1.15 * WEIGHT_FILE_BYTES:
        fail(f"phase_weights needs {1.15 * WEIGHT_FILE_BYTES / 1e9:.1f} "
             f"GB free under {root}, has {free / 1e9:.1f} GB")
    names = _batchtest_dataset(root)
    base = ["--json_path", os.path.join(root, "test_pairs.json"),
            "--image_root_path", root, "--batch_size", "2", "--seed",
            str(SEED), "--num_inference_steps", "3", "--scheduler",
            "unipc", "--num_images_per_prompt", "2",
            "--prior_embeds_dir", os.path.join(root, "prior")]
    models, dino, _ = build(cli.parse_args(
        base + ["--save_path", root, "--random_init"]), False, dev)
    t0 = time.perf_counter()
    flags, nbytes = _write_reference_layouts(
        os.path.join(root, "weights"), models, dino)
    write_s = time.perf_counter() - t0
    flag = dict(zip(flags[::2], flags[1::2]))
    kept = {"--sd": flag["--pretrained_model_name_or_path"],
            "--dinov2": flag["--image_encoder_p_path"],
            "vae": models["vae"], "dino": dino}
    del models, dino
    gc.collect()
    torch.cuda.empty_cache()
    files, counts = {}, {}
    cli.build_models = timed_build
    try:
        for label, extra in (("random", ["--random_init"]),
                             ("loaded", flags)):
            fa.reset_launches()
            written = cli.main(base + extra + [
                "--save_path", os.path.join(root, label)])
            torch.cuda.synchronize()
            _add(counts, {n: c for n, c in fa.LAUNCHES.items() if c})
            files[label] = [open(p, "rb").read() for p in written]
            if [os.path.basename(p) for p in written] != names:
                fail(f"phase_weights ({label}): expected one PNG per "
                     f"pair")
    finally:
        cli.build_models = build
    same = files["random"] == files["loaded"]
    print(f"[weights] the stage-2 batch test's full-width models saved in "
          f"the reference layouts: {nbytes} bytes ({nbytes / 1e9:.2f} GB) "
          f"in {write_s:.2f} s; build_models {build_s[0]:.2f} s with "
          f"--random_init, {build_s[1]:.2f} s loading the files; PNGs "
          f"byte-identical: {same}; launches {counts}", flush=True)
    if not same:
        fail("the batch test from the loaded files wrote other PNGs than "
             "its --random_init run")
    return counts, kept


def card_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _serve_request(rng, embed_dim=1024):
    import numpy as np
    canvas = rng.uniform(-1, 1, (512, 1024, 3)).astype(np.float32)
    canvas[:, 512:] = -1.0
    return dict(vae_image=canvas,
                st_pose=rng.uniform(-1, 1, (512, 1024, 3)).astype(np.float32),
                dino_features=rng.standard_normal((257, 1536)).astype(
                    np.float32),
                embed=rng.standard_normal((embed_dim,)).astype(np.float32))


def _serve_client_request(port, req):
    """One ``cli/serve_client.main`` request at full width: ``req``'s
    canvases written as 512x512 PNGs (source, source pose, target pose),
    its DINOv2 features and embedding as ``.npy`` -> (the (512, 1024, 3)
    image received, seconds)."""
    import numpy as np
    from PIL import Image
    from pcdms_tpu_torch.cli import serve_client

    with tempfile.TemporaryDirectory() as root:
        def png(name, arr):
            path = os.path.join(root, f"{name}.png")
            Image.fromarray(np.clip(np.rint((arr + 1.0) * 127.5), 0, 255)
                            .astype(np.uint8)).save(path)
            return path

        def npy(name, arr):
            path = os.path.join(root, f"{name}.npy")
            np.save(path, arr)
            return path
        out = os.path.join(root, "serve_out.png")
        flags = ["--port", str(port), "--height", "512", "--width", "512",
                 "--seed", str(SEED), "--out", out,
                 "--source_image", png("source", req["vae_image"][:, :512]),
                 "--source_pose", png("source_pose", req["st_pose"][:, :512]),
                 "--target_pose", png("target_pose", req["st_pose"][:, 512:]),
                 "--dino_features", npy("dino", req["dino_features"]),
                 "--embed", npy("embed", req["embed"])]
        t0 = time.perf_counter()
        img = serve_client.main(flags)
        secs = time.perf_counter() - t0
        if np.asarray(Image.open(out)).shape != (512, 1024, 3):
            fail("serve client: no (512, 1024, 3) PNG written")
    return img, secs


def phase_serve(fa, dev):
    """The serving stack at full width. ``Stage2Service`` over the stage-2
    UNet, VAE and projections (bf16, a 512x1024 canvas, UniPC 3 steps,
    buckets 1 / 2 / 4, warmed) behind ``ServingServer`` on 127.0.0.1: 8
    concurrent HTTP requests (7 seeds, one request twice), then a request
    alone twice (bucket 1, the same bits) and packed with three others
    twice (bucket 4, the same bits; against bucket 1 within
    BAR_UNET_REL_L2); frozen launches = 15 x 3 per batch, warmup included.
    Then ``CascadeService`` (the full prior in f32 and stages 2 and 3 in
    bf16, every stage at 3 UniPC steps, the service's one step count, as the
    JAX service's; buckets 1 / 2): the same seed twice gives the same bits,
    and its ``inpainted`` image against ``Stage2Service`` given its
    ``embeds`` and seed. Last the serve CLI's deployment
    (``cli/serve.py::build_deployment``, random weights from the seed): a
    ``ShapeRouter`` over 512 and 256 per side sharing one set of bf16
    modules, a request to each at once (two engine threads launching
    together), HTTP 400 for another shape. Returns the launches."""
    import threading

    import numpy as np

    from pcdms_tpu_torch.cli import serve as serve_cli
    from pcdms_tpu_torch.serve.http import ServingServer, post_npz
    from pcdms_tpu_torch.serve.router import ShapeRouter
    from pcdms_tpu_torch.serve.stage2 import CascadeService, Stage2Service

    steps, card = 3, card_name_and_limit()
    models = build_models(dev)
    rng = np.random.default_rng(SEED + 70)
    reqs = [_serve_request(rng) for _ in range(7)]
    total = {}

    def frozen():
        return {n: c for n, c in fa.LAUNCHES.items() if c}

    fa.reset_launches()
    t0 = time.perf_counter()
    svc = Stage2Service(models, num_steps=steps, buckets=(1, 2, 4),
                        max_delay_ms=50.0, warmup=True)
    warm_s = time.perf_counter() - t0
    try:
        with ServingServer(svc, port=0, request_timeout_s=300) as server:
            outs, lats = [None] * 8, [0.0] * 8
            wave = [dict(r, seed=i) for i, r in enumerate(reqs)] + [
                dict(reqs[0], seed=0)]

            def call(i):
                t = time.perf_counter()
                outs[i] = post_npz("127.0.0.1", server.port, wave[i],
                                   timeout=300)["image"]
                lats[i] = time.perf_counter() - t

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(8)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            wall = time.perf_counter() - t0
            if any(th.is_alive() for th in threads) or any(
                    o is None or o.shape != (512, 1024, 3)
                    or not np.isfinite(o).all() for o in outs):
                fail("Stage2Service over HTTP: expected 8 finite (512, 1024, "
                     "3) images")
            repeat_rel = _rel_l2(torch.from_numpy(outs[7]),
                                 torch.from_numpy(outs[0]))
            wave_stats = svc.stats()

            def packed(seeds):
                futs = [svc.submit(**dict(reqs[i], seed=s))
                        for i, s in enumerate(seeds)]
                return [f.result(300) for f in futs]

            alone = [packed([0])[0] for _ in range(2)]
            four = [packed([0, 1, 2, 3])[0] for _ in range(2)]
            cross = _rel_l2(torch.from_numpy(four[0]),
                            torch.from_numpy(alone[0]))
            client, client_s = _serve_client_request(server.port, reqs[1])
    finally:
        svc.close()
    print(f"[serve] cli/serve_client.main: one full-width request from "
          f"512x512 PNGs and .npy features, {client_s:.2f} s, image "
          f"{client.shape}, finite {bool(np.isfinite(client).all())}",
          flush=True)
    if client.shape != (512, 1024, 3) or not np.isfinite(client).all():
        fail("serve client: expected a finite (512, 1024, 3) image")
    torch.cuda.synchronize()
    counts, st = frozen(), svc.stats()
    batches = st["batches"] + 3                   # and the warmup's buckets
    print(f"[serve] Stage2Service 512x1024 bf16 UniPC-{steps}, buckets "
          f"(1, 2, 4), warmup {warm_s:.2f} s; 8 concurrent HTTP requests in "
          f"{wall:.2f} s = {8 / wall:.3f} images/s (a smoke reading of 8 "
          f"requests, not a serving rate), latency per request s "
          f"{[round(x, 3) for x in lats]}; the repeated request vs its first "
          f"copy rel_l2 {repeat_rel:.3e}; the wave's counters {wave_stats}; "
          f"{card}", flush=True)
    print(f"[serve] a request alone twice: same bits {np.array_equal(*alone)}"
          f"; packed in bucket 4 twice: same bits {np.array_equal(*four)}; "
          f"bucket 4 vs bucket 1 rel_l2 {cross:.3e} (bar "
          f"{BAR_UNET_REL_L2:g}); counters {st}; launches {counts} over "
          f"{batches} batches (warmup included)", flush=True)
    if not (np.array_equal(*alone) and np.array_equal(*four)):
        fail("Stage2Service: the same request in the same bucket gave "
             "other bits")
    if not (cross <= BAR_UNET_REL_L2 and repeat_rel <= BAR_UNET_REL_L2):
        fail("Stage2Service: bucket 4 and bucket 1 disagree beyond the bar")
    if counts != {"flash_frozen": FORWARD_LAUNCHES["flash_frozen"] * steps
                  * batches}:
        fail(f"Stage2Service: expected {15 * steps} frozen launches per "
             f"batch over {batches} batches, got {counts}")
    _add(total, counts)

    prior = build_prior(dev)
    s3_models = build_stage3_models(dev)
    creq = dict(s_embed=rng.standard_normal(1024).astype(np.float32),
                s_pose=rng.uniform(0, 1, 36).astype(np.float32),
                t_pose=rng.uniform(0, 1, 36).astype(np.float32),
                vae_image=reqs[0]["vae_image"], st_pose=reqs[0]["st_pose"],
                dino_features=reqs[0]["dino_features"], seed=5)
    fa.reset_launches()
    t0 = time.perf_counter()
    casc = CascadeService({"prior": prior}, models, s3_models, steps=steps,
                          buckets=(1, 2), warmup=True)
    warm_s = time.perf_counter() - t0
    single = Stage2Service(models, num_steps=steps, buckets=(1,))
    try:
        t0 = time.perf_counter()
        outs = [casc.submit(**creq).result(300) for _ in range(2)]
        casc_s = (time.perf_counter() - t0) / 2
        img = single.submit(vae_image=creq["vae_image"],
                            st_pose=creq["st_pose"],
                            dino_features=creq["dino_features"],
                            embed=outs[0]["embeds"], seed=5).result(300)
    finally:
        casc.close()
        single.close()
    torch.cuda.synchronize()
    counts = frozen()
    shapes = {k: v.shape for k, v in outs[0].items()}
    same = all(np.array_equal(outs[0][k], outs[1][k]) for k in outs[0])
    port_rel = _rel_l2(torch.from_numpy(img),
                       torch.from_numpy(outs[0]["inpainted"]))
    print(f"[serve] CascadeService (prior f32, stages 2 / 3 bf16, all at "
          f"UniPC-{steps}), buckets (1, 2), warmup {warm_s:.2f} s: "
          f"{casc_s:.2f} s per request; shapes {shapes}; the same seed "
          f"twice, same bits: {same}; its inpainted vs Stage2Service given "
          f"its embeds and seed rel_l2 {port_rel:.3e}; counters "
          f"{casc.stats()}; launches {counts}", flush=True)
    want = {"embeds": (1024,), "inpainted": (512, 1024, 3),
            "refined": (512, 512, 3)}
    if shapes != want or not same or not all(
            np.isfinite(v).all() for v in outs[0].values()):
        fail(f"CascadeService: expected the same finite outputs of shapes "
             f"{want} for the same seed")
    if not port_rel <= BAR_UNET_REL_L2:
        fail("CascadeService and Stage2Service disagree for one seed")
    per_batch = FORWARD_LAUNCHES["flash_frozen"] + STAGE3_FORWARD_FROZEN
    want = per_batch * steps * (casc.stats()["batches"] + 2) + (
        FORWARD_LAUNCHES["flash_frozen"] * steps)
    if counts != {"flash_frozen": want}:
        fail(f"CascadeService: expected {want} frozen launches (25 per step "
             f"of a batch, warmup included, and 15 per step of the stage-2 "
             f"request), got {counts}")
    _add(total, counts)

    del s3_models, prior
    gc.collect()
    # the serve CLI's deployment, as ``pcdms-torch-serve`` builds it: full
    # width, modules loaded once in bf16 and shared by both canvases
    fa.reset_launches()
    router = serve_cli.build_deployment(serve_cli.parse_args([
        "--model", "stage2", "--random_init", "--seed", str(SEED),
        "--canvas", "512", "512", "--canvas", "256", "256",
        "--num_inference_steps", str(steps), "--buckets", "1"]))
    try:
        services = [router._by_canvas[c] for c in router.canvases] if (
            isinstance(router, ShapeRouter)) else []
        shared = len(services) == 2 and all(
            services[0]._models[k] is services[1]._models[k]
            for k in services[0]._models)
        dtypes = {p.dtype for svc in services
                  for p in svc._models["unet"].parameters()}
        if not shared or dtypes != {torch.bfloat16}:
            fail(f"serve CLI: expected a ShapeRouter over two canvases "
                 f"sharing one set of bf16 modules, got {type(router)} "
                 f"over {len(services)} services, shared {shared}, unet "
                 f"dtypes {dtypes}")
        with ServingServer(router, port=0, request_timeout_s=300) as server:
            small = dict(reqs[1], seed=1)
            small.update({k: np.ascontiguousarray(small[k][::2, ::2])
                          for k in ("vae_image", "st_pose")})
            got = [None, None]

            def routed(i, r):
                got[i] = post_npz("127.0.0.1", server.port, r,
                                  timeout=300)["image"]

            # the two engines launch at once, each from its own thread
            threads = [threading.Thread(target=routed, args=(i, r))
                       for i, r in enumerate((dict(reqs[0], seed=0), small))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            if any(g is None for g in got):
                fail("ShapeRouter: a request got no image")
            try:
                post_npz("127.0.0.1", server.port,
                         dict(small, vae_image=small["vae_image"][:, :384]),
                         timeout=300)
                refused = None
            except RuntimeError as e:
                refused = str(e)[:60]
    finally:
        router.close()
    torch.cuda.synchronize()
    counts = frozen()
    print(f"[serve] serve CLI's ShapeRouter (build_deployment, --canvas 512 "
          f"512 --canvas 256 256, one set of bf16 modules, warmed), a request "
          f"to each at once: shapes {[g.shape for g in got]}; another shape: "
          f"{refused}; counters {router.stats()}; launches {counts}",
          flush=True)
    if ([g.shape for g in got] != [(512, 1024, 3), (256, 512, 3)]
            or refused is None or "HTTP 400" not in refused):
        fail("ShapeRouter: expected one image per canvas and HTTP 400 for "
             "another shape")
    _add(total, counts)
    del models, router, services
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# data parallelism, LCM distillation and data-parallel serving
# ---------------------------------------------------------------------------

# the data-parallel phase: full-width stage-2 steps (512x1024 canvas, one
# row per rank, remat, bf16 on f32 weights) of a world of 2 gloo ranks on
# the one card against a world of 1 on the 2-row global batch with the same
# draws. Both run bf16 and differ where batch 1 and batch 2 are tiled and
# rounded differently: the loss and the gradient's global norm within 1e-2
# (relative), the whole reduced gradient within a relative L2 of 5e-3.
DP_STEPS, BAR_DP_REL, BAR_DP_GRAD_REL_L2 = 2, 1e-2, 5e-3
# launches of kernels 4-6 in one full-width stage-2 step with remat
DP_LAUNCHES = {"flash_fwd_lse": 30, "flash_dq": 15, "flash_dkv": 15}
# the LCM phase: launches of kernels 1 and 4-6 in one distillation step
# with remat (the teacher's CFG-doubled forward and the target's, 15 frozen
# each; the student's forward and its recompute, 15 LSE each; its backward)
LCM_STEPS = 4
LCM_LAUNCHES = {"flash_frozen": 30, "flash_fwd_lse": 30, "flash_dq": 15,
                "flash_dkv": 15}


def _dp_train(mesh, rows, steps=DP_STEPS, zero1=False, probe=False,
              grads_queue=None, on_probe=None):
    """The stage-2 trainer's models, loss and synthetic batches at full
    width (``rows`` global rows) on ``mesh`` (None: a world of 1). With
    ``probe`` (on every rank: it is collective) first the reduced gradient
    of step 0's batch and draws, held against the one that ``grads_queue``
    gives (relative L2) when given, else handed to ``on_probe``, if any.
    Then ``run_training`` for ``steps`` steps. Returns a record of the
    run."""
    from pcdms_tpu_torch.cli import stage2_train as cli
    from pcdms_tpu_torch.cli.common import train_config_from_args
    from pcdms_tpu_torch.data.loader import prefetch_to_device
    from pcdms_tpu_torch.parallel.dryrun import optimizer_bytes
    from pcdms_tpu_torch.parallel.mesh import all_reduce_mean
    from pcdms_tpu_torch.train.loop import run_training, step_generator
    from pcdms_tpu_torch.train.stage2 import stage2_loss_fn

    world = 1 if mesh is None else mesh.world
    args = cli.parse_args([
        "--output_dir", "unused", "--random_init", "--synthetic_data",
        "--img_height", "512", "--img_width", "512", "--train_batch_size",
        str(rows // world), "--learning_rate", "1e-4", "--lr_warmup_steps",
        "1", "--mixed_precision", "bf16", "--gradient_checkpointing",
        "--seed", str(SEED)] + (["--zero1"] if zero1 else []))
    dev = torch.device("cuda") if mesh is None else mesh.device
    _, trainable, vae, _, _, aux = cli.build_models(args, dev)
    loss_fn = stage2_loss_fn(vae, compute_dtype=torch.bfloat16, mesh=mesh)
    rec = {"rank": 0 if mesh is None else mesh.rank, "grad_rel_l2": None}
    if probe:
        batch = next(prefetch_to_device(cli.synthetic_batches(
            args, aux, mesh), dev))
        loss, _ = loss_fn(trainable, batch, step_generator(SEED, 0, dev))
        loss.backward()
        params = [p for m in trainable.values() for p in m.parameters()]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        all_reduce_mean(grads, mesh)
        if grads_queue is not None:
            diff2 = ref2 = 0.0
            for g, r in zip(grads, grads_queue.get()):
                diff2 += float(torch.sum(torch.square(g - r)))
                ref2 += float(torch.sum(torch.square(r)))
            rec["grad_rel_l2"] = math.sqrt(diff2 / ref2)
        elif on_probe is not None:
            on_probe([g.detach().clone() for g in grads])
        for p in params:
            p.grad = None
        del grads, batch, loss, params
    rows_out = []

    def on_step(step, m):
        rows_out.append((m["loss"].item(), m["grad_norm"].item(),
                         time.perf_counter()))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = run_training(loss_fn, trainable, cli.synthetic_batches(
        args, aux, mesh), train_config_from_args(args), mesh=mesh,
        device=dev, seed=SEED, max_train_steps=steps, log_every=1000,
        on_step=on_step)
    torch.cuda.synchronize()
    ends = [t0] + [r[2] for r in rows_out]
    rec.update(loss=[r[0] for r in rows_out],
               grad_norm=[r[1] for r in rows_out],
               s_per_step=[b - a for a, b in zip(ends, ends[1:])],
               zero1=state.zero1, opt_bytes=optimizer_bytes(state),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del state, trainable, vae, loss_fn
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _dp_rank(rank, world, workdir, grads_queue):
    """One gloo rank of ``phase_data_parallel`` on cuda:0; rank 0 holds its
    reduced gradient of step 0 against the world of 1's, which
    ``grads_queue`` hands over from the parent's memory on the card (CUDA
    IPC)."""
    import torch.distributed as dist

    from pcdms_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=world)
    try:
        mesh = make_mesh("cuda")
        rec = _dp_train(mesh, world, zero1=True, probe=True,
                        grads_queue=grads_queue if rank == 0 else None)
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def phase_data_parallel(fa, dev):
    """Data-parallel training at full width (``parallel/mesh.py``,
    ``train/common.py`` over a mesh with ZeRO-1). Two gloo ranks share
    cuda:0 (NCCL refuses two ranks on one device) and take 2 stage-2 steps
    with ZeRO-1 at one row each; a world of 1 takes the same 2 steps on the
    2-row global batch with the same draws. Per step the loss and the
    reduced gradient's norm, and the whole reduced gradient of step 0, held
    against the world of 1 (whose step-0 gradient rank 0 reads from this
    process's memory on the card); each rank's peak memory and optimizer
    bytes (about half of the world of 1's). Then one step of a world of 1
    through the nccl backend with ZeRO-1, so that the NCCL code path runs
    on the card. The ranks run while this process takes its world-1 steps
    and the NCCL one, so every time here is a smoke reading: the processes
    share one card, and gloo moves the gradients through the host. Returns
    the launches of the world-1 runs in this process."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from pcdms_tpu_torch.parallel.mesh import make_mesh
    gc.collect()
    torch.cuda.empty_cache()
    card = card_name_and_limit()
    shared = []                 # kept alive until the ranks are done
    with tempfile.TemporaryDirectory() as tmp:
        queue = mp.get_context("spawn").SimpleQueue()
        t0 = time.perf_counter()
        ctx = mp.start_processes(_dp_rank, args=(2, tmp, queue), nprocs=2,
                                 start_method="spawn", join=False)

        def share(grads):
            shared.append(grads)
            queue.put(grads)

        fa.reset_launches()
        one = _dp_train(None, 2, probe=True, on_probe=share)
        torch.cuda.synchronize()
        counts = {n: c for n, c in fa.LAUNCHES.items() if c}
        nccl, nccl_counts, backend = _dp_nccl_step(fa, make_mesh, dist)
        while not ctx.join():
            pass
        spawn_s = time.perf_counter() - t0
        shared.clear()
        torch.cuda.ipc_collect()
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    gc.collect()
    torch.cuda.empty_cache()
    for rec in ranks:
        print(f"[data_parallel] gloo rank {rec['rank']} of 2 on one card "
              f"({card}; a shared-card smoke reading, not a multi-card "
              f"speed), ZeRO-1 {rec['zero1']}: loss {rec['loss']} grad_norm "
              f"{rec['grad_norm']} s/step "
              f"{[round(s, 3) for s in rec['s_per_step']]}, peak "
              f"{rec['peak_gib']:.2f} GiB, optimizer state "
              f"{rec['opt_bytes'] / 2**30:.3f} GiB", flush=True)
    print(f"[data_parallel] world of 1 on the 2-row batch ({card}): loss "
          f"{one['loss']} grad_norm {one['grad_norm']} s/step "
          f"{[round(s, 3) for s in one['s_per_step']]}, peak "
          f"{one['peak_gib']:.2f} GiB (with the 3.5 GB step-0 gradient it "
          f"keeps for rank 0), optimizer state "
          f"{one['opt_bytes'] / 2**30:.3f} GiB; step-0 reduced gradient, "
          f"world 2 vs 1: rel L2 {ranks[0]['grad_rel_l2']:.3e}; the two "
          f"ranks' processes took {spawn_s:.1f} s beside it; launches "
          f"{counts}", flush=True)
    want = {k: v * (DP_STEPS + 1) for k, v in DP_LAUNCHES.items()}
    if counts != want:
        fail(f"data parallel: expected world-1 launches {want}, got "
             f"{counts}")
    for rec in ranks:
        for key in ("loss", "grad_norm"):
            got, ref = rec[key], one[key]
            if len(got) != DP_STEPS or not all(
                    math.isfinite(g) and abs(g - w) <= BAR_DP_REL * abs(w)
                    for g, w in zip(got, ref)):
                fail(f"data parallel: rank {rec['rank']} {key} {got} vs "
                     f"world 1 {ref} beyond rel {BAR_DP_REL}")
        if not rec["zero1"] or not (
                0.4 * one["opt_bytes"] <= rec["opt_bytes"]
                <= 0.6 * one["opt_bytes"]):
            fail(f"data parallel: rank {rec['rank']} holds "
                 f"{rec['opt_bytes']} optimizer bytes, not about half of "
                 f"{one['opt_bytes']}")
    if sum(r["opt_bytes"] for r in ranks) != one["opt_bytes"]:
        fail("data parallel: the ZeRO-1 shards do not add up to the state")
    if not ranks[0]["grad_rel_l2"] <= BAR_DP_GRAD_REL_L2:
        fail(f"data parallel: reduced gradient rel L2 "
             f"{ranks[0]['grad_rel_l2']:.3e} > {BAR_DP_GRAD_REL_L2}")

    print(f"[data_parallel] one step of a world of 1 on {backend} with "
          f"ZeRO-1 {nccl['zero1']}: loss {nccl['loss']} grad_norm "
          f"{nccl['grad_norm']} (world-1 step 1: {one['loss'][0]}), "
          f"{nccl['s_per_step'][0]:.3f} s; launches {nccl_counts}",
          flush=True)
    if (backend != "nccl" or not nccl["zero1"] or nccl_counts != DP_LAUNCHES
            or abs(nccl["loss"][0] - one["loss"][0])
            > BAR_DP_REL * abs(one["loss"][0])):
        fail("data parallel: the NCCL step did not match the world-1 step")
    return _add(counts, nccl_counts)


def _dp_nccl_step(fa, make_mesh, dist):
    """One full-width step of a world of 1 whose all-reduces and ZeRO-1
    run on NCCL: (record, launches, backend)."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=0, world_size=1)
        try:
            mesh = make_mesh("cuda")
            fa.reset_launches()
            rec = _dp_train(mesh, 2, steps=1, zero1=True)
            torch.cuda.synchronize()
            counts = {n: c for n, c in fa.LAUNCHES.items() if c}
            return rec, counts, dist.get_backend()
        finally:
            dist.destroy_process_group()


def phase_lcm(fa, dev):
    """LCM distillation at full width through ``cli/lcm_distill.main``
    (random teacher from the seed, synthetic batches, 512x1024 canvas,
    batch 2, bf16 on f32 weights, remat, 4 steps, the profile window of
    its ``--profile_dir``: step 4). Before the first update the student's
    eps against the teacher's conditional eps (the student starts as the
    teacher, its w-projection at zero); per step 30 frozen launches (the
    teacher's CFG-doubled forward and the target's), 30 LSE (the student
    and its recompute) and 15 of each backward kernel; seconds per step, the
    device-busy share of the window, peak memory. Then 4 LCM steps of
    ``stage2_generate`` from the distilled student. Returns the launches of
    the training run."""
    import numpy as np

    from pcdms_tpu_torch.cli import lcm_distill as lcm_cli
    from pcdms_tpu_torch.nn.layers import guidance_scale_embedding
    from pcdms_tpu_torch.pipelines.stage2_inpaint import stage2_generate
    from pcdms_tpu_torch.train import checkpoint, loop
    from pcdms_tpu_torch.utils.tree import cast_tree

    gc.collect()
    torch.cuda.empty_cache()
    card = card_name_and_limit()
    kept, rows = {}, []
    build = lcm_cli.build_models

    def build_and_check(args, device):
        teacher, student, vae, clip, dino, aux = build(args, device)
        gen = torch.Generator(device=device).manual_seed(SEED + 90)
        b, bf = 2, torch.bfloat16
        x = torch.randn((b, 64, 128, 9), generator=gen, device=device)
        ctx = torch.randn((b, 258, 1024), generator=gen, device=device)
        cl = torch.randn((b, 1024), generator=gen, device=device)
        pose = torch.randn((b, 64, 128, 320), generator=gen, device=device)
        ts = torch.tensor([999, 259], device=device)
        w = guidance_scale_embedding(torch.tensor([1.5, 3.7], device=device),
                                     args.time_cond_proj_dim).to(bf)
        with torch.no_grad():
            want = cast_tree(teacher["unet"], bf)(
                x.to(bf), ts, ctx.to(bf), class_labels=cl.to(bf),
                pose_cond=pose.to(bf)).float()
            got = cast_tree(student["unet"], bf)(
                x.to(bf), ts, ctx.to(bf), class_labels=cl.to(bf),
                pose_cond=pose.to(bf), timestep_cond=w).float()
        kept["eps_rel_l2"] = _rel_l2(got, want)
        kept["vae"] = vae
        del got, want, x, ctx, pose
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        return teacher, student, vae, clip, dino, aux

    run = loop.run_training

    def timed_run(*a, **kw):
        def on_step(step, m):
            rows.append((m["loss"].item(), time.perf_counter()))
        kept["t0"] = time.perf_counter()
        return run(*a, on_step=on_step, **kw)

    # the final checkpoint (the student and its moments, 10.4 GB) is noted,
    # not written: phase_train_data writes and resumes one at full width
    saves, save = [], checkpoint.save_checkpoint
    checkpoint.save_checkpoint = lambda d, step, *a, **kw: saves.append(step)
    lcm_cli.build_models, loop.run_training = build_and_check, timed_run
    try:
        with tempfile.TemporaryDirectory() as tmp:
            state = lcm_cli.main([
                "--output_dir", os.path.join(tmp, "out"), "--random_init",
                "--synthetic_data", "--img_height", "512", "--img_width",
                "512", "--train_batch_size", "2", "--max_train_steps",
                str(LCM_STEPS), "--checkpointing_steps", "100000",
                "--learning_rate", "1e-4", "--lr_warmup_steps", "1",
                "--mixed_precision", "bf16", "--gradient_checkpointing",
                "--seed", str(SEED), "--profile_dir",
                os.path.join(tmp, "prof"), "--log_every", "1000"])
            torch.cuda.synchronize()
            counts = {n: c for n, c in fa.LAUNCHES.items() if c}
            peak = torch.cuda.max_memory_allocated() / 2**30
            with open(os.path.join(tmp, "prof", "trace.json")) as f:
                events = json.load(f)["traceEvents"]
    finally:
        lcm_cli.build_models, loop.run_training = build, run
        checkpoint.save_checkpoint = save
    by_name, busy, window, n_kernels = _kernel_times(events)
    ends = [kept["t0"]] + [r[1] for r in rows]
    times = [b - a for a, b in zip(ends, ends[1:])]
    losses = [r[0] for r in rows]
    print(f"[lcm] student vs teacher eps before the first update (w 1.5 / "
          f"3.7, bf16): rel L2 {kept['eps_rel_l2']:.3e}", flush=True)
    print(f"[lcm] cli/lcm_distill.main at full width ({card}): 512x1024, "
          f"batch 2, bf16, remat, {LCM_STEPS} steps: losses "
          f"{[round(x, 6) for x in losses]}, s/step "
          f"{[round(t, 3) for t in times]} (step 4 under the profiler), "
          f"peak {peak:.2f} GiB; profile window of step 4: {n_kernels} "
          f"kernels, {window:.1f} ms, device busy {busy / window:.1%}; "
          f"launches {counts}", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[lcm]   {us / 1e3:9.2f} ms  {name[:100]}", flush=True)
    if not kept["eps_rel_l2"] <= BAR_UNET_REL_L2:
        fail(f"lcm: the student's eps is not the teacher's "
             f"({kept['eps_rel_l2']:.3e})")
    want = {k: v * LCM_STEPS for k, v in LCM_LAUNCHES.items()}
    if counts != want:
        fail(f"lcm: expected launches {want}, got {counts}")
    if len(losses) != LCM_STEPS or not all(map(math.isfinite, losses)):
        fail(f"lcm: expected {LCM_STEPS} finite losses, got {losses}")
    if saves != [LCM_STEPS]:
        fail(f"lcm: expected one checkpoint at step {LCM_STEPS}, got {saves}")

    # 4 LCM steps from the distilled student (no CFG doubling)
    models = dict(state.models, vae=kept.pop("vae"))
    rng = np.random.default_rng(SEED + 91)
    req = _serve_request(rng)
    t0 = time.perf_counter()
    img = stage2_generate(
        models, req["vae_image"][None], req["st_pose"][None],
        req["dino_features"][None], req["embed"][None, None],
        torch.Generator(device=dev).manual_seed(SEED), num_steps=4,
        scheduler="lcm", guidance_scale=2.0, device=dev)
    torch.cuda.synchronize()
    print(f"[lcm] stage2_generate with the distilled student, LCM 4 steps: "
          f"{img.shape} in {time.perf_counter() - t0:.2f} s, finite "
          f"{bool(torch.isfinite(img).all())}", flush=True)
    if tuple(img.shape) != (1, 512, 1024, 3) or not torch.isfinite(img).all():
        fail("lcm: the distilled student's sample is not a finite image")
    del state, models, img
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _burst(svc, reqs):
    """Images per second of ``svc`` for ``reqs`` submitted at once."""
    t0 = time.perf_counter()
    futs = [svc.submit(**r) for r in reqs]
    for f in futs:
        f.result(300)
    return len(reqs) / (time.perf_counter() - t0)


def phase_serve_dp(fa, dev):
    """Data-parallel serving at 512x1024, UniPC 3 steps:
    ``Stage2Service(mesh=[cuda:0])`` (one replica, the modules shared)
    against ``mesh=None``, buckets 1 / 2, each of 3 requests the same bits;
    then ``mesh=[cuda:0, cuda:0]`` at bucket 2 (two replicas sharing the
    card and the modules: the row split and the join run), each request
    against ``mesh=None`` at bucket 1, the same bits. Last, images/s for a
    burst of 6 requests, one replica at bucket 1 against two at bucket 2:
    one card does the same rows either way, so this reads the cost of the
    split and the join, not a multi-card speed. Returns the launches."""
    import numpy as np

    from pcdms_tpu_torch.serve.stage2 import Stage2Service

    steps = 3
    models = build_models(dev)
    rng = np.random.default_rng(SEED + 95)
    reqs = [dict(_serve_request(rng), seed=i) for i in range(3)]
    outs = {}
    fa.reset_launches()
    for label, mesh, buckets in (("mesh=None", None, (1, 2)),
                                 ("mesh=[cuda:0]", [dev], (1, 2)),
                                 ("mesh=[cuda:0, cuda:0]", [dev, dev], (2,))):
        with Stage2Service(models, num_steps=steps, buckets=buckets,
                           mesh=mesh) as svc:
            t0 = time.perf_counter()
            outs[label] = [svc.submit(**r).result(300) for r in reqs]
            secs = (time.perf_counter() - t0) / len(reqs)
        print(f"[serve_dp] Stage2Service {label}, buckets {buckets}: "
              f"{secs:.2f} s per request (one at a time, UniPC {steps})",
              flush=True)
    torch.cuda.synchronize()
    counts = {n: c for n, c in fa.LAUNCHES.items() if c}
    want_outs = outs.pop("mesh=None")
    same = {k: all(np.array_equal(a, b) for a, b in zip(v, want_outs))
            for k, v in outs.items()}
    print(f"[serve_dp] against mesh=None, 3 requests: the same bits "
          f"{same}; launches {counts}", flush=True)
    if not all(same.values()):
        fail("serve_dp: the data-parallel service changed an output")
    # mesh=None and [cuda:0]: one forward set per request and step; two
    # replicas: one each, the second on the bucket's padding row
    want = {"flash_frozen": FORWARD_LAUNCHES["flash_frozen"] * steps * 4
            * len(reqs)}
    if counts != want:
        fail(f"serve_dp: expected launches {want}, got {counts}")
    burst = [dict(_serve_request(rng), seed=10 + i) for i in range(6)]
    rates = {}
    for label, mesh, buckets in (("one replica, bucket 1", [dev], (1,)),
                                 ("two replicas, bucket 2", [dev, dev],
                                  (2,))):
        with Stage2Service(models, num_steps=steps, buckets=buckets,
                           mesh=mesh) as svc:
            svc.submit(**burst[0]).result(300)
            rates[label] = _burst(svc, burst)
    print(f"[serve_dp] a burst of 6 requests on one card "
          f"({card_name_and_limit()}; a shared-card reading, not a "
          f"multi-card speed): images/s "
          f"{ {k: round(v, 3) for k, v in rates.items()} }", flush=True)
    del models
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the metrics protocol and the learning proof (fifteenth slice)
# ---------------------------------------------------------------------------

# card vs CPU, f32 with TF32 off: pool3 features (relative L2) and LPIPS
# values (relative): the two differ only in the order of f32 sums
BAR_METRIC_NETS = 1e-4
# the synthetic protocol run: generated / GT pairs and FID reference images
# (the reference scores thousands; the count is what the whole run's time
# limit leaves room for)
METRIC_PAIRS = 32


def _conv_flops(model, *inputs):
    """2 x MACs of every ``nn.Conv2d`` and ``nn.Linear`` in one forward of
    ``model``."""
    total = [0]

    def conv(m, _, out):
        total[0] += (2 * m.in_channels // m.groups * m.kernel_size[0]
                     * m.kernel_size[1] * out.numel())

    def linear(m, _, out):
        total[0] += 2 * m.in_features * out.numel()

    hooks = [m.register_forward_hook(conv if isinstance(m, torch.nn.Conv2d)
                                     else linear)
             for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.no_grad():
        model(*inputs)
    for h in hooks:
        h.remove()
    return total[0]


def _metric_weights(root, dev):
    """Seeded full-width FID InceptionV3 (pt_inception layout: conv and
    BatchNorm per unit, He-scaled so the features keep a spread) and
    LPIPS-Alex (the lpips package's ``net.slice{i}.{j}`` / ``lin{i}``
    names), saved with ``torch.save`` under ``root``; -> their paths."""
    from pcdms_tpu_torch.eval import inception, lpips
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    sd = {}
    for prefix, (cin, cout, k, _, _) in inception.UNITS.items():
        sd[f"{prefix}.conv.weight"] = randn(cout, cin, *k) * math.sqrt(
            2.0 / (cin * k[0] * k[1]))
        sd[f"{prefix}.bn.weight"] = 0.5 + rand(cout)
        sd[f"{prefix}.bn.bias"] = 0.1 * randn(cout)
        sd[f"{prefix}.bn.running_mean"] = 0.1 * randn(cout)
        sd[f"{prefix}.bn.running_var"] = 0.5 + rand(cout)
    paths = {"inception": os.path.join(root, "pt_inception.pth"),
             "lpips": os.path.join(root, "alex.pth")}
    torch.save({k: v.cpu() for k, v in sd.items()}, paths["inception"])
    sd = {}
    for i, ((cin, cout, k, _, _), fi, si) in enumerate(zip(
            lpips.ALEX, lpips.FEATURE_INDEX, lpips.SLICE_INDEX)):
        sd[f"net.slice{si}.{fi}.weight"] = randn(cout, cin, k, k) / math.sqrt(
            cin * k * k)
        sd[f"net.slice{si}.{fi}.bias"] = 0.1 * randn(cout)
        sd[f"lin{i}.model.1.weight"] = rand(1, cout, 1, 1)
    torch.save({k: v.cpu() for k, v in sd.items()}, paths["lpips"])
    return paths


def _metric_images(root, dev, n=METRIC_PAIRS):
    """``n`` GT images (``gt/t{i}.png``), their noisy generations in the
    '_to_' naming (``gen/g{i}_to_t{i}.png``) and ``n`` FID reference
    images (``train/r{i}.png``), 512x352: smooth colour fields with noise,
    made on the card."""
    import numpy as np
    from PIL import Image
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    dirs = {k: os.path.join(root, k) for k in ("gt", "gen", "train")}
    for d in dirs.values():
        os.makedirs(d)

    def fields():
        low = torch.rand((n, 3, 8, 6), generator=g, device=dev)
        x = torch.nn.functional.interpolate(low, size=(512, 352),
                                            mode="bicubic")
        x = 255 * x + 12 * torch.randn(x.shape, generator=g, device=dev)
        return x.clamp(0, 255)

    gt, ref = fields(), fields()
    gen = (gt + 24 * torch.randn(gt.shape, generator=g, device=dev)).clamp(
        0, 255)
    jobs = []
    for name, batch in (("gt", gt), ("gen", gen), ("train", ref)):
        arr = batch.round().to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
        for i, img in enumerate(arr):
            stem = {"gt": f"t{i:03d}", "gen": f"g{i:03d}_to_t{i:03d}",
                    "train": f"r{i:03d}"}[name]
            jobs.append((np.ascontiguousarray(img),
                         os.path.join(dirs[name], f"{stem}.png")))
    # PIL's encoder releases the GIL: one thread per core
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(lambda job: Image.fromarray(job[0]).save(
            job[1], compress_level=1), jobs))
    return dirs


class _HostTimer:
    """Wraps ``owner.name`` to add each call's host seconds to
    ``self.seconds``; ``restore()`` puts the original back."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.fn = getattr(owner, name)
        self.seconds, self.calls = 0.0, 0

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return self.fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1

        setattr(owner, name, timed)

    def restore(self):
        setattr(self.owner, self.name, self.fn)


def run_metrics_cli(argv, label):
    """``cli/calculate_metrics.main(argv)`` with the host seconds of its
    ``scipy.linalg.sqrtm`` calls and of ``ReconstructionMetrics`` timed and
    the card's peak memory read; checks the results line; -> results."""
    import numpy as np
    import scipy.linalg
    from pcdms_tpu_torch.cli import calculate_metrics
    from pcdms_tpu_torch.eval.metrics import ReconstructionMetrics

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sqrtm = _HostTimer(scipy.linalg, "sqrtm")
    rec = _HostTimer(ReconstructionMetrics, "calculate_from_disk")
    t0 = time.perf_counter()
    try:
        results = calculate_metrics.main(argv)
    finally:
        sqrtm.restore()
        rec.restore()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    save = argv[argv.index("--save_name") + 1]
    with open(f"{save}_results.txt") as f:
        line = f.read().strip().splitlines()[-1]
    gen = argv[argv.index("--generated_path") + 1]
    pairs = sum("_to_" in f for f in os.listdir(gen))
    print(f"[metrics] {label}: {wall:.2f} s in main, {pairs} pairs; sqrtm "
          f"{sqrtm.calls} call(s) {sqrtm.seconds:.2f} s on the host; "
          f"ReconstructionMetrics {rec.seconds / pairs:.4f} s per pair; "
          f"peak {peak:.2f} GiB; {results}", flush=True)
    expected = {"fid", "lpips", "psnr", "ssim", "ssim_256", "mae", "l1"}
    if (not expected <= set(results) or line != f"{gen} {results}"
            or not all(np.isfinite(v) for v in results.values())
            or results["fid"] < 0 or results["lpips"] < 0
            or not -1 <= results["ssim"] <= 1):
        fail(f"calculate_metrics ({label}): expected finite fid, lpips and "
             f"reconstruction metrics on the results line, got {line!r}")
    return results


def phase_metrics(dev, weights_dir):
    """The metrics protocol on the card (``cli/calculate_metrics.main``) at
    --resolution 256 and 512 on METRIC_PAIRS synthetic generated / GT pairs
    and as many FID reference images, in the CLI's FID batches of 128 and
    LPIPS batches of 64. InceptionV3 and LPIPS images/s by CUDA events, the
    card's pool3 features and LPIPS values against the CPU's on 8 images.
    -> the weight files (``phase_protocol`` scores its PNGs with them)."""
    import numpy as np
    from pcdms_tpu_torch.eval.inception import load_inception
    from pcdms_tpu_torch.eval.lpips import load_lpips

    weights = _metric_weights(weights_dir, dev)
    inc, inc_cpu = (load_inception(weights["inception"], d)
                    for d in (dev, "cpu"))
    lp, lp_cpu = (load_lpips(weights["lpips"], d) for d in (dev, "cpu"))
    g = torch.Generator().manual_seed(SEED)
    x = torch.rand((8, 512, 352, 3), generator=g)
    y = torch.rand((8, 512, 352, 3), generator=g)
    with torch.no_grad():
        feats, feats_cpu = inc(x.to(dev)).cpu(), inc_cpu(x)
        dist, dist_cpu = lp(x.to(dev), y.to(dev)).cpu(), lp_cpu(x, y)
    err_inc = _rel_l2(feats, feats_cpu)
    err_lp = float(((dist - dist_cpu).abs() / dist_cpu.abs()).max())
    spread = float(feats_cpu.std(0).mean() / feats_cpu.abs().mean())
    print(f"[metrics] card vs CPU on 8 images at 512x352, f32 with TF32 off: "
          f"pool3 rel L2 {err_inc:.2e} (features' spread over images "
          f"{spread:.2e} of their mean), LPIPS max rel {err_lp:.2e}",
          flush=True)
    if not (err_inc <= BAR_METRIC_NETS and err_lp <= BAR_METRIC_NETS):
        fail(f"metric networks: card vs CPU beyond {BAR_METRIC_NETS}")
    del inc_cpu, lp_cpu
    rates = []
    with torch.no_grad():
        for h, w in ((256, 176), (512, 352)):
            a = torch.rand((128, h, w, 3), device=dev)
            b = torch.rand((64, h, w, 3), device=dev)
            for name, fn, n, flops in (
                    ("inception", lambda: inc(a), 128,
                     _conv_flops(inc, a[:1])),
                    ("lpips", lambda: lp(a[:64], b), 64,
                     _conv_flops(lp, a[:1], b[:1]))):
                ms = cuda_ms(fn, iters=5)
                rates.append(f"{name} {h}x{w} {n / ms * 1e3:.1f}/s "
                             f"({flops / 1e9:.2f} GFLOP each, "
                             f"{n * flops / ms / 1e9:.1f} TFLOP/s = "
                             f"{n * flops / ms / 1e9 / PEAK_F32_FLOPS * 1e12:.1%}"
                             f" of the f32 peak)")
    print("[metrics] on the card (CUDA events; InceptionV3 images at batch "
          "128, LPIPS pairs at 64; conv flops counted from the shapes): "
          + "; ".join(rates), flush=True)
    del inc, lp
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        dirs = _metric_images(root, dev)
        print(f"[metrics] wrote {3 * METRIC_PAIRS} 512x352 PNGs in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for res in (256, 512):
            argv = ["--fid_real_path", dirs["train"], "--test_path",
                    dirs["gt"], "--generated_path", dirs["gen"],
                    "--resolution", str(res), "--save_name",
                    os.path.join(root, f"m{res}"),
                    "--inception_weights", weights["inception"],
                    "--lpips_weights", weights["lpips"]]
            run_metrics_cli(argv, f"--resolution {res}")
            flag = "176_256" if res == 256 else "352_512"
            for d in ("train", "gen"):
                with np.load(os.path.join(dirs[d],
                                          f"{flag}_statistics.npz")) as f:
                    if (f["mu"].shape != (2048,)
                            or f["sigma"].shape != (2048, 2048)):
                        fail(f"FID statistics of {d} at {flag}: shapes "
                             f"{f['mu'].shape}, {f['sigma'].shape}")
    return weights


# the DWPose networks, card vs CPU (relative L2): both f32 with TF32 off
# inside DWposeTorch._forward, so they differ only in the order of f32 sums (InceptionV3's pool3 reads
# about 6e-7 under the same policy in phase_metrics)
BAR_DWPOSE_NETS = 1e-4
DWPOSE_IMAGES = 16            # synthetic 512x512 person images
DWPOSE_CLI_IMAGES = 8
# a keypoint is held card vs CPU bit for bit where no SimCC argmax can flip:
# its top-two logits apart by more than this on the CPU on both axes (the
# bar of tests/test_torch_dwpose.py)
DWPOSE_MARGIN = 1e-3


@contextlib.contextmanager
def _tf32_on():
    """Both of PyTorch's TF32 switches on (cuDNN's is on in a fresh
    process), so that what runs in f32 inside does so by the port's own
    precision scope; the settings before are restored after. The matmul
    switch goes through ``torch.set_float32_matmul_precision``, the API
    ``dwpose.f32_forward`` uses: the legacy ``matmul.allow_tf32`` setter
    after it leaves PyTorch's precision state mixed, and the next
    ``get_float32_matmul_precision`` raises."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])


def _dwpose_checkpoints(root):
    """Seeded YOLOX-l and RTMPose-l (PyTorch's default init) with random
    BatchNorm statistics (mean ~ N(0, 0.3), var ~ U(0.5, 1.5)), saved under
    ``root`` as mm checkpoints ({"state_dict": ..., "meta": ...});
    -> {name: (path, parameter count)}."""
    from pcdms_tpu_torch.pose.detectors.rtmpose import RTMPose
    from pcdms_tpu_torch.pose.detectors.yolox import YOLOX
    torch.manual_seed(SEED)
    g = torch.Generator().manual_seed(SEED)
    out = {}
    for name, cls in (("yolox_l", YOLOX), ("dwpose_l", RTMPose)):
        model = cls()
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.normal_(0, 0.3, generator=g)
                    m.running_var.uniform_(0.5, 1.5, generator=g)
        path = os.path.join(root, f"{name}.pth")
        torch.save({"state_dict": model.state_dict(),
                    "meta": {"seed": SEED}}, path)
        out[name] = (path, sum(p.numel() for p in model.parameters()))
    return out


def _person_boxes(kp, size, n):
    """``n`` boxes (xyxy, pixels) around the normalised joints ``kp`` of a
    ``size`` px image: the joints' bounds grown by 10 %, then shifted."""
    lo, hi = kp.min(0) * size, kp.max(0) * size
    pad = 0.1 * (hi - lo) + 4
    box = [*(lo - pad), *(hi + pad)]
    return [[v + 9 * i * (1 if j % 2 else -1) for j, v in enumerate(box)]
            for i in range(n)]


class _NetTimer:
    """Puts an instance attribute over ``owner.name`` (a detector's
    ``_forward`` by default) that records CUDA events around each call;
    ``ms()`` waits for the card and sums them; ``restore()`` takes it
    off."""

    def __init__(self, owner, name="_forward"):
        self.owner, self.name, self.events = owner, name, []
        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out

        setattr(owner, name, timed)

    def ms(self):
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)

    def restore(self):
        delattr(self.owner, self.name)


def phase_dwpose(dev):
    """The DWPose extraction path on the card (``pose/dwpose.py::
    DWposeTorch``, ``cli/extract_pose.main``) with seeded random YOLOX-l
    and RTMPose-l saved as mm checkpoints, run with both TF32 switches on
    so that the port's own f32 scope is what is tested: the networks card
    vs CPU, the detector on 16 synthetic 512x512 person images
    letterboxed to 640, the pose half with the detection pinned to 1 and 4
    boxes an image, the CLI on 8 images."""
    import numpy as np
    from PIL import Image
    from pcdms_tpu_torch.cli import extract_pose
    from pcdms_tpu_torch.data.synthetic import generate_dataset
    from pcdms_tpu_torch.pose import dwpose, imgproc
    from pcdms_tpu_torch.pose.keypoints import read_pose_txt

    card = card_name_and_limit()
    with _tf32_on(), tempfile.TemporaryDirectory() as root:
        ckpts = _dwpose_checkpoints(root)
        det = dwpose.DWposeTorch.from_torch(ckpts["yolox_l"][0],
                                            ckpts["dwpose_l"][0])
        cpu = dwpose.DWposeTorch.from_torch(ckpts["yolox_l"][0],
                                            ckpts["dwpose_l"][0],
                                            device="cpu")
        world = os.path.join(root, "world")
        generate_dataset(world, n_identities=DWPOSE_IMAGES // 8, n_poses=8,
                         size=512, seed=SEED)
        stems = sorted(n[:-4] for n in os.listdir(
            os.path.join(world, "train_all_png")))
        images, kps = [], []
        for stem in stems:
            with Image.open(os.path.join(world, "train_all_png",
                                         f"{stem}.png")) as im:
                images.append(np.asarray(im.convert("RGB")))
            kps.append(read_pose_txt(os.path.join(
                world, "normalized_pose_txt", f"{stem}.txt")).reshape(18, 2))
        if len(images) != DWPOSE_IMAGES:
            fail(f"dwpose: {len(images)} synthetic images, expected "
                 f"{DWPOSE_IMAGES}")

        # pose/imgproc.py's cv2 replicas give the same bits on the card
        box = _person_boxes(kps[0], 512, 1)[0]
        image = torch.from_numpy(images[0].copy())
        canvas, _ = dwpose._letterbox(imgproc.swap_rb(image), det.det_size)
        crop, _ = dwpose._pose_crop(image, box)
        if not (torch.equal(dwpose._letterbox(imgproc.swap_rb(
                image.to(dev)), det.det_size)[0].cpu(), canvas)
                and torch.equal(dwpose._pose_crop(image.to(dev), box)[0]
                                .cpu(), crop)):
            fail("dwpose: the letterbox or the crop made on the card differs "
                 "from the CPU's")
        flops = {
            "yolox": _conv_flops(det.det, dwpose._nchw(canvas.to(dev))),
            "rtmpose": _conv_flops(det.pose, dwpose._nchw(crop.to(dev)))}
        print(f"[dwpose] {card}: YOLOX-l {ckpts['yolox_l'][1] / 1e6:.2f}M "
              f"parameters, {flops['yolox'] / 1e9:.1f} GFLOP a "
              f"{det.det_size}x{det.det_size} "
              f"letterbox; RTMPose-l {ckpts['dwpose_l'][1] / 1e6:.2f}M, "
              f"{flops['rtmpose'] / 1e9:.2f} GFLOP a 384x288 crop (2 x "
              "MACs of the convs and linears)", flush=True)
        errs = {"yolox": _rel_l2(det._forward(det.det, canvas.to(dev)).cpu(),
                                 cpu._forward(cpu.det, canvas))}
        for axis, got, want in zip("xy", det._forward(det.pose, crop.to(dev)),
                                   cpu._forward(cpu.pose, crop)):
            errs[f"simcc_{axis}"] = _rel_l2(got.cpu(), want)
        if not (torch.backends.cudnn.allow_tf32
                and torch.backends.cuda.matmul.allow_tf32):
            fail("dwpose: DWposeTorch._forward did not restore the caller's "
                 "TF32 settings")
        print(f"[dwpose] {card}: letterbox and crop on the card equal to the "
              "CPU's; card vs CPU through DWposeTorch._forward, TF32 on "
              "outside it: rel L2 "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()),
              flush=True)
        if not all(v <= BAR_DWPOSE_NETS for v in errs.values()):
            fail(f"dwpose networks: card vs CPU beyond {BAR_DWPOSE_NETS}")

        # the detector: every image through detect_persons
        net_ms = cuda_ms(lambda: det._forward(det.det, canvas.to(dev)),
                         iters=DWPOSE_IMAGES)
        batch = dwpose._nchw(canvas.to(dev)).expand(DWPOSE_IMAGES, -1, -1,
                                                   -1).contiguous()
        with torch.no_grad(), dwpose.f32_forward():
            batch_ms = cuda_ms(lambda: det.det(batch), iters=3, warmup=1)
        decode = _HostTimer(dwpose, "decode_yolox")
        timer = _NetTimer(det)
        n_boxes = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            for img in images:
                boxes, scores = det.detect_persons(img)
                n_boxes += len(boxes)
                if not (np.isfinite(boxes).all()
                        and len(boxes) == len(scores)):
                    fail("dwpose: the detector's boxes are not finite")
        finally:
            decode.restore()
        wall = time.perf_counter() - t0
        call_net = timer.ms()
        timer.restore()
        print(f"[dwpose] {card}: detector on {DWPOSE_IMAGES} 512x512 images "
              f"letterboxed to {det.det_size}: network {net_ms:.2f} ms an "
              f"image by CUDA "
              f"events ({1e3 / net_ms:.1f} images/s, "
              f"{flops['yolox'] / net_ms / 1e9:.1f} TFLOP/s = "
              f"{flops['yolox'] / net_ms / 1e9 / PEAK_F32_FLOPS * 1e12:.1%} "
              f"of the f32 peak), {batch_ms / DWPOSE_IMAGES:.2f} ms at batch "
              f"{DWPOSE_IMAGES} ({DWPOSE_IMAGES * 1e3 / batch_ms:.1f} "
              f"images/s); detect_persons {wall / DWPOSE_IMAGES * 1e3:.2f} ms "
              f"a call by the host clock ({DWPOSE_IMAGES / wall:.1f} "
              f"images/s), of which the network "
              f"{call_net / DWPOSE_IMAGES:.2f} ms: the rest (upload, "
              f"letterbox, copy back, decode and NMS "
              f"{decode.seconds / DWPOSE_IMAGES * 1e3:.2f} ms) "
              f"{1 - call_net / 1e3 / wall:.1%} of the call; {n_boxes} boxes "
              "(random weights)", flush=True)

        # the pose half: the detection pinned, crop, RTMPose-l, SimCC
        # decode, COCO -> OpenPose, the render with hands
        for per_image in (1, 4):
            timer = _NetTimer(det)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for img, kp in zip(images, kps):
                boxes = np.array(_person_boxes(kp, 512, per_image))
                det.detect_persons = lambda _, b=boxes: (
                    b, np.full(len(b), 0.9))
                render, kpts, scores = det(img)
                if not (render.shape == (512, 512, 3)
                        and kpts.shape == (per_image, 18, 2)
                        and np.isfinite(kpts).all()
                        and np.isfinite(scores).all()):
                    fail(f"dwpose: __call__ with {per_image} pinned boxes "
                         f"gave {render.shape}, {kpts.shape}")
            wall = time.perf_counter() - t0
            pose_net = timer.ms()
            timer.restore()
            persons = per_image * DWPOSE_IMAGES
            print(f"[dwpose] {card}: __call__ with {per_image} pinned "
                  f"box(es) an image: {persons / wall:.1f} persons/s, "
                  f"{wall / DWPOSE_IMAGES * 1e3:.1f} ms an image by the host "
                  f"clock; RTMPose-l {pose_net / persons:.2f} ms a person by "
                  f"CUDA events, the host {1 - pose_net / 1e3 / wall:.1%} of "
                  "the call", flush=True)
        # the whole call, card against CPU, on one image with 4 boxes: each
        # keypoint with a SimCC margin above DWPOSE_MARGIN is equal, and
        # where all 4 x 133 are, so are the keypoints and the render
        boxes = np.array(_person_boxes(kps[0], 512, 4))
        held = flips = 0
        for box in boxes:
            top2 = torch.stack([logits[0].topk(2, -1).values for logits in
                                cpu._forward(cpu.pose, dwpose._pose_crop(
                                    torch.from_numpy(images[0].copy()),
                                    box)[0])])
            keep = ((top2[..., 0] - top2[..., 1]) > DWPOSE_MARGIN).all(0)
            same = (det.estimate_pose(images[0], box)[0]
                    == cpu.estimate_pose(images[0], box)[0]).all(-1)
            if not same[keep.numpy()].all():
                fail("dwpose: the card's keypoints differ from the CPU's "
                     f"where the SimCC margin exceeds {DWPOSE_MARGIN}")
            held += int(keep.sum())
            flips += int((~same).sum())
        outs = []
        for d in (det, cpu):
            d.detect_persons = lambda _, b=boxes: (b, np.full(len(b), 0.9))
            outs.append(d(images[0]))
        if flips == 0 and not (np.array_equal(outs[0][0], outs[1][0])
                               and np.array_equal(outs[0][1], outs[1][1])):
            fail("dwpose: the card's render or keypoints differ from the "
                 "CPU's on the same image and boxes")
        print(f"[dwpose] {card}: card vs CPU with 4 pinned boxes: "
              f"{held} of {4 * 133} keypoints with a SimCC margin above "
              f"{DWPOSE_MARGIN} equal; {flips} argmax flip(s) in all; "
              + ("__call__'s OpenPose keypoints and render equal bit for bit"
                 if flips == 0 else "__call__'s keypoints and render not "
                 "held, since a flip within the margin changes them"),
              flush=True)
        del det.detect_persons, cpu

        # the CLI on 8 images, the detector not pinned
        cli_images = os.path.join(root, "cli_images")
        os.makedirs(cli_images)
        for stem in stems[:DWPOSE_CLI_IMAGES]:
            shutil.copy(os.path.join(world, "train_all_png", f"{stem}.png"),
                        cli_images)
        out_txt, out_pose = (os.path.join(root, d) for d in ("txt", "pose"))
        t0 = time.perf_counter()
        written = extract_pose.main([
            "--image_dir", cli_images, "--out_txt_dir", out_txt,
            "--out_pose_dir", out_pose, "--det_ckpt", ckpts["yolox_l"][0],
            "--pose_ckpt", ckpts["dwpose_l"][0], "--image_resolution",
            "512"])
        wall = time.perf_counter() - t0
        if written != stems[:DWPOSE_CLI_IMAGES]:
            fail(f"extract_pose wrote {written}")
        for stem in written:
            with open(os.path.join(out_txt, f"{stem}.txt")) as f:
                lines = f.read().splitlines()
            with Image.open(os.path.join(out_pose, f"{stem}_pose.jpg")) as im:
                size = im.size
            if len(lines) != 18 or size != (512, 512):
                fail(f"extract_pose: {stem}: {len(lines)} lines, {size}")
        print(f"[dwpose] {card}: cli/extract_pose.main on "
              f"{DWPOSE_CLI_IMAGES} images (--det_ckpt / --pose_ckpt, "
              f"--image_resolution 512): {wall:.2f} s in main, "
              f"{wall / DWPOSE_CLI_IMAGES:.3f} s an image with the "
              "checkpoints' load", flush=True)


DEMO_STEPS = 50
# the demo's own file, f32: the UNet without class embedding and the
# projections (the VAE and DINOv2 are phase_weights' files)
DEMO_FILE_BYTES = 4 * 870e6
# a standing person's 18 OpenPose joints, normalised (x, y)
STANDING_POSE = [[.5, .1], [.5, .22], [.38, .22], [.34, .4], [.32, .55],
                 [.62, .22], [.66, .4], [.68, .55], [.44, .52], [.43, .72],
                 [.42, .9], [.56, .52], [.57, .72], [.58, .9], [.47, .08],
                 [.53, .08], [.44, .1], [.56, .1]]


def _frozen_launches(fa):
    return {n: c for n, c in fa.LAUNCHES.items() if c}


def _demo_inputs(root):
    """A synthetic 512x512 source (a gradient with a seeded block pattern)
    and the standing pose as a keypoint ``.txt`` under ``root``."""
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(SEED + 170)
    g = np.linspace(0, 255, 512, dtype=np.float32)
    img = np.stack([np.tile(g, (512, 1))] * 3, -1)
    img += np.kron(rng.uniform(-60, 60, (8, 8, 3)), np.ones((64, 64, 1)))
    src = os.path.join(root, "person.png")
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(src)
    pose = os.path.join(root, "pose.txt")
    with open(pose, "w") as f:
        f.writelines(f"{x} {y}\n" for x, y in STANDING_POSE)
    return src, pose


def phase_demo(fa, dev, weights):
    """The single-image demo at full width (``cli/demo.main``: the stage-2
    UNet without class embedding, SD-2.1's VAE, DINOv2-giant; 512x1024,
    DDIM 50, CFG 2.0, bf16) with ``--random_init``: 750 frozen launches
    (15 a forward), a finite PNG. Then from files: the same seeded UNet and
    projections saved as a monolithic checkpoint (``_write_monolithic``),
    with ``phase_weights``' SD-2.1 and DINOv2 dirs (``weights``), against
    ``--random_init`` with ``phase_weights``' own VAE and DINOv2 modules in
    place of the drawn ones: the PNG byte-identical. Then
    ``examples/demo_torch.ipynb``'s code cells, read with ``json``, at full
    width in an empty directory. Seconds per denoise step (the UNet's CUDA
    events, and the host clock of the whole call over the steps) and the
    peak GiB. Returns the launches."""
    import shutil

    import numpy as np
    from PIL import Image
    from pcdms_tpu_torch.cli import demo

    want = {"flash_frozen": FORWARD_LAUNCHES["flash_frozen"] * DEMO_STEPS}
    build, timers, total, swap = demo.build_models, [], {}, {}

    def timed_build(*args, **kwargs):
        models, dino = build(*args, **kwargs)
        if swap:
            models["vae"], dino = swap["vae"], swap["dino"]
        timers.append(_step_timer(models["unet"]))
        return models, dino

    def run(label, call):
        fa.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _frozen_launches(fa)
        pairs, remove = timers.pop()
        remove()
        unet_ms = [a.elapsed_time(b) for a, b in pairs]
        print(f"[demo] {label}: {wall:.2f} s in all, {wall / DEMO_STEPS:.4f}"
              f" s per denoise step by the host clock (encoders, VAE and "
              f"loading included), the UNet {np.mean(unet_ms):.2f} ms a step "
              f"by CUDA events over {len(unet_ms)} forwards at batch 2; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {counts}", flush=True)
        if counts != want:
            fail(f"demo ({label}): expected launches {want}, got {counts}")
        if len(unet_ms) != DEMO_STEPS:
            fail(f"demo ({label}): {len(unet_ms)} UNet forwards, not "
                 f"{DEMO_STEPS}")
        _add(total, counts)
        return out

    demo.build_models = timed_build
    try:
        with tempfile.TemporaryDirectory() as root:
            free = shutil.disk_usage(root).free
            if free < 1.15 * DEMO_FILE_BYTES:
                fail(f"phase_demo needs {1.15 * DEMO_FILE_BYTES / 1e9:.1f} "
                     f"GB free under {root}, has {free / 1e9:.1f} GB")
            src, pose = _demo_inputs(root)
            base = ["--source", src, "--target_pose", pose, "--seed",
                    str(SEED)]
            rand = run("--random_init", lambda: demo.main(
                base + ["--random_init", "--out",
                        os.path.join(root, "random.png")]))
            arr = np.asarray(Image.open(rand))
            if arr.shape != (512, 512, 3) or not arr.std() > 0:
                fail(f"demo: expected a non-constant (512, 512, 3) PNG, got "
                     f"{arr.shape}")
            models, dino = build(demo.parse_args(base + ["--random_init"]),
                                 demo.model_configs(False), dev)
            del dino
            ckpt = os.path.join(root, "pcdms_ckpt.pt")
            t0 = time.perf_counter()
            _write_monolithic(ckpt, models)
            write_s = time.perf_counter() - t0
            del models
            gc.collect()
            torch.cuda.empty_cache()
            loaded = run("from the files", lambda: demo.main(base + [
                "--ckpt", ckpt, "--sd", weights["--sd"], "--dinov2",
                weights["--dinov2"], "--out",
                os.path.join(root, "loaded.png")]))
            swap.update(vae=weights["vae"], dino=weights["dino"])
            try:
                ref = run("--random_init with phase_weights' VAE and "
                          "DINOv2", lambda: demo.main(
                              base + ["--random_init", "--out",
                                      os.path.join(root, "ref.png")]))
            finally:
                swap.clear()
            same = open(ref, "rb").read() == open(loaded, "rb").read()
            print(f"[demo] the seeded UNet and projections saved as a "
                  f"monolithic checkpoint: {os.path.getsize(ckpt)} bytes in "
                  f"{write_s:.2f} s; with phase_weights' SD-2.1 and DINOv2 "
                  f"dirs, the PNG from the files byte-identical to "
                  f"--random_init's with those modules: {same}", flush=True)
            if not same:
                fail("demo: the checkpoint run wrote another PNG than the "
                     "--random_init run on the same modules")
            nb_dir = os.path.join(root, "notebook")
            os.makedirs(nb_dir)
            ns = run("notebook cells", lambda: _run_notebook(nb_dir))
            if ns["result"].shape != (512, 512, 3) or not np.isfinite(
                    ns["result"]).all():
                fail("demo notebook: expected a finite (512, 512, 3) result")
    finally:
        demo.build_models = build
    gc.collect()
    torch.cuda.empty_cache()
    return total


def _run_notebook(cwd):
    """``examples/demo_torch.ipynb``'s code cells in one namespace, read
    with ``json``, from ``cwd``, at full width on the card."""
    here = os.getcwd()
    path = os.path.join(here, "examples", "demo_torch.ipynb")
    with open(path) as f:
        cells = ["".join(c["source"]) for c in json.load(f)["cells"]
                 if c["cell_type"] == "code"]
    restore = _with_env({"PCDMS_DEMO_TINY": "0", "PCDMS_DEMO_DEVICE": "cuda"})
    os.chdir(cwd)
    try:
        ns = {}
        for src in cells:
            exec(compile(src, path, "exec"), ns)
    finally:
        os.chdir(here)
        restore()
    return ns


def phase_fastpath_drift(fa, dev):
    """``cli/fastpath_drift.py``'s random-weights table at full width
    (512x1024 canvas, batch 2, bf16, the stage-2 UNet with class
    embedding): the exact 50-step DDIM against 20-step UniPC, 20-step DDIM,
    encoder propagation at intervals 2 and 3 and 4-step LCM on the
    teacher-equal student, each with its PSNR, cosine, frozen launches
    (key steps 15, cached ones 9 a forward) and seconds. Returns the
    launches."""
    import numpy as np
    from pcdms_tpu_torch.cli import fastpath_drift as drift

    exact_steps, total = 50, {}
    models, inputs, latents = drift.random_setup(False, 512, 2, dev,
                                                 seed=SEED)
    gen = drift.make_gen(inputs, latents, dev)

    def launches_for(steps, interval=1):
        keys = -(-steps // interval)
        return (FORWARD_LAUNCHES["flash_frozen"] * keys
                + DECODE_LAUNCHES["flash_frozen"] * (steps - keys))

    def timed(fn, want):
        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        counts = _frozen_launches(fa)
        if counts != {"flash_frozen": want}:
            fail(f"fastpath drift: expected {want} frozen launches, got "
                 f"{counts}")
        _add(total, counts)
        if out.shape != (2, 512, 1024, 3) or not np.isfinite(out).all():
            fail("fastpath drift: expected finite (2, 512, 1024, 3) images")
        return out, wall, counts["flash_frozen"]

    exact, wall, n = timed(lambda: gen(models, exact_steps),
                           launches_for(exact_steps))
    print(f"[drift] exact DDIM {exact_steps}: {wall:.2f} s, {n} frozen "
          f"launches", flush=True)
    wants = [launches_for(20), launches_for(20),
             launches_for(exact_steps, 2), launches_for(exact_steps, 3),
             FORWARD_LAUNCHES["flash_frozen"] * 4]
    for (name, fn), want in zip(drift.variants(gen, models, exact_steps),
                                wants):
        out, wall, n = timed(fn, want)
        p, c = drift.psnr(exact, out), drift.cosine(exact, out)
        print(f"[drift] {name}: PSNR {p:.4f} dB, cosine {c:.6f}, {n} frozen "
              f"launches, {wall:.2f} s", flush=True)
        if not (np.isfinite(p) and 0.0 < c <= 1.0):
            fail(f"fastpath drift ({name}): PSNR {p}, cosine {c}")
    del models
    gc.collect()
    torch.cuda.empty_cache()
    return total


ANNOTATOR_IMAGES = 4
# the CPU half of each Processor id runs on the first image only (the hand
# network at four scales up to 736x736 a crop takes seconds on the host)
ANNOTATOR_CPU_IMAGES = 1
BAR_ANNOTATOR_NETS = 1e-4
# Processor ids run card vs CPU at this detect_resolution (the networks'
# CPU side at 512 would take the phase's whole budget); the images are
# 512x512 and the outputs 512x512
ANNOTATOR_DETECT_RES = 256


def _annotator_images(n=ANNOTATOR_IMAGES):
    """``n`` synthetic 512x512 uint8 images: seeded 16x16 colour fields
    enlarged by ``imgproc.resize`` (Lanczos-4), with a bright figure."""
    import numpy as np
    from pcdms_tpu_torch.pose import imgproc
    rng = np.random.default_rng(SEED + 171)
    out = []
    for _ in range(n):
        small = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
        img = imgproc.resize(torch.from_numpy(small), (512, 512),
                             "lanczos4").numpy()
        img[100:420, 220:292] = rng.integers(180, 256, 3)
        out.append(img)
    return out


def _annotator_weights(root):
    """Seeded full-width OpenPose body / hand / face, HED, PiDiNet and
    LineArt (realistic, coarse) saved as controlnet-aux ``.pth`` files
    (the OpenPose body / hand without their block prefixes as released,
    PiDiNet in a DataParallel ``state_dict``) -> {name: (path, module)}."""
    from pcdms_tpu_torch.pose import detectors as det
    out = {}
    for i, (name, cls) in enumerate((
            ("body", det.BodyPoseModel), ("hand", det.HandPoseModel),
            ("face", det.FaceNet), ("hed", det.ControlNetHED),
            ("pidinet", det.PiDiNet), ("lineart", det.Generator),
            ("lineart_coarse", det.Generator))):
        torch.manual_seed(SEED + 180 + i)
        model = cls().eval()
        sd = model.state_dict()
        if name in ("body", "hand"):
            sd = {k.split(".", 1)[1]: v for k, v in sd.items()}
        if name == "pidinet":
            sd = {"state_dict": {f"module.{k}": v for k, v in sd.items()}}
        path = os.path.join(root, f"{name}.pth")
        torch.save(sd, path)
        out[name] = (path, model)
    return out


# a body peak may differ card vs CPU only where the CPU's blurred heat is
# within this of a tie: with a 4-neighbour or with the 0.1 threshold
OPENPOSE_MARGIN = 1e-6


def _peak_margins(heat, thresh=0.1, sigma=3.0):
    """(H, W, 19) heat -> (18, H, W): per part, how far each pixel of the
    blurred map is from being no peak in ``openpose_decode.find_peaks``
    (the least of its lead over each zero-padded 4-neighbour and over
    ``thresh``; a peak where >= 0)."""
    import numpy as np
    from scipy.ndimage import gaussian_filter
    out = []
    for part in range(heat.shape[2] - 1):
        b = np.pad(gaussian_filter(heat[:, :, part], sigma=sigma), 1)
        c = b[1:-1, 1:-1]
        out.append(np.minimum.reduce([c - b[:-2, 1:-1], c - b[2:, 1:-1],
                                      c - b[1:-1, :-2], c - b[1:-1, 2:],
                                      c - thresh]))
    return np.stack(out)


def _peak_flips(cpu_heats, dev_heats, find_peaks):
    """-> (the body peaks that ``find_peaks`` finds on the CPU, the (image,
    part, y, x) that differ card vs CPU, the largest |CPU margin| among
    them)."""
    count, flips, worst = 0, [], 0.0
    for i, (a, b) in enumerate(zip(cpu_heats, dev_heats)):
        pa, pb = (find_peaks(h, 0.1) for h in (a, b))
        count += sum(len(p) for p in pa)
        margins = _peak_margins(a)
        for part, (qa, qb) in enumerate(zip(pa, pb)):
            for x, y in {(p[0], p[1]) for p in qa} ^ {(p[0], p[1])
                                                       for p in qb}:
                flips.append((i, part, int(y), int(x)))
                worst = max(worst, float(abs(margins[part, y, x])))
    return count, flips, worst


def _face_picks(heat, thresh=0.05):
    """``openpose_decode.face_peaks_from_heatmaps`` per landmark: (x, y)
    or None where no value passes ``thresh``."""
    import numpy as np
    out = []
    for part in range(70):
        m = heat[:, :, part]
        ys, xs = np.nonzero(m > thresh)
        if not len(ys):
            out.append(None)
            continue
        i = int(np.argmax(m[ys, xs]))
        out.append((int(xs[i]), int(ys[i])))
    return out


def _pick_flips(kind, cpu_reads, dev_reads, thresh=0.05):
    """The hand or face peak readers' (heat, peaks) card vs CPU, call by
    call -> (the parts read, the parts whose pick differs, the largest
    ratio of such a part's CPU margin to twice the card-vs-CPU difference
    of its map: a pick may move only where it is <= 1). The margin is the
    CPU map's lead of its own pick over the card's, or, where one side
    found none, the least distance of the thresholded map (blurred, for a
    hand) from the threshold."""
    import numpy as np
    from scipy.ndimage import gaussian_filter
    parts, flips, worst = 0, [], 0.0
    for call, ((hc, pc), (hd, pd)) in enumerate(zip(cpu_reads, dev_reads)):
        if kind == "hand":
            picks = [[None if not p.any() else tuple(int(v) for v in p)
                      for p in peaks] for peaks in (pc, pd)]
        else:
            picks = [_face_picks(hc, thresh), _face_picks(hd, thresh)]
            if not np.array_equal(np.asarray(
                    [p for p in picks[0] if p], np.float32).reshape(-1, 2),
                    pc):
                fail("annotators: _face_picks does not read the CPU's "
                     "face peaks")
        for part, (a, b) in enumerate(zip(*picks)):
            parts += 1
            if a == b:
                continue
            m = hc[:, :, part]
            delta = float(np.abs(m - hd[:, :, part]).max())
            if a is not None and b is not None:
                lead = abs(float(m[a[1], a[0]] - m[b[1], b[0]]))
            else:
                g = gaussian_filter(m, sigma=3.0) if kind == "hand" else m
                lead = float(np.abs(g - thresh).min())
            ratio = lead / (2 * delta) if delta else math.inf
            flips.append((call, part, a, b))
            worst = max(worst, ratio)
    return parts, flips, worst


def phase_annotators(dev):
    """The annotator facade on the card: the seeded networks saved as
    controlnet-aux files and loaded back (``load_network``); each network
    card vs CPU on a 128x128 input (rel L2 <= 1e-4, f32, both TF32
    switches on around the port's own scope) and its images/s at a 512
    input by CUDA events; then every ``Processor`` id of this slice on 4
    synthetic 512x512 images on the card and the first on the CPU (the
    network ids at detect_resolution 256): uint8 outputs by their largest
    level difference and the share of differing values. The OpenPose ids
    take the body network's output from ``openpose_scene`` on both sides
    (a random body finds nobody), so two people are assembled from the
    PAFs and their hand and face crops run through the seeded hand and face
    networks on the card; the CPU reuses the card's output for a crop whose
    network input is bit-identical to one of the card's (each network also
    runs on the CPU once, on such a crop, rel L2 <= 1e-4), else runs its
    own. Body, hand and face peaks card vs CPU, held equal but for
    near-ties (``_peak_flips``, ``_pick_flips``). No kernel of the
    repository lies on this path."""
    import hashlib

    import numpy as np
    from pcdms_tpu_torch.pose import processors
    from pcdms_tpu_torch.pose.detectors import openpose as op
    from pcdms_tpu_torch.pose.detectors import openpose_decode, openpose_scene
    from pcdms_tpu_torch.pose.detectors.common import load_network
    from pcdms_tpu_torch.pose.dwpose import f32_forward

    card = card_name_and_limit()
    t_nets = time.perf_counter()
    images = _annotator_images()
    with tempfile.TemporaryDirectory() as root:
        weights = _annotator_weights(root)
        g = torch.Generator().manual_seed(SEED)
        x = torch.rand((1, 3, 128, 128), generator=g)
        big = torch.rand((1, 3, 512, 512), generator=g, device="cpu").to(dev)
        for name, (path, model) in weights.items():
            loaded = load_network(type(model)(), path)
            for k, v in loaded.state_dict().items():
                if not torch.equal(v, model.state_dict()[k]):
                    fail(f"annotators: {name}.pth loaded {k} changed")
            net = copy.deepcopy(loaded).to(dev)
            with torch.no_grad(), _tf32_on(), f32_forward():
                want = loaded(x)
                got = net(x.to(dev))
                want = want if isinstance(want, (tuple, list)) else [want]
                got = got if isinstance(got, (tuple, list)) else [got]
                rel = max(_rel_l2(a.cpu(), b) for a, b in zip(got, want))
                # PiDiNet times with its difference convs folded once
                args = (net.fold(),) if name == "pidinet" else ()
                ms = cuda_ms(lambda: net(big, *args), iters=5)
            print(f"[annotators] {name}: {sum(p.numel() for p in net.parameters()) / 1e6:.2f}M "
                  f"parameters; card vs CPU rel L2 {rel:.3e} (bar "
                  f"{BAR_ANNOTATOR_NETS:g}); at a 512x512 input {ms:.3f} ms,"
                  f" {1000.0 / ms:.2f} images/s (CUDA events); {card}",
                  flush=True)
            if not rel <= BAR_ANNOTATOR_NETS:
                fail(f"annotators: {name} card vs CPU rel L2 {rel:.3e}")
            del net
        print(f"[annotators] the seven networks made, saved, loaded and "
              f"checked in {time.perf_counter() - t_nets:.1f} s", flush=True)

        paths = {k: v[0] for k, v in weights.items()}
        net_ids = {
            "hed": "hed", "hed_safe": "hed", "scribble_hed": "hed",
            "softedge_hed": "hed", "softedge_hedsafe": "hed",
            "scribble_pidinet": "pidinet", "softedge_pidinet": "pidinet",
            "softedge_pidsafe": "pidinet", "lineart_realistic": "lineart",
            "lineart_coarse": "lineart_coarse", "openpose": "body",
            "openpose_face": "body", "openpose_faceonly": "body",
            "openpose_full": "body", "openpose_hand": "body"}
        ids = [(pid, {}) for pid in ("none", "resize", "canny", "scribble",
                                     "shuffle")]
        ids += [(pid, {"weights": paths[w], "hand_weights": paths["hand"],
                       "face_weights": paths["face"],
                       "detect_resolution": ANNOTATOR_DETECT_RES})
                for pid, w in net_ids.items()]
        reads = {"body": {}, "hand": {}, "face": {}}
        card_out, net_checks, misses = {}, {}, {}
        originals = {"body": openpose_decode.find_peaks,
                     "hand": openpose_decode.hand_peaks_from_heatmaps,
                     "face": openpose_decode.face_peaks_from_heatmaps}
        forward = op.OpenposeDetector._forward

        def spying(kind):
            def spy(heat, *args, **kwargs):
                out = originals[kind](heat, *args, **kwargs)
                # the face reader's result is shifted in place by its caller
                reads[kind].setdefault(spying.device, []).append(
                    (heat, out if kind == "body" else out.copy()))
                return out
            return spy

        def crafted_forward(self, net, img):
            name = type(net).__name__
            if name == "BodyPoseModel":
                return tuple(torch.from_numpy(a).to(self.device).permute(
                    0, 3, 1, 2) for a in openpose_scene.network_outputs(
                        *img.shape[:2])[:2])
            key = (name, hashlib.sha1(img.cpu().numpy().tobytes()).digest())
            if self.device.type != "cpu":
                out = forward(self, net, img)
                card_out[key] = out.cpu()
                return out
            if key not in card_out:
                misses[name] = misses.get(name, 0) + 1
                return forward(self, net, img)
            if name not in net_checks:
                net_checks[name] = _rel_l2(forward(self, net, img),
                                           card_out[key])
            return card_out[key].clone()

        for kind in originals:
            setattr(openpose_decode, {"body": "find_peaks"}.get(
                kind, f"{kind}_peaks_from_heatmaps"), spying(kind))
        op.OpenposeDetector._forward = crafted_forward
        try:
            for pid, params in ids:
                outs, secs = {}, {}
                card_out.clear()
                for side, where, imgs in (
                        ("card", dev, images),
                        ("cpu", "cpu", images[:ANNOTATOR_CPU_IMAGES])):
                    spying.device = side
                    proc = processors.Processor(pid, dict(params),
                                                device=where)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    outs[side] = [np.asarray(proc(im, to_pil=False))
                                  for im in imgs]
                    torch.cuda.synchronize()
                    secs[side] = (time.perf_counter() - t0) / len(imgs)
                want = outs["cpu"]
                got = outs["card"][:len(want)]
                if any(a.shape != b.shape for a, b in zip(got, want)):
                    fail(f"annotators: Processor('{pid}') card and CPU "
                         f"shapes differ")
                d = np.stack([np.abs(a.astype(np.int32) - b.astype(np.int32))
                              for a, b in zip(got, want)])
                extra = ""
                if pid.startswith("openpose"):
                    side = {k: (v.pop("cpu", []), v.pop("card", []))
                            for k, v in reads.items()}
                    cpu_b, dev_b = side["body"]
                    n, flips, worst = _peak_flips(
                        [h for h, _ in cpu_b],
                        [h for h, _ in dev_b[:len(cpu_b)]],
                        originals["body"])
                    extra = (f"; body peaks {n} on the CPU, {len(flips)} "
                             f"differ card vs CPU, their largest CPU margin "
                             f"{worst:.3e} (bar {OPENPOSE_MARGIN:g})")
                    if worst > OPENPOSE_MARGIN:
                        fail(f"annotators: Processor('{pid}') body peaks "
                             f"differ card vs CPU beyond a tie: {flips[:5]}")
                    for kind in ("hand", "face"):
                        cpu_r, dev_r = side[kind]
                        wanted = kind in pid or pid == "openpose_full"
                        if wanted != bool(dev_r) or len(cpu_r) > len(dev_r):
                            fail(f"annotators: Processor('{pid}') read "
                                 f"{len(dev_r)} {kind} crops on the card, "
                                 f"{len(cpu_r)} on the CPU")
                        if not wanted:
                            continue
                        parts, pflips, pworst = _pick_flips(
                            kind, cpu_r, dev_r[:len(cpu_r)])
                        extra += (f"; {kind} crops {len(dev_r)} on the card"
                                  f" ({len(cpu_r)} on the CPU), {parts} "
                                  f"{kind} parts read on both, "
                                  f"{len(pflips)} differ, the largest margin"
                                  f" / (2 x map difference) {pworst:.3g} "
                                  f"(bar 1)")
                        if pworst > 1.0:
                            fail(f"annotators: Processor('{pid}') {kind} "
                                 f"peaks differ card vs CPU beyond a tie: "
                                 f"{pflips[:5]}")
                print(f"[annotators] Processor('{pid}') on "
                      f"{len(images)} 512x512 images on the card, "
                      f"{len(want)} on the CPU: {secs['card']:.4f} s "
                      f"an image on the card, {secs['cpu']:.4f} on the CPU; "
                      f"out {got[0].shape}; card vs CPU largest level "
                      f"difference {int(d.max())}, differing share "
                      f"{float((d > 0).mean()):.3e}{extra}", flush=True)
                if (d > 0).mean() > 1e-2:
                    fail(f"annotators: Processor('{pid}') card vs CPU differ"
                         f" in over 1 % of the values")
        finally:
            op.OpenposeDetector._forward = forward
            openpose_decode.find_peaks = originals["body"]
            openpose_decode.hand_peaks_from_heatmaps = originals["hand"]
            openpose_decode.face_peaks_from_heatmaps = originals["face"]
    print(f"[annotators] the OpenPose hand / face networks on the CPU on a "
          f"real crop vs the card's output: rel L2 {net_checks} (bar "
          f"{BAR_ANNOTATOR_NETS:g}); CPU crops whose input matched no card "
          f"input (run on the CPU): {misses or 'none'}", flush=True)
    if set(net_checks) != {"HandPoseModel", "FaceNet"} or not all(
            v <= BAR_ANNOTATOR_NETS for v in net_checks.values()):
        fail(f"annotators: the hand / face networks card vs CPU on a crop: "
             f"{net_checks}")
    gc.collect()
    torch.cuda.empty_cache()


# the depth, normal and line families: each network card vs CPU on a small
# input at this bar (rel L2, f32, TF32 off), its images/s at these inputs
DEPTH_NET_INPUTS = {"lineart_anime": (3, 256, 256), "mlsd": (4, 128, 128),
                    "midas": (3, 128, 128), "normalbae": (3, 128, 128),
                    "zoe": (3, 96, 128), "leres": (3, 128, 128),
                    "pix2pix": (2, 1024, 1024)}
# the timed input: 512x512 (ZoeDepth: its prep_size of a 512 image, padded;
# the merge network: its only size, 1024)
DEPTH_NET_TIMED = {"lineart_anime": (3, 512, 512), "mlsd": (4, 512, 512),
                   "midas": (3, 512, 512), "normalbae": (3, 512, 512),
                   "zoe": (3, 512, 512), "leres": (3, 512, 512),
                   "pix2pix": (2, 1024, 1024)}
# the boost's patch loop runs on the card at this detect_resolution (at
# 256 the image is smaller than the 448 receptive field, and the boost
# takes its whole-image exit)
BOOST_DETECT_RES = 512


# a uint8 map of the family card vs CPU: at most this many levels apart, on
# at most this share of its values (the CPU tests' bar against cv2)
DEPTH_LEVELS = 1
DEPTH_LEVEL_SHARE = 1e-3


def _depth_annotator_networks(dev):
    """The seven seeded full-width networks, one at a time: PyTorch's
    default init drawn on the card (seconds of the host's time less) and
    brought to the host, random BatchNorm statistics and affines,
    ZoeDepth's zero-initialised BEiT parameters made non-zero and its seed
    bins spread, as tests/test_torch_annotators_depth.py seeds them ->
    yields (name, module on the CPU, the published layout around a state
    dict)."""
    import numpy as np
    from pcdms_tpu_torch.pose import detectors as det
    layouts = {
        "lineart_anime": (det.UnetGenerator, lambda sd: sd),
        "mlsd": (det.MobileV2_MLSD_Large, lambda sd: sd),
        "midas": (det.DPTHybrid, lambda sd: sd),
        "normalbae": (det.NNET, lambda sd: {"model": sd}),
        "zoe": (det.ZoeDepth, lambda sd: {"model": sd}),
        "leres": (det.RelDepthModel, lambda sd: {"depth_model": {
            f"module.{k}": v for k, v in sd.items()}}),
        "pix2pix": (det.pix2pix4depth, lambda sd: sd)}
    for i, (name, (cls, wrap)) in enumerate(layouts.items()):
        torch.manual_seed(SEED + 190 + i)
        rng = np.random.default_rng(SEED + 190 + i)
        with torch.device(dev):
            model = cls()
        model = model.cpu().eval()
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    for attr, lo, hi in (("running_mean", -0.3, 0.3),
                                         ("running_var", 0.5, 1.5),
                                         ("weight", 0.5, 1.5),
                                         ("bias", -0.1, 0.1)):
                        v = getattr(m, attr)
                        v.copy_(torch.from_numpy(rng.uniform(
                            lo, hi, v.shape).astype(np.float32)))
            if name == "zoe":
                model.seed_bin_regressor._net[2].weight.mul_(100.0)
                model.conditional_log_binomial.mlp[2].weight.mul_(10.0)
                for pname, p in model.named_parameters():
                    if pname.endswith(("gamma_1", "gamma_2")):
                        p.copy_(torch.from_numpy(rng.uniform(
                            0.05, 0.15, p.shape).astype(np.float32)))
                    elif pname.endswith(("q_bias", "v_bias", "cls_token",
                                         "relative_position_bias_table")):
                        p.copy_(torch.from_numpy((rng.standard_normal(
                            p.shape) * 0.05).astype(np.float32)))
        yield name, model, wrap


def _boost_image():
    """A 512x512 image for the boost's patch loop: a flat colour with one
    sharp 40 px square near a corner, whose lone edges leave most of the
    dilated gradient mask empty, so the resolution search keeps the 448
    receptive field (at or under the image's 512: the patch loop runs), and
    select 4 patches of two sizes around the square."""
    import numpy as np
    rng = np.random.default_rng(SEED + 197)
    img = np.empty((512, 512, 3), np.uint8)
    img[:] = rng.integers(60, 200, 3)
    img[16:56, 16:56] = rng.integers(0, 256, 3)
    return img


class _NetReplay:
    """The card's network calls replayed on the CPU: each class's
    ``forward`` is wrapped so that on the card it records (tensor inputs,
    output) in call order, and on the CPU it takes the card's call of the
    same index, holds each of its own tensor inputs against the card's
    (same shapes, rel L2 <= ``bar``) and returns the card's output (a tensor
    or a tuple of them). The CPU half of a detector then runs every step
    but its networks (each held card vs CPU on its own) on the host;
    ``phase`` names the phase in its failures."""

    def __init__(self, classes, bar, phase):
        self.bar, self.phase = bar, phase
        self.originals = {cls: cls.forward for cls in classes}
        self.calls, self.seen, self.worst = {}, {}, {}
        for cls in classes:
            cls.forward = self._wrap(cls.__name__, cls.forward)

    def _wrap(self, name, forward):
        def wrapped(net, *args, **kwargs):
            xs = [a for a in args if isinstance(a, torch.Tensor)]
            if xs[0].device.type != "cpu":
                out = forward(net, *args, **kwargs)
                self.calls.setdefault(name, []).append((
                    [x.cpu() for x in xs],
                    tuple(o.cpu() for o in out) if isinstance(out, tuple)
                    else out.cpu()))
                return out
            i = self.seen.get(name, 0)
            self.seen[name] = i + 1
            card = self.calls.get(name, [])
            shapes = [tuple(x.shape) for x in xs]
            if i >= len(card) or shapes != [tuple(c.shape)
                                            for c in card[i][0]]:
                fail(f"{self.phase}: the CPU's call {i} of {name} "
                     f"(inputs {shapes}) has no card call of its shapes")
            rel = max(_rel_l2(x, c) for x, c in zip(xs, card[i][0]))
            self.worst[name] = max(self.worst.get(name, 0.0), rel)
            if not rel <= self.bar:
                fail(f"{self.phase}: {name}'s input {i} card vs CPU "
                     f"rel L2 {rel:.3e}")
            out = card[i][1]
            return (tuple(o.clone() for o in out) if isinstance(out, tuple)
                    else out.clone())
        return wrapped

    def reset(self):
        self.calls.clear()
        self.seen.clear()
        self.worst.clear()

    def summary(self, per_cpu_call):
        """Each network's CPU calls, its card calls (``per_cpu_call`` each:
        the card ran that many images for each of the CPU's) and the worst
        input rel L2; fails where they do not add up."""
        if not self.seen:
            fail(f"{self.phase}: the CPU half called no network")
        for name, n in self.seen.items():
            if len(self.calls[name]) != per_cpu_call * n:
                fail(f"{self.phase}: {name} ran {len(self.calls[name])}"
                     f" times on the card, {n} on the CPU")
        return ", ".join(f"{k} {n} call(s), input rel L2 {self.worst[k]:.3e}"
                         for k, n in self.seen.items())

    def restore(self):
        for cls, forward in self.originals.items():
            cls.forward = forward


def _level_check(pid, got, want):
    """uint8 maps card vs CPU -> (largest level difference, differing
    share); fails on a shape or beyond DEPTH_LEVELS / DEPTH_LEVEL_SHARE."""
    import numpy as np
    if any(a.shape != b.shape for a, b in zip(got, want)):
        fail(f"annotators_depth: {pid} card and CPU shapes differ")
    d = np.stack([np.abs(a.astype(np.int32) - b.astype(np.int32))
                  for a, b in zip(got, want)])
    top, share = int(d.max()), float((d > 0).mean())
    if top > DEPTH_LEVELS or share > DEPTH_LEVEL_SHARE:
        fail(f"annotators_depth: {pid} card vs CPU {top} levels apart on "
             f"{share:.3e} of the values (bar {DEPTH_LEVELS} on "
             f"{DEPTH_LEVEL_SHARE:g})")
    return top, share


def phase_annotators_depth(dev):
    """The depth, normal and line families on the card: the seven seeded
    full-width networks saved in their published layouts and loaded back
    through each detector's ``from_pretrained``; each network card vs CPU
    on a small input (rel L2 <= 1e-4, f32, both TF32 switches on around the
    port's own scope) and its images/s at 512 by CUDA events; then every
    ``Processor`` id of the slice on 4 synthetic 512x512 images on the card
    and the first on the CPU at detect_resolution 256. The CPU half runs
    every step on the host but the networks, whose outputs it takes from
    the card's calls where its inputs match the card's (``_NetReplay``,
    rel L2 <= 1e-4). uint8 maps card vs CPU within DEPTH_LEVELS on at most
    DEPTH_LEVEL_SHARE of their values. Each discrete step after a network
    is held by its input card vs CPU (rel L2 <= 1e-4) and its flips
    counted: ZoeDepth's percentile map (its depth), LeReS's 16-bit step
    (its depth), M-LSD's top 200 (its map; the segments that differ), the
    boost's patch search (the decisions, equal). Last, ``depth_leres++`` at
    detect_resolution 512 on a crafted image runs its patch loop on the
    card and on the CPU: the decisions equal, the boosted depth within rel
    L2 1e-4, the maps as above. No kernel of the repository lies on this
    path."""
    import numpy as np
    from pcdms_tpu_torch.pose import processors
    from pcdms_tpu_torch.pose.detectors import (
        leres, leres_boost, lineart_anime, midas, mlsd, normalbae, zoe,
    )
    from pcdms_tpu_torch.pose.detectors.common import empty, load_network
    from pcdms_tpu_torch.pose.dwpose import f32_forward

    card = card_name_and_limit()
    t_nets = time.perf_counter()
    images = _annotator_images()
    g = torch.Generator().manual_seed(SEED + 198)
    loaders = {
        "lineart_anime": lambda p: lineart_anime.LineartAnimeDetector
        .from_pretrained(p, device="cpu").model,
        "mlsd": lambda p: mlsd.MLSDdetector.from_pretrained(
            p, device="cpu").model,
        "midas": lambda p: midas.MidasDetector.from_pretrained(
            p, device="cpu").model,
        "normalbae": lambda p: normalbae.NormalBaeDetector.from_pretrained(
            p, device="cpu").model,
        "zoe": lambda p: zoe.ZoeDetector.from_pretrained(
            p, device="cpu").model,
        "leres": lambda p: leres.LeresDetector.from_pretrained(
            p, device="cpu").model,
        "pix2pix": lambda p: load_network(empty(leres_boost.pix2pix4depth),
                                          p)}
    with tempfile.TemporaryDirectory() as root:
        paths, size = {}, 0
        for name, model, wrap in _depth_annotator_networks(dev):
            path = paths[name] = os.path.join(root, f"{name}.pth")
            torch.save(wrap(model.state_dict()), path)
            size += os.path.getsize(path)
            loaded = loaders[name](path)
            if hasattr(model, "fold"):
                model.fold()
            for k, v in model.state_dict().items():
                if not torch.equal(v, loaded.state_dict()[k]):
                    fail(f"annotators_depth: {name} loaded {k} changed")
            del model
            x = torch.rand((1,) + DEPTH_NET_INPUTS[name], generator=g)
            big = torch.rand((1,) + DEPTH_NET_TIMED[name], generator=g).to(
                dev)
            if name == "midas" or name == "lineart_anime":
                x, big = x * 2 - 1, big * 2 - 1
            if name == "leres":
                x, big = x * 255, big * 255
            with torch.no_grad(), _tf32_on(), f32_forward():
                want = loaded(x)
                net = loaded.to(dev)
                got = net(x.to(dev))
                rel = _rel_l2(got.cpu(), want)
                ms = cuda_ms(lambda: net(big), iters=3)
            print(f"[annotators_depth] {name}: "
                  f"{sum(p.numel() for p in net.parameters()) / 1e6:.2f}M "
                  f"parameters; card vs CPU at {tuple(x.shape[1:])} rel L2 "
                  f"{rel:.3e} (bar {BAR_ANNOTATOR_NETS:g}); at "
                  f"{tuple(big.shape[1:])} {ms:.3f} ms, {1000.0 / ms:.2f} "
                  f"images/s (CUDA events); {card}", flush=True)
            if not rel <= BAR_ANNOTATOR_NETS:
                fail(f"annotators_depth: {name} card vs CPU rel L2 "
                     f"{rel:.3e}")
            del net, loaded
        print(f"[annotators_depth] the seven networks made, saved "
              f"({size / 1e9:.2f} GB of files), loaded and checked in "
              f"{time.perf_counter() - t_nets:.1f} s", flush=True)
        gc.collect()

        # the discrete steps' inputs, recorded per side
        reads = {}
        originals = (zoe.ZoeDetector.infer, leres.normalize_16bit,
                     mlsd.decode_lines, leres_boost.estimateboost)

        def record(key, value):
            reads.setdefault((record.pid, record.side, key), []).append(value)

        def infer(self, *a, **k):
            out = originals[0](self, *a, **k)
            record("depth", out.cpu())
            return out

        def norm16(depth):
            record("depth", depth.cpu())
            return originals[1](depth)

        def decode(tp_map, *a, **k):
            out = originals[2](tp_map, *a, **k)
            record("map", tp_map.cpu())
            record("lines", out)
            return out

        def boost(*a, **k):
            log = []
            out = originals[3](*a, log=log, **k)
            record("boost", log[0])
            return out

        zoe.ZoeDetector.infer = infer
        leres.normalize_16bit = norm16
        mlsd.decode_lines = decode
        leres_boost.estimateboost = boost
        replay = _NetReplay(
            (lineart_anime.UnetGenerator, mlsd.MobileV2_MLSD_Large,
             midas.DPTHybrid, normalbae.NNET, zoe.ZoeDepth,
             leres.RelDepthModel), BAR_ANNOTATOR_NETS, "annotators_depth")
        ids = [("lineart_anime", "lineart_anime"), ("mlsd", "mlsd"),
               ("midas", "midas"), ("depth_midas", "midas"),
               ("normal_midas", "midas"), ("normal_bae", "normalbae"),
               ("depth_zoe", "zoe"), ("depth_leres", "leres"),
               ("depth_leres++", "leres")]
        try:
            for pid, w in ids:
                params = {"weights": paths[w],
                          "pix2pix_weights": paths["pix2pix"],
                          "detect_resolution": ANNOTATOR_DETECT_RES}
                outs, secs = {}, {}
                record.pid = pid
                replay.reset()
                for side, where, imgs in (
                        ("card", dev, images),
                        ("cpu", "cpu", images[:ANNOTATOR_CPU_IMAGES])):
                    record.side = side
                    proc = processors.Processor(pid, dict(params),
                                                device=where)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    outs[side] = [np.asarray(proc(im, to_pil=False))
                                  for im in imgs]
                    torch.cuda.synchronize()
                    secs[side] = (time.perf_counter() - t0) / len(imgs)
                    del proc
                want = outs["cpu"]
                top, share = _level_check(f"Processor('{pid}')",
                                          outs["card"][:len(want)], want)
                extra = ("; the CPU's networks from the card: "
                         + replay.summary(len(images) // len(want)))
                for key in ("depth", "map"):
                    cpu_r = reads.get((pid, "cpu", key), [])
                    dev_r = reads.get((pid, "card", key), [])
                    for a, b in zip(cpu_r, dev_r):
                        rel = _rel_l2(b, a)
                        extra += (f"; the step's input ({key}) card vs CPU "
                                  f"rel L2 {rel:.3e}")
                        if not rel <= BAR_ANNOTATOR_NETS:
                            fail(f"annotators_depth: Processor('{pid}') "
                                 f"{key} card vs CPU rel L2 {rel:.3e}")
                if pid == "mlsd":
                    a = {tuple(r) for r in reads[(pid, "cpu", "lines")][0]
                         .astype(int)}
                    b = {tuple(r) for r in reads[(pid, "card", "lines")][0]
                         .astype(int)}
                    extra += (f"; segments {len(a)} on the CPU, {len(b)} on "
                              f"the card, {len(a ^ b)} differ")
                if pid == "depth_leres++":
                    a = reads[(pid, "cpu", "boost")][0]
                    b = reads[(pid, "card", "boost")][0]
                    extra += (f"; boost: whole size {b['whole_size']} on the"
                              f" card, {a['whole_size']} on the CPU, "
                              f"{len(b['patches'])} / {len(a['patches'])} "
                              f"patches")
                    if a != b:
                        fail(f"annotators_depth: the boost's decisions "
                             f"differ card vs CPU: {b} vs {a}")
                print(f"[annotators_depth] Processor('{pid}') on "
                      f"{len(images)} 512x512 images on the card, "
                      f"{len(want)} on the CPU: {secs['card']:.4f} s an "
                      f"image on the card, {secs['cpu']:.4f} on the CPU; "
                      f"out {want[0].shape}; card vs CPU largest level "
                      f"difference {top}, differing share {share:.3e}"
                      f"{extra}", flush=True)

            # the patch loop on a crafted image, card then CPU
            record.pid = "boost"
            replay.reset()
            img = _boost_image()
            outs, secs = {}, {}
            for side, where in (("card", dev), ("cpu", "cpu")):
                record.side = side
                det = leres.LeresDetector.from_pretrained(
                    paths["leres"], paths["pix2pix"], device=where)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[side] = det(img, boost=True,
                                 detect_resolution=BOOST_DETECT_RES)
                torch.cuda.synchronize()
                secs[side] = time.perf_counter() - t0
                del det
            info = reads[("boost", "card", "boost")][0]
            cpu_info = reads[("boost", "cpu", "boost")][0]
            nets = replay.summary(1)
            top, share = _level_check("the boost", [outs["card"]],
                                      [outs["cpu"]])
            rel = _rel_l2(reads[("boost", "card", "depth")][0],
                          reads[("boost", "cpu", "depth")][0])
            w = info["whole_size"]
            print(f"[annotators_depth] depth_leres++ patch loop at "
                  f"detect_resolution {BOOST_DETECT_RES}: {secs['card']:.2f}"
                  f" s on the card, {secs['cpu']:.2f} s on the CPU (its "
                  f"networks from the card: {nets}); resolution {w} (patch "
                  f"scale {info['patch_scale']:.4f}, factor "
                  f"{info['factor']:.4f}), {len(info['patches'])} patches on"
                  f" the card, {len(cpu_info['patches'])} on the CPU; the "
                  f"boosted depth card vs CPU rel L2 {rel:.3e} (bar "
                  f"{BAR_ANNOTATOR_NETS:g}); out {outs['card'].shape}, "
                  f"largest level difference {top}, differing share "
                  f"{share:.3e}; {card}", flush=True)
            for side, rec in (("card", info), ("CPU", cpu_info)):
                print(f"[annotators_depth] patch rects (x, y, w, h) on the "
                      f"enlarged image / on the image, {side}: "
                      f"{[r for r, _ in rec['patches']]} / "
                      f"{[r for _, r in rec['patches']]}", flush=True)
            if w > BOOST_DETECT_RES or not info["patches"]:
                fail(f"annotators_depth: the boost ran no patch (resolution "
                     f"{w})")
            if info != cpu_info:
                fail("annotators_depth: the boost's decisions differ card "
                     "vs CPU")
            if not rel <= BAR_ANNOTATOR_NETS:
                fail(f"annotators_depth: the boosted depth card vs CPU rel "
                     f"L2 {rel:.3e}")
        finally:
            replay.restore()
            (zoe.ZoeDetector.infer, leres.normalize_16bit,
             mlsd.decode_lines, leres_boost.estimateboost) = originals
    gc.collect()
    torch.cuda.empty_cache()


SAM_IMAGES = 2
SAM_DETECT_RES = 512
# the mask head's craft (sam_scene.seeded_sam): at vit_h's 1024 input the
# module's defaults (20, 3) leave the stability scores of the probe's most
# confident masks at 0 (on an H100, seed SEED + 200)
SAM_MASK_GAIN, SAM_MASK_SHIFT = 40.0, 2.0
# the crafted run's IoU threshold: the first of these quantiles of a probe
# batch's IoUs above which a mask has a non-zero stability score (the CPU
# half takes the passing masks to 512^2 in f64 on the host: the fewer, the
# faster); the stability threshold: the median of those masks' non-zero
# scores
SAM_CRAFT_IOU_QUANTILES = (0.9, 0.8, 0.7, 0.6, 0.5)


def _sam_encoder_macs(cfg):
    """Multiply-adds of one image through a SAM ViT encoder: the patch
    embed; each block's qkv and projection (a windowed block's on its
    grid padded to whole windows), its attention products and the
    relative-position einsums, its MLP; the neck."""
    g, d = cfg.img_size // 16, cfg.dim
    n = g * g
    macs = n * 768 * d + n * d * 256 + n * 256 * 256 * 9
    for i in range(cfg.depth):
        if i in cfg.global_blocks:
            t, win, side = n, n, g
        else:
            t, win, side = (-(-g // 14) * 14) ** 2, 196, 14
        macs += 4 * t * d * d + 2 * t * win * d + 2 * t * side * d
        macs += 8 * n * d * d
    return macs


def _sam_decoder_macs(b, n, t=7, c=256, inner=128):
    """Multiply-adds of the mask decoder for ``b`` one-point prompts (``t``
    tokens: the IoU token, 4 mask tokens, the point and the pad point) on
    an ``n``-token image grid."""
    cross = 2 * t * c * inner + 2 * n * c * inner + 2 * t * n * inner
    layer = (4 * t * c * c + 2 * t * t * c + 2 * cross
             + 2 * t * c * 2048)
    up = n * c * 64 * 4 + 4 * n * 64 * 32 * 4 + 4 * 32 * 16 * n
    heads = 4 * (2 * c * c + c * 32) + 2 * c * c + c * 4
    return b * (2 * layer + cross + up + heads)


def _same_anns(got, want):
    """Fails unless two ``generate`` results hold the same annotations."""
    import numpy as np
    if len(got) != len(want):
        fail(f"sam: {len(got)} masks kept on the card, {len(want)} on the "
             f"CPU")
    for i, (a, b) in enumerate(zip(got, want)):
        same = np.array_equal(a["segmentation"], b["segmentation"]) and all(
            a[k] == b[k] for k in ("area", "bbox", "predicted_iou",
                                   "point_coords", "stability_score",
                                   "crop_box"))
        if not same:
            fail(f"sam: kept mask {i} differs card vs CPU")


def phase_sam(dev):
    """SAM on the card. vit_h at full width (641M parameters) and MobileSAM
    seeded (``sam_scene.seeded_sam``: PyTorch's default init drawn on the
    card, the zero tables and BatchNorm statistics random, the mask head
    crafted so that masks reach past the stability offsets), saved as a
    ``sam_vit_h_4b8939.pth`` (2.56 GB) and a ``mobile_sam.pt`` in the
    published layouts and loaded back through ``Processor("sam")``. Each
    network held card vs CPU (rel L2 <= 1e-4, f32, both TF32 switches on
    around the port's own scope): a windowed and a global vit_h block on
    the 64 x 64 grid, the neck, TinyViT at 1024, one 64-point decoder
    batch. The encoders' images/s at 1024 and the decoder's prompts/s at
    batch 64 by CUDA events. The default generator (32 x 32 points in
    batches of 64, crop layers 0) through the ``Processor`` on 2 synthetic
    512x512 images at detect_resolution 512: s an image by the host clock,
    the networks' share by CUDA events, the masks left after each filter,
    the peak GiB. Then a run that keeps masks: the same vit_h with the
    generator's own thresholds lowered (the IoU's at the 0.9 quantile of a
    probe batch, or a lower one if no mask above it has a non-zero
    stability score; the stability score's at the median of the non-zero
    scores of what passes it) and one crop layer (4 crops with 16 x 16
    points: the crop-edge filter and the NMS across crops), on the card and
    on the CPU, whose half runs every host step of the generator and the
    facade and takes the networks' outputs from the
    card's calls (``_NetReplay``): the same kept masks, boxes, IoUs,
    stability scores and points, and the same canvas under one
    ``np.random.seed``; each of the IoU, stability and NMS filters drops
    some masks and keeps others. No kernel of the repository lies on this
    path."""
    import numpy as np
    from pcdms_tpu_torch.pose import processors
    from pcdms_tpu_torch.pose.detectors import sam, sam_amg
    from pcdms_tpu_torch.pose.detectors.sam_scene import (
        published_state_dict, seeded_sam,
    )
    from pcdms_tpu_torch.pose.dwpose import f32_forward

    card = card_name_and_limit()
    t_files = time.perf_counter()
    images = _annotator_images(SAM_IMAGES)
    g = torch.Generator().manual_seed(SEED + 202)
    made = []
    from_pretrained = sam_amg.SamDetector.__dict__["from_pretrained"]

    def capture(weights, **kw):
        made.append(from_pretrained.__func__(sam_amg.SamDetector, weights,
                                             **kw))
        return made[-1]

    with tempfile.TemporaryDirectory() as root:
        paths, size = {}, 0
        for name, fname in (("vit_h", "sam_vit_h_4b8939.pth"),
                            ("vit_t", "mobile_sam.pt")):
            model = seeded_sam(sam.SAM_CONFIGS[name], SEED + 200, device=dev,
                               gain=SAM_MASK_GAIN, shift=SAM_MASK_SHIFT)
            paths[name] = os.path.join(root, fname)
            torch.save(published_state_dict(model, SEED + 201), paths[name])
            size += os.path.getsize(paths[name])
            del model
        sam_amg.SamDetector.from_pretrained = capture
        try:
            procs = {name: processors.Processor(
                "sam", {"weights": p, "detect_resolution": SAM_DETECT_RES})
                for name, p in paths.items()}
        finally:
            sam_amg.SamDetector.from_pretrained = from_pretrained
    dets = dict(zip(paths, made))
    for name, det in dets.items():
        got = det.mask_generator.model
        if got.cfg != sam.SAM_CONFIGS[name] or got.cfg.tiny != (
                name == "vit_t"):
            fail(f"sam: Processor built {got.cfg} from the {name} file")
        if next(got.parameters()).device.type != torch.device(dev).type:
            fail("sam: the Processor's model is not on the card")
    vit_h = dets["vit_h"].mask_generator.model
    n_params = [sum(p.numel() for p in d.mask_generator.model.parameters())
                / 1e6 for d in dets.values()]
    print(f"[sam] vit_h ({n_params[0]:.2f}M parameters) and MobileSAM "
          f"({n_params[1]:.2f}M, folded) made on the card, saved ({size / 1e9:.2f} GB of files in "
          f"the published layouts) and loaded through Processor('sam') in "
          f"{time.perf_counter() - t_files:.1f} s", flush=True)

    # each network card vs CPU on an input the CPU can afford
    t_nets = time.perf_counter()
    enc = vit_h.image_encoder
    tiny = dets["vit_t"].mask_generator.model.image_encoder
    size = vit_h.cfg.img_size
    grid = torch.randn((1, size // 16, size // 16, vit_h.cfg.dim),
                       generator=g)
    checks = [
        ("vit_h windowed block 0", enc.blocks[0], grid),
        (f"vit_h global block {vit_h.cfg.global_blocks[0]}",
         enc.blocks[vit_h.cfg.global_blocks[0]], grid),
        ("vit_h neck", enc.neck, grid.permute(0, 3, 1, 2).contiguous()),
        (f"TinyViT at {size}", tiny, torch.randn((1, 3, size, size),
                                                generator=g))]
    gen_h = dets["vit_h"].mask_generator
    gen_h._set_image(images[0])
    emb = gen_h._embedding
    pts = sam_amg.build_point_grid(8) * 512.0
    coords = torch.from_numpy(pts.astype(np.float32))[:, None, :]
    labels = torch.ones((64, 1))
    with torch.no_grad(), _tf32_on(), f32_forward():
        for label, net, x in checks:
            got = net(x.to(dev)).cpu()
            want = copy.deepcopy(net).cpu()(x)
            rel = _rel_l2(got, want)
            print(f"[sam] {label}: card vs CPU at {tuple(x.shape[1:])} rel "
                  f"L2 {rel:.3e} (bar {BAR_ANNOTATOR_NETS:g}); {card}",
                  flush=True)
            if not rel <= BAR_ANNOTATOR_NETS:
                fail(f"sam: {label} card vs CPU rel L2 {rel:.3e}")
        cpu_model = copy.deepcopy(vit_h).cpu()
        got = sam.sam_predict_points(vit_h, emb, coords.to(dev),
                                     labels.to(dev))
        want = sam.sam_predict_points(cpu_model, emb.cpu(), coords, labels)
        for what, a, b in zip(("masks", "IoU"), got, want):
            rel = _rel_l2(a.cpu(), b)
            print(f"[sam] the decoder on 64 points, {what} card vs CPU rel "
                  f"L2 {rel:.3e} (bar {BAR_ANNOTATOR_NETS:g}); {card}",
                  flush=True)
            if not rel <= BAR_ANNOTATOR_NETS:
                fail(f"sam: the decoder's {what} card vs CPU rel L2 "
                     f"{rel:.3e}")
    print(f"[sam] the networks checked in "
          f"{time.perf_counter() - t_nets:.1f} s", flush=True)

    # the encoders and the decoder timed on the card
    x = torch.rand((1, 3, size, size), generator=g).to(dev) * 255.0
    enc_macs = _sam_encoder_macs(vit_h.cfg)
    dec_macs = _sam_decoder_macs(64, (size // 16) ** 2)
    enc_ms = cuda_ms(lambda: gen_h._encode(x), iters=3, warmup=1)
    tiny_ms = cuda_ms(lambda: dets["vit_t"].mask_generator._encode(x),
                      iters=5, warmup=1)
    dec_ms = cuda_ms(lambda: gen_h._predict(emb, coords.to(dev),
                                            labels.to(dev)), iters=5)
    print(f"[sam] {card}: vit_h encoder at {size} {enc_ms:.2f} ms, "
          f"{1e3 / enc_ms:.2f} images/s, {2 * enc_macs / 1e12:.2f} TFLOP an "
          f"image, {2 * enc_macs / enc_ms / 1e9:.1f} TFLOP/s = "
          f"{2 * enc_macs / enc_ms / 1e9 / PEAK_F32_FLOPS * 1e12:.1%} of "
          f"the f32 peak; TinyViT {tiny_ms:.2f} ms, {1e3 / tiny_ms:.1f} "
          f"images/s; decoder at batch 64 on the {size // 16}^2 grid "
          f"{dec_ms:.2f} ms, {64e3 / dec_ms:.0f} prompts/s, "
          f"{2 * dec_macs / dec_ms / 1e9:.1f} TFLOP/s (CUDA events)",
          flush=True)

    # the default generator through the Processor, 2 images a model
    for name in ("vit_h", "vit_t"):
        gen = dets[name].mask_generator
        timers = [_NetTimer(gen, "_encode"), _NetTimer(gen, "_predict")]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        counts = []
        for img in images:
            out = procs[name](img, to_pil=False)
            counts.append(dict(gen.counts))
            if out.shape != (512, 512, 3) or out.dtype != np.uint8:
                fail(f"sam: Processor('sam') ({name}) gave {out.shape} "
                     f"{out.dtype}")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / len(images)
        net = [tm.ms() / len(images) / 1e3 for tm in timers]
        for tm in timers:
            tm.restore()
        if counts[0].get("predicted") != 3 * 1024:
            fail(f"sam: the default generator predicted {counts[0]}")
        print(f"[sam] {card}: Processor('sam') ({name}, default generator: "
              f"32 x 32 points, batches of 64) on {len(images)} 512x512 "
              f"images at detect_resolution {SAM_DETECT_RES}: {wall:.3f} s "
              f"an image by the host clock, the encoder {net[0]:.3f} s and "
              f"the decoder {net[1]:.3f} s of it by CUDA events (the host "
              f"and the rest {1 - sum(net) / wall:.1%}); peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; masks "
              f"left after each filter: {counts}", flush=True)

    # a run that keeps masks, on the card and on the CPU
    gen_h._set_image(images[0])
    low, ious = gen_h._predict_batch(pts)
    stab = sam_amg.calculate_stability_score(sam_amg.postprocess_masks(
        low, size, gen_h._input_size, gen_h._orig_size), 0.0, 1.0
    ).cpu().numpy()
    print(f"[sam] the probe batch (64 points, 192 masks): IoU quantiles "
          f"0 / 0.5 / 0.9 / 1 {np.quantile(ious, [0, 0.5, 0.9, 1])}, "
          f"{int((stab > 0).sum())} stability scores above 0, quantiles "
          f"{np.quantile(stab, [0, 0.5, 0.9, 1])}", flush=True)
    for q in SAM_CRAFT_IOU_QUANTILES:
        iou_t = float(np.quantile(ious, q))
        if (stab[ious > iou_t] > 0).any():
            break
    else:
        fail("sam: the probe's confident masks never clear the stability "
             "offsets")
    stab_t = float(np.quantile(stab[(ious > iou_t) & (stab > 0)], 0.5))
    kw = dict(pred_iou_thresh=iou_t, stability_score_thresh=stab_t,
              crop_n_layers=1, crop_n_points_downscale_factor=2)
    replay = _NetReplay((sam.ImageEncoderViT, sam.MaskDecoder),
                        BAR_ANNOTATOR_NETS, "sam")
    anns, canvas, secs, counts = {}, {}, {}, {}
    try:
        for side, model in (("card", vit_h), ("cpu", cpu_model)):
            det = sam_amg.SamDetector(
                model, device=next(model.parameters()).device, **kw)
            generate = det.mask_generator.generate

            def keep(image, generate=generate, side=side):
                anns[side] = generate(image)
                return anns[side]
            det.mask_generator.generate = keep
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            np.random.seed(SEED)
            canvas[side] = det(images[0], detect_resolution=SAM_DETECT_RES,
                               image_resolution=SAM_DETECT_RES)
            torch.cuda.synchronize()
            secs[side] = time.perf_counter() - t0
            counts[side] = dict(det.mask_generator.counts)
        nets = replay.summary(1)
    finally:
        replay.restore()
    _same_anns(anns["card"], anns["cpu"])
    if counts["card"] != counts["cpu"] or not np.array_equal(
            canvas["card"], canvas["cpu"]):
        fail(f"sam: the kept masks' canvas or counts differ card vs CPU: "
             f"{counts}")
    c = counts["card"]
    if not (c["predicted"] > c["iou"] > c["stability"] > 0
            and c["edge"] > c["nms"] >= c["kept"] > 0):
        fail(f"sam: a filter of the crafted run kept all or nothing: {c}")
    colours = len(np.unique(canvas["card"].reshape(-1, 3), axis=0))
    print(f"[sam] {card}: vit_h with the thresholds lowered (IoU > "
          f"{iou_t:.5f}, the {q} quantile of a probe batch; stability >= "
          f"{stab_t:.5f}, the median of the non-zero scores of what passes "
          f"it) and one crop layer on image 0: {secs['card']:.3f} s on the "
          f"card, {secs['cpu']:.2f} s on the CPU (its networks from the card: "
          f"{nets}); masks left after each filter {c}, the same on both "
          f"sides; {len(anns['card'])} kept masks equal card vs CPU "
          f"(segmentation, area, box, IoU, point, stability, crop box), "
          f"the canvas equal ({colours} colours)", flush=True)
    del dets, procs, made, gen_h, vit_h, cpu_model, emb
    gc.collect()
    torch.cuda.empty_cache()


def phase_learning_proof():
    """``cli/learning_proof.main(["--quick", "--assert_improves"])`` on the
    card: the three trainers and the VAE from scratch at the tiny
    configurations on the synthetic world, each stage's batch test, scored
    by the protocol; it raises unless every threshold holds."""
    from pcdms_tpu_torch.cli import learning_proof
    with tempfile.TemporaryDirectory() as root:
        res = learning_proof.main(["--root", root, "--quick",
                                   "--assert_improves"])
    keys = ("ssim", "psnr", "l1")
    print(f"[learning_proof] seconds {res['seconds']}; wall "
          f"{res['wall_s']} s", flush=True)
    print(f"[learning_proof] VAE ceiling "
          f"{res['vae_recon_ssim_ceiling']:.4f}; stage-1 cosine "
          f"{res['stage1_cosine_init']:.4f} -> "
          f"{res['stage1_cosine_trained']:.4f}; "
          + "; ".join(f"stage-{s} " + " / ".join(
              f"{k} {res[f'stage{s}_init'][k]:.4f} -> "
              f"{res[f'stage{s}_trained'][k]:.4f}" for k in keys)
                      for s in (2, 3)), flush=True)


def _learning_proof_child():
    """Start ``phase_learning_proof`` in a child process on the same card
    (TF32 off, as ``main`` sets it), its output into a temporary file ->
    (the process, the file, its start on the host's clock). The proof is
    host-bound at its tiny configurations and leaves the card idle most of
    its time, so it runs beside the phases that read only the host's
    clock, on one CPU thread: a thread per core would spin against theirs
    (its tiny models gain nothing from more)."""
    here = os.path.dirname(os.path.abspath(__file__))
    log = tempfile.TemporaryFile()
    code = ("import torch, chip_smoke; "
            "torch.set_num_threads(1); "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "torch.backends.cudnn.allow_tf32 = False; "
            "chip_smoke._timed(chip_smoke.phase_learning_proof)")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=here, env=env,
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, log, time.perf_counter()


def _join_learning_proof(child):
    """Wait for the learning proof's child process, print its output and
    how long this process waited for it; fail unless it passed."""
    proc, log, t_start = child
    t0 = time.perf_counter()
    rc = proc.wait()
    log.seek(0)
    sys.stdout.write(log.read().decode(errors="replace"))
    log.close()
    print(f"[learning_proof] in a child process: exit code {rc}, "
          f"{time.perf_counter() - t_start:.1f} s from its start to its "
          f"join, {time.perf_counter() - t0:.1f} s of them waited for",
          flush=True)
    if rc != 0:
        fail(f"the learning proof failed (exit code {rc})")


def _timed(phase, *args):
    """Run one phase; print its seconds (host clock, the card waited for)."""
    t0 = time.perf_counter()
    out = phase(*args)
    torch.cuda.synchronize()
    print(f"[time] {phase.__name__}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from pcdms_tpu_torch.ops import flash_attention as fa
    from pcdms_tpu_torch.ops import flash_attention_bwd as fb
    from pcdms_tpu_torch.ops import fused_conv as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    device_name = torch.cuda.get_device_name(0)
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {device_name}; TF32 off for matmul and cuDNN (reference side)",
          flush=True)
    t0 = time.perf_counter()
    _timed(phase_build)
    records = _timed(phase_kernels, fa, fb)
    _timed(phase_clip, fa, dev)
    records["fused_gn_silu_conv"] = _timed(phase_fused_conv, fc)
    for name, recs in _timed(phase_stage3_kernels, fa, fc).items():
        records[name]["stage3_shapes"] = recs
    models = build_models(dev)
    _timed(phase_unet, fa, models, dev)
    launches = _timed(phase_pipeline, fa, models, dev)
    s3_models = build_stage3_models(dev)
    _add(launches, _timed(phase_stage3, fa, s3_models, dev))
    prior = _timed(phase_stage1, dev)
    _add(launches, _timed(phase_cascade, fa, prior, models, s3_models, dev))
    _add(launches, _timed(phase_sampler_options, fa, models, s3_models, dev))
    del models, s3_models, prior
    gc.collect()
    torch.cuda.empty_cache()
    records.update(_timed(phase_bwd_kernels, fb))
    for name, recs in _timed(phase_bwd_stage3, fb).items():
        records[name]["stage3_train_shapes"] = recs
    _timed(phase_unet_grad, fa, dev)
    launches.update(_timed(phase_train, fa, dev))
    _add(launches, _timed(phase_train_stage3, fa, dev))
    _add(launches, _timed(phase_train_stage1, fa, dev))
    _timed(phase_batchtest, fa)
    with tempfile.TemporaryDirectory() as weights_dir:
        metric_weights = _timed(phase_metrics, dev, weights_dir)
        _timed(phase_dwpose, dev)
        with tempfile.TemporaryDirectory() as weights_root:
            counts, weights = _timed(phase_weights, fa, dev, weights_root)
            _add(launches, counts)
            _add(launches, _timed(phase_demo, fa, dev, weights))
            del weights
        _timed(phase_annotators, dev)
        _timed(phase_annotators_depth, dev)
        _timed(phase_sam, dev)
        _add(launches, _timed(phase_lcm, fa, dev))
        # the phases above read device times; those below only the host's
        # clock, beside the learning proof
        child = _learning_proof_child()
        try:
            _add(launches, _timed(phase_train_data, fa, dev))
            _timed(phase_cli)
            _timed(phase_protocol, fa, metric_weights)
            _add(launches, _timed(phase_fastpath_drift, fa, dev))
            _add(launches, _timed(phase_serve, fa, dev))
            _add(launches, _timed(phase_data_parallel, fa, dev))
            _add(launches, _timed(phase_serve_dp, fa, dev))
            _join_learning_proof(child)
        finally:
            if child[0].poll() is None:
                child[0].kill()
                child[0].wait()
    for kernel in KERNELS:
        if not launches.get(kernel):
            fail(f"kernel {kernel} was not launched on its path")
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)

    print(card_name_and_limit())
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=src, replaces=tpu,
             launches=launches[k], **records[k])
        for k, (src, tpu) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
