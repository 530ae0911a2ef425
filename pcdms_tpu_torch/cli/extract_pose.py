"""Pose extraction CLI (counterpart of ``pcdms_tpu/cli/extract_pose.py``),
the reference's ``single_extract_pose.py``.

Runs DWPose on an image directory, in sorted name order, and writes per
image the first person's 18 normalised OpenPose joints as
``{out_txt_dir}/{stem}.txt`` (zeros when no person is found) and the
skeleton render with the hands as ``{out_pose_dir}/{stem}_pose.jpg`` at
``--image_resolution`` squared: the reference's dataset layout
(normalized_pose_txt/ + openpose_all_img/).

Give exactly one pair of networks: ``--det_ckpt`` / ``--pose_ckpt`` (the
mmdet YOLOX-l and mmpose DWPose-l checkpoints, run by ``DWposeTorch`` on
``--device``, default CUDA) or ``--det_onnx`` / ``--pose_onnx`` (their
ONNX exports through onnxruntime, which refuses when onnxruntime is not
installed).

    python -m pcdms_tpu_torch.cli.extract_pose --image_dir <imgs> \\
        --out_txt_dir <root>/normalized_pose_txt \\
        --out_pose_dir <root>/openpose_all_img \\
        --det_ckpt yolox_l.pth --pose_ckpt dw-ll_ucoco_384.pth
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

logger = logging.getLogger("pcdms_tpu_torch.extract_pose")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--image_dir", type=str, required=True)
    p.add_argument("--out_txt_dir", type=str, required=True)
    p.add_argument("--out_pose_dir", type=str, required=True)
    p.add_argument("--det_onnx", type=str, default=None,
                   help="YOLOX-l ONNX export")
    p.add_argument("--pose_onnx", type=str, default=None,
                   help="DWPose-l ONNX export")
    p.add_argument("--det_ckpt", type=str, default=None,
                   help="mmdet YOLOX-l checkpoint")
    p.add_argument("--pose_ckpt", type=str, default=None,
                   help="mmpose DWPose-l checkpoint")
    p.add_argument("--image_resolution", type=int, default=512)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'; "
                        "for --det_ckpt / --pose_ckpt")
    args = p.parse_args(argv)
    onnx = (args.det_onnx, args.pose_onnx)
    ckpt = (args.det_ckpt, args.pose_ckpt)
    if not ((all(onnx) and not any(ckpt)) or (all(ckpt) and not any(onnx))):
        p.error("give exactly one pair: --det_ckpt and --pose_ckpt, or "
                "--det_onnx and --pose_onnx")
    return args


def main(argv=None):
    """-> the stems written, in order."""
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    from PIL import Image

    from pcdms_tpu_torch.pose.dwpose import DWposeDetector, DWposeTorch
    from pcdms_tpu_torch.pose.keypoints import write_pose_txt

    if args.det_ckpt:
        detector = DWposeTorch.from_torch(args.det_ckpt, args.pose_ckpt,
                                          device=args.device)
    else:
        detector = DWposeDetector(args.det_onnx, args.pose_onnx)
    os.makedirs(args.out_txt_dir, exist_ok=True)
    os.makedirs(args.out_pose_dir, exist_ok=True)

    names = [n for n in sorted(os.listdir(args.image_dir))
             if n.lower().endswith((".png", ".jpg", ".jpeg"))]
    stems = []
    for i, name in enumerate(names):
        with Image.open(os.path.join(args.image_dir, name)) as im:
            img = np.asarray(im.convert("RGB"))
        render, kpts, _ = detector(
            img, render_size=(args.image_resolution, args.image_resolution))
        stem = name.rsplit(".", 1)[0]
        # first (highest-score) person's 18 joints -> 36-float txt
        coords = kpts[0] if len(kpts) else np.zeros((18, 2), np.float32)
        write_pose_txt(os.path.join(args.out_txt_dir, f"{stem}.txt"),
                       coords)
        Image.fromarray(render).save(
            os.path.join(args.out_pose_dir, f"{stem}_pose.jpg"))
        stems.append(stem)
        if i % 100 == 0:
            logger.info("processed %d/%d", i, len(names))
    return stems


if __name__ == "__main__":
    main()
