"""Metric sweep CLI (counterpart of ``pcdms_tpu/cli/calculate_metrics.py``),
the reference's ``caculate_metrics_{256,512}.py``.

Computes FID (generated vs the train split), LPIPS and SSIM / PSNR / L1 /
MAE (generated vs the test split, paired by the ``_to_`` file names) at
176x256 (``--resolution 256``) or 352x512 (``--resolution 512``), and
appends the results to ``{save_name}_results.txt``. FID and LPIPS need
local torch weight files (``--inception_weights``: pt_inception /
torchvision InceptionV3; ``--lpips_weights``: lpips AlexNet); without them
those metrics are skipped with a notice. The networks run on ``--device``
(default CUDA); the other metrics are host numpy.

    python -m pcdms_tpu_torch.cli.calculate_metrics --fid_real_path \\
        <train_dir> --test_path <gt_dir> --generated_path <gen_dir> \\
        --resolution 256 --inception_weights pt_inception.pth \\
        --lpips_weights alex.pth
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger("pcdms_tpu_torch.metrics")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--fid_real_path", type=str, required=True,
                   help="train-split image dir (FID reference)")
    p.add_argument("--test_path", type=str, required=True,
                   help="test-split GT image dir")
    p.add_argument("--generated_path", type=str, required=True)
    p.add_argument("--resolution", type=int, default=512,
                   choices=[256, 512])
    p.add_argument("--save_name", type=str, default="metrics")
    p.add_argument("--inception_weights", type=str, default=None)
    p.add_argument("--lpips_weights", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    """Returns {metric: value}, as the results line holds it."""
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    from pcdms_tpu_torch.eval.metrics import (
        FID, ReconstructionMetrics, preprocess_path_for_deform_task,
    )
    from pcdms_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    img_size = (176, 256) if args.resolution == 256 else (352, 512)
    gt_list, distorted_list = preprocess_path_for_deform_task(
        args.test_path, args.generated_path)
    logger.info("%d generated/GT pairs", len(gt_list))

    results = {}

    if args.inception_weights:
        from pcdms_tpu_torch.eval.inception import make_inception_feature_fn
        fid = FID(make_inception_feature_fn(args.inception_weights, device))
        results["fid"] = fid.calculate_from_disk(
            args.generated_path, args.fid_real_path, img_size)
        logger.info("FID: %.4f", results["fid"])
    else:
        logger.warning("skipping FID (no --inception_weights)")

    if args.lpips_weights:
        from pcdms_tpu_torch.eval.lpips import lpips_from_disk
        results["lpips"] = lpips_from_disk(
            args.lpips_weights, distorted_list, gt_list, img_size,
            device=device)
        logger.info("LPIPS: %.4f", results["lpips"])
    else:
        logger.warning("skipping LPIPS (no --lpips_weights)")

    rec_out = ReconstructionMetrics().calculate_from_disk(
        distorted_list, gt_list, save_path=args.generated_path,
        img_size=img_size, sort=False)
    results.update({k: v[0] for k, v in rec_out.items()})
    logger.info("reconstruction: %s", rec_out)

    with open(f"{args.save_name}_results.txt", "a") as f:
        f.write(f"{args.generated_path} {results}\n")
    return results


if __name__ == "__main__":
    main()
