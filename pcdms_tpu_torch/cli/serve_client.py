"""Minimal serving client (counterpart of ``examples/serve_client.py``, with
the same flags): build one stage-2 request and POST it to a running
``pcdms-torch-serve`` endpoint.

The wire contract (``serve/http.py``) is tensors in, image out: the client
preprocesses on the host as the batch-test CLI does ([source | black]
canvas, [source pose | target pose] skeleton canvas, DINOv2 features from a
``.npy`` here, since the encoder may not live with the server, the stage-1
embedding) and receives the generated (H, 2W, 3) canvas as npz.

    python -m pcdms_tpu_torch.cli.serve --model stage2 --random_init \\
        --tiny_config --height 64 --width 64 --device cpu --port 8731 &
    python -m pcdms_tpu_torch.cli.serve_client --port 8731 --tiny_demo
"""

from __future__ import annotations

import argparse

import numpy as np


def tiny_demo_request(height, width, rng):
    """Synthetic tensors matching the tiny smoke server's geometry."""
    return dict(
        vae_image=rng.uniform(-1, 1, (height, 2 * width, 3))
        .astype(np.float32),
        st_pose=rng.uniform(-1, 1, (height, 2 * width, 3))
        .astype(np.float32),
        dino_features=rng.normal(
            size=((height // 32) ** 2 + 1, 24)).astype(np.float32),
        embed=rng.normal(size=(16,)).astype(np.float32),
    )


def real_request(args):
    from pcdms_tpu_torch.data.preprocess import (
        black_like, load_image, make_side_by_side, to_neg1_1,
    )
    size = (args.width, args.height)
    s_img = load_image(args.source_image, size)
    s_pose = load_image(args.source_pose, size)
    t_pose = load_image(args.target_pose, size)
    return dict(
        vae_image=to_neg1_1(make_side_by_side(s_img, black_like(s_img))),
        st_pose=to_neg1_1(make_side_by_side(s_pose, t_pose)),
        dino_features=np.load(args.dino_features).astype(np.float32),
        embed=np.load(args.embed).reshape(-1).astype(np.float32),
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="serve_out.png")
    p.add_argument("--tiny_demo", action="store_true",
                   help="synthetic request against the tiny smoke server")
    p.add_argument("--source_image")
    p.add_argument("--source_pose")
    p.add_argument("--target_pose")
    p.add_argument("--dino_features", help=".npy (257, 1536)")
    p.add_argument("--embed", help=".npy (1024,) stage-1 prediction")
    return p.parse_args(argv)


def main(argv=None):
    """Send one request; returns the (H, 2W, 3) f32 image received."""
    args = parse_args(argv)
    from pcdms_tpu_torch.serve.http import post_npz
    if args.tiny_demo:
        req = tiny_demo_request(args.height, args.width,
                                np.random.default_rng(args.seed))
    else:
        req = real_request(args)
    req["seed"] = args.seed

    out = post_npz(args.host, args.port, req)
    img = out["image"]
    print(f"got image {img.shape}, range [{img.min():.2f}, "
          f"{img.max():.2f}]")
    from PIL import Image
    arr = np.clip((img + 1.0) * 127.5, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(args.out)
    print(f"wrote {args.out}")
    return img


if __name__ == "__main__":
    main()
