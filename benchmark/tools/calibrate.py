"""Readings that the limits of ``limits/<cell>.json`` are set from, on the
card and at the cell's own size, in one process:

    python3 benchmark/tools/calibrate.py --workload <cell> \
        --seeds <n> ... --control-seeds <n> ... [--seconds 0]

For each of ``--seeds``, a whole run of the cell with a short window
(``--seconds``: 0 is one batch, or the requests due in that time) prints
the numbers that its check compares: the program's readings. For each of
``--control-seeds``, the control is put in the program's place: the
reference with every convolution and linear layer in float8 e4m3 (the
precision below the configurations' bfloat16) makes the same requests'
images (or the trainer's first steps), which are compared with the float32
reference's like the program's. For each of ``--fault-seeds`` (the
trainer), the f32 reference with half of each batch left out is.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.drivers.sample import rel_l2  # noqa: E402
from benchmark.weights import derive_seed  # noqa: E402


def control(cell, seed: int, device, fault: str = "control") -> dict:
    """The numbers of the check with the control in the program's place:
    for the samplers the widest relative L2 gap of the fp8 reference's
    images from the f32 reference's, over the check's count of the seed's
    first requests; for the trainer its three numbers for the fp8
    reference's first steps, or (``fault="half"``) for the f32 reference's
    with half of each batch left out."""
    fam = harness.load_module(harness.BENCH / "families"
                              / f"{cell.config['family']}.py")
    p = cell.traffic["params"]
    if cell.traffic["driver"] == "train":
        from benchmark.drivers.train import compare
        batches = [fam.make_train_batch(
            cell.config, [derive_seed(seed, k, i) for i in range(p["batch"])],
            device) for k in range(p["check_steps"])]
        ref = fam.reference_train(cell.config, seed, batches, p, device)
        other = fam.reference_train(
            cell.config, seed, batches, p, device,
            "fp8" if fault == "control" else "f32", half=fault == "half")
        return compare(other, ref)
    n = p.get("check_rows", 2)
    batch = p.get("batch", n)
    rows = fam.make_rows(cell.config, [derive_seed(seed, 0, i)
                                       for i in range(batch)], device)
    imgs = {}
    for precision in ("f32", "fp8"):
        nets = fam.reference_models(cell.config, seed, device, precision)
        imgs[precision] = [fam.reference_row(nets, rows, i, p)
                           for i in range(n)]
        del nets
    return {"image_rel_l2": max(rel_l2(c, r) for c, r in
                                zip(imgs["fp8"], imgs["f32"]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[],
                    help="the trainer's half-batch fault in the reference")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    out = {"workload": cell.name, "card": torch.cuda.get_device_name(dev),
           "program": {}, "control": {}, "fault": {}}
    for s in args.seeds:
        t = time.perf_counter()
        r = harness.run_cell(cell, s, args.seconds, False, dev,
                             time.perf_counter(), log=lambda *a, **k: None)
        out["program"][s] = {k: c["value"] for k, c in r["checks"].items()}
        gc.collect()
        torch.cuda.empty_cache()
        print(f"program seed {s} {out['program'][s]} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    for part, seeds in (("control", args.control_seeds),
                        ("fault", args.fault_seeds)):
        for s in seeds:
            t = time.perf_counter()
            out[part][s] = control(cell, s, dev, "control" if part ==
                                   "control" else "half")
            gc.collect()
            torch.cuda.empty_cache()
            print(f"{part} seed {s} {out[part][s]} "
                  f"({time.perf_counter() - t:.1f} s)", flush=True)
    for part in ("program", "control", "fault"):
        for k in sorted({k for v in out[part].values() for k in v}):
            vals = [v[k] for v in out[part].values()]
            print(f"{part} {k}: min {min(vals)!r} median "
                  f"{float(np.median(vals))!r} max {max(vals)!r} over "
                  f"{len(vals)} seeds")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
