"""Run one cell of the benchmark of ``pcdms_tpu_torch`` on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result's JSON object; the numbers
compared with the plain reference, each beside its limit, are the last
lines of standard error. Exits with 3, printing no result, where CUDA is
missing or the card count is short, and with 4 where a JAX module was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """``time.perf_counter()`` at this process's start (from /proc), or at
    the top of this file where /proc has no answer."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return T_START - max(0.0, uptime - start
                             - (time.perf_counter() - T_START))
    except (OSError, ValueError, IndexError):
        return T_START


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()

    # fixed cache directories inside the checkout; no JAX through libraries
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    from benchmark import harness
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              t_start)
    bad = harness.forbidden_modules()
    if result is None or bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
