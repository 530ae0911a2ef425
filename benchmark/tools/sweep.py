"""The highest rate that a serving cell's service sustains, found once by a
sweep on the card (the cell's traffic file then fixes its rate at about
four fifths of it):

    python3 benchmark/tools/sweep.py --workload <cell> --seed <n> \
        --seconds 40 --rates 1.6 2.0 2.4 2.8

One set-up, then for each rate the cell's open loop at that rate: the
requests completed per second of the window, the median and 90th
percentile latency from due, and whether the backlog grew (the mean
latency of the last third of the requests against the first third's).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.drivers import serve_open_loop as sol  # noqa: E402
from benchmark.weights import derive_seed  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    run = harness.Run(cell, args.seed, args.seconds, False, dev,
                      time.perf_counter())
    fam, cfg, p = run.family, run.config, run.params
    models = fam.program_models(cfg, args.seed, dev)
    n = int(round(max(args.rates) * args.seconds))
    seeds = [derive_seed(args.seed, j) for j in range(n)]
    host = sol.host_requests(fam, cfg, seeds, dev)
    service = fam.make_service(models, cfg, p, dev)
    service.engine.warmup(service._example())
    print(f"card {torch.cuda.get_device_name(dev)}", flush=True)
    try:
        for rate in args.rates:
            due = sol.arrival_times(rate, args.seconds)
            futs, done, t0, late, _ = sol.drive(
                lambda j: fam.submit(service, host, j, seeds[j]), due)
            lat, failed = sol.latencies(futs, done, t0, due)
            third = max(1, len(lat) // 3)
            span = max(done.values()) - t0
            print(f"rate {rate} offered {len(due)} completed "
                  f"{len(done)} in {span:.2f} s ({len(done) / span:.3f}/s) "
                  f"failed {failed} p50 {sol.percentile(lat, 50):.3f} "
                  f"p90 {sol.percentile(lat, 90):.3f} first-third mean "
                  f"{np.mean(lat[:third]):.3f} last-third mean "
                  f"{np.mean(lat[-third:]):.3f} late max {max(late):.3f}",
                  flush=True)
    finally:
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
