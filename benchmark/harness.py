"""The benchmark's harness: finds a cell's configuration, traffic, driver,
limits and per-layer readers by the names in ``BENCHMARK.json``, runs the
driver's set-up, measured window and output check, and prints the result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A driver (``drivers/<driver>.py``) is a class ``Driver(run)`` with
``setup()``, ``window()`` (which fills ``run.e2e``, ``run.attempted``,
``run.failed`` and, traced, the fields the readers read), ``release()``
(frees the program's state) and ``check()`` (returns {number: value},
compared with ``limits/<cell>.json`` after the window). A per-layer
reader (``metrics/<metric>.py``) is ``read(run)``: a number, or None when
the run has nothing for it to read.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "pcdms_tpu")


def load_module(path: Path) -> ModuleType:
    """A module from a file (names such as ``serve.mean_batch.py`` are not
    importable by name)."""
    name = "_bench_" + "".join(c if c.isalnum() else "_"
                               for c in path.as_posix())
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, dict]


def load_cell(name: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``, its files found under
    ``bench`` by name."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    lim_path = bench / "limits" / f"{name}.json"
    limits = json.loads(lim_path.read_text()) if lim_path.exists() else {}
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer,
                limits)


class Run:
    """One run of a cell: its arguments, what the driver measured, and the
    traced window's data for the readers."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float, bench: Path = BENCH):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device, self.t_start = bool(trace), device, t_start
        self.bench = bench
        self.config, self.params = cell.config, cell.traffic["params"]
        self.family = load_module(
            bench / "families" / f"{cell.config['family']}.py")
        self.e2e: Dict[str, float] = {}
        self.attempted = self.failed = 0
        self.setup_s: Optional[float] = None
        # the traced window, for the readers
        self.summary = None          # trace.Summary
        self.window_s: Optional[float] = None
        self.window_work = 0         # useful operations done in it
        self.unet_ms: List[float] = []
        self.attn_calls: list = []
        self.engine: Dict[str, float] = {}
        self.peaks: Dict[str, float] = {}
        self.notes: Dict[str, object] = {}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(run: Run, peak: int) -> dict:
    import torch
    info = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(run.device)
                     if run.device.type == "cuda" else "cpu"),
            "count": run.cell.chips, "memory_peak_bytes": int(peak)}
    if run.trace and run.summary is not None:
        info["busy_s"] = run.summary.busy_s
        info["window_s"] = run.summary.window_s
    return info


def card_peaks(kind: str, bench: Path = BENCH) -> Dict[str, float]:
    table = json.loads((bench / "peaks.json").read_text())
    return table.get(kind, {})


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, bench: Path = BENCH, log=print) -> Optional[dict]:
    """Set-up, window, check and readers of one run; the result's dict, or
    None (after a message on stderr) where a forbidden module loaded."""
    import torch
    run = Run(cell, seed, seconds, trace, device, t_start, bench)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        run.peaks = card_peaks(torch.cuda.get_device_name(device), bench)
    driver = load_module(bench / "drivers"
                         / f"{cell.traffic['driver']}.py").Driver(run)
    driver.setup()
    run.setup_s = time.perf_counter() - t_start
    driver.window()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the run: {bad}", file=sys.stderr)
        return None
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    values = driver.check()
    run.notes["check_s"] = time.perf_counter() - t
    checks = {}
    for k, v in values.items():
        limit = cell.limits.get(k, {}).get("limit")
        checks[k] = {"value": v, "limit": limit}
    correct = (run.failed == 0 and bool(checks) and all(
        c["limit"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values()))
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = load_module(bench / "metrics" / f"{m['name']}.py").read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = (run.setup_s if m["name"] == "setup_s"
                     else run.e2e.get(m["name"]))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_info(run, peak)}
    if trace and run.summary is not None:
        result["breakdown"] = run.summary.breakdown()
    result["checks"] = checks
    for k, v in run.notes.items():
        log(f"note {k} {v}", file=sys.stderr)
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return result
