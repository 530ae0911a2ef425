"""``BENCHMARK.json`` keeps to the benchmark's contract, and a new
configuration, traffic mix, cell, per-layer metric or kernel file is found
by name with no existing file edited."""

import json
import math
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness, roofline
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _reports(cell):
    return harness.load_cell(cell)


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(SPEC["configs"]) <= 24
    # a full check of 24 cells fits its budget at this run length
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, cells // 4)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_paths_and_command():
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (ROOT / p).is_dir() and not p.startswith("/")
    assert len(SPEC["command"]) <= 32
    assert SPEC["command"][1].startswith(tuple(SPEC["paths"]))


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_names_units_keys(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()


def test_names_unique_and_allowed():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert c["name"] in {w["config"] for w in SPEC["workloads"]}


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_enough(w):
    cell = _reports(w["name"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        # the metric's end-to-end metric is reported where it is
        assert m["moves"] in e2e, (m["name"], w["name"])
    assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()


def test_per_layer_workloads_name_cells():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_kernel_family_found():
    names, routes, ops, nbytes = roofline.family(ROOT / "benchmark",
                                                 "attention")
    assert "flash_fwd_bf16" in names and "frozen" in routes
    assert ops(1, 2, 3, 4) == 4 * 1 * 2 * 3 * 4


def test_new_files_found_by_name(tmp_path):
    """A configuration, traffic mix, cell, limits file, per-layer reader
    and kernel file added as files are found, and the reader reports."""
    root = tmp_path
    bench = root / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = tiny.tiny_config(json.loads(
        (bench / "configs" / "pcdms-stage3-sd21.json").read_text()))
    cfg["name"] = "tiny-stage3"
    (bench / "configs" / "tiny-stage3.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny-sample.json").write_text(json.dumps(
        {"driver": "sample", "params": dict(
            batch=2, num_steps=2, scheduler="unipc", guidance_scale=2.0,
            distinct_batches=1, check_rows=1, trace_batches=1)}))
    (bench / "limits" / "t3-tiny.json").write_text(json.dumps(
        {"image_rel_l2": {"limit": 0.05}}))
    (bench / "metrics" / "probe.attempted.py").write_text(
        "def read(run):\n    return float(run.attempted)\n")
    (bench / "kernels" / "attention" / "probe.json").write_text(json.dumps(
        {"device_names": ["probe_kernel"], "routes": ["online"],
         "ops": "attention", "bytes": "attention_bytes"}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-stage3", "source": "test",
                            "file": "benchmark/configs/tiny-stage3.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "t3-tiny", "config": "tiny-stage3",
                              "traffic": "tiny-sample", "chips": 1,
                              "why": "test"})
    spec["end_to_end"][0]["workloads"].append("t3-tiny")
    spec["per_layer"].append({"name": "probe.attempted", "unit": "images",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "images_per_s",
                              "workloads": ["t3-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell("t3-tiny", root=root, bench=bench)
    assert cell.config["name"] == "tiny-stage3"
    assert [m["name"] for m in cell.per_layer] == ["probe.attempted"]
    r = harness.run_cell(cell, 2**31 + 99, 0.1, True, torch.device("cpu"),
                         time.perf_counter(), bench=bench,
                         log=lambda *a, **k: None)
    assert r["correct"] and r["metrics"]["probe.attempted"]["value"] == 2.0
    names, routes, _, _ = roofline.family(bench, "attention")
    assert "probe_kernel" in names and "online" in routes
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_result_line_keys():
    r = tiny.run_tiny("s3-sample-b16-unipc20")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"images_per_s", "setup_s"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in r["metrics"].values())
