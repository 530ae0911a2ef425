"""Roofline shares of a kernel family in the traced window.

``kernels/<family>/*.json`` name, for each implementation of the family,
the device names of its kernels, the program's routes that reach it, and
the functions of ``flops.py`` that count a call's operations and bytes
from its shapes. A later implementation adds a file here, and the share
keeps counting the same work whatever implements it.
"""

from __future__ import annotations

import json

from benchmark import flops


def family(bench, name: str):
    """(device name patterns, routes, ops function, bytes function)."""
    names, routes, fns = [], set(), set()
    for path in sorted((bench / "kernels" / name).glob("*.json")):
        spec = json.loads(path.read_text())
        names += spec["device_names"]
        routes |= set(spec["routes"])
        fns.add((spec["ops"], spec["bytes"]))
    if len(fns) != 1:
        raise ValueError(f"kernel family {name}: one work count, got {fns}")
    ops, nbytes = (getattr(flops, f) for f in fns.pop())
    return names, routes, ops, nbytes


def share(run, name: str):
    """The routed calls' least time over their kernels' device time (%),
    or None where the window has no such call or no such kernel."""
    peak_f, peak_b = run.peaks.get("bf16_flops"), run.peaks.get("hbm_bytes_s")
    if run.summary is None or not run.attn_calls or not peak_f:
        return None
    from pcdms_tpu_torch.ops.flash_attention import attention_route
    names, routes, ops, nbytes = family(run.bench, name)
    calls = [c for c in run.attn_calls if attention_route(c[2]) in routes]
    seconds = run.summary.kernel_seconds(names)
    if not calls or seconds <= 0:
        return None
    bound = sum(flops.roofline_seconds(ops(*c), nbytes(*c), peak_f, peak_b)
                for c in calls)
    return 100.0 * bound / seconds
