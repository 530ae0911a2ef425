"""The traced window: a ``torch.profiler`` of the card, reduced to what the per-layer readers and the breakdown need, and CUDA-event
timers of module calls.

The device's busy time is the union of every device activity's interval
(kernels, copies, sets); an idle gap is labelled by the CUDA runtime call
(a launch, a copy, a synchronise) that the host was in where it began.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import List, Tuple

import torch

NAME_CHARS = 160
TOP = 10


class Profile:
    """The card's activities and the CUDA runtime calls that launched them
    (not every host operation: recording those doubles the host's time of
    a UNet forward and would make the host-bound readings of the untraced
    run unrecognisable). Start with ``start()``, end with ``stop()`` after
    a synchronise."""

    def __init__(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.window_s = None

    def start(self):
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self, notes: dict = None) -> "Summary":
        self.window_s = time.perf_counter() - self._t0
        t = time.perf_counter()
        self.prof.stop()
        summary = Summary(self.prof.profiler.kineto_results.events(),
                          self.window_s)
        if notes is not None:
            notes["trace_reduce_s"] = time.perf_counter() - t
            notes["trace_device_events"] = len(summary.device_events)
        return summary


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Summary:
    def __init__(self, events, window_s: float):
        self.window_s = window_s
        dev, cpu = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            a, b = e.start_ns(), e.end_ns()
            if b <= a:
                continue
            (dev if e.device_type() == cuda else cpu).append((a, b, e.name()))
        self.device_events = dev
        busy = _union([(a, b) for a, b, _ in dev])
        self.busy_s = sum(b - a for a, b in busy) / 1e9
        self.by_name = defaultdict(float)
        for a, b, n in dev:
            self.by_name[n] += (b - a) / 1e9
        self._busy = busy
        cpu.sort()
        self._cpu = cpu
        self._starts = [a for a, _, _ in cpu]

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of activities whose name holds any pattern."""
        return sum(s for n, s in self.by_name.items()
                   if any(p in n for p in patterns))

    def gaps(self):
        """(start_ns, seconds) of each idle stretch between busy ones."""
        b = self._busy
        return [(b[i][1], (b[i + 1][0] - b[i][1]) / 1e9)
                for i in range(len(b) - 1)]

    def _host_op_at(self, t: int) -> str:
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, max(-1, i - 4000), -1):
            a, b, n = self._cpu[j]
            if b >= t:
                return n
        return "(host outside the CUDA runtime)"

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:2000]
        by_op = defaultdict(float)
        for t, s in gaps:
            by_op[self._host_op_at(t)] += s
        idle = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in idle]}


class ModuleTimer:
    """CUDA events around every call of ``module`` (forward hooks)."""

    def __init__(self, module: torch.nn.Module):
        self.pairs = []
        self._open = []
        self._hooks = [module.register_forward_pre_hook(self._pre),
                       module.register_forward_hook(self._post)]

    def _pre(self, *_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._open.append(ev)

    def _post(self, *_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pairs.append((self._open.pop(), ev))

    def remove(self) -> List[float]:
        """Remove the hooks; the milliseconds of each call (after a
        synchronise)."""
        for h in self._hooks:
            h.remove()
        return [a.elapsed_time(b) for a, b in self.pairs]


class CallShapes:
    """Records (B*H, Lq, Lk, d) of every call of the attention modules of
    ``module`` (those with ``heads`` and ``to_q`` / ``to_k``)."""

    def __init__(self, module: torch.nn.Module):
        self.calls = []
        self._hooks = []
        for m in module.modules():
            if hasattr(m, "heads") and hasattr(m, "to_q"):
                self._hooks.append(m.register_forward_hook(self._hook))

    def _hook(self, mod, args, out):
        x = args[0]
        ctx = args[1] if len(args) > 1 and args[1] is not None else x
        hd = mod.to_q.weight.shape[0]
        self.calls.append((x.shape[0] * mod.heads, x.shape[1], ctx.shape[1],
                           hd // mod.heads))

    def remove(self):
        for h in self._hooks:
            h.remove()
        return self.calls
