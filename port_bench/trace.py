"""Spans around the program's layers and the reduction of a profiler trace.

In a traced run (``--trace 1``) ``Spans`` wraps the calls into the
program's layers in ``record_function`` ranges (``pb.encoder``,
``pb.decode`` or ``pb.head``, ``pb.solve``), and ``Profile`` runs
``torch.profiler`` (host ops and CUPTI device activity) over a tail of the
window, inside a ``pb.window`` range. ``Profile.summary`` reduces the trace
to what the per-layer readers take: the device's busy intervals, each
span's host and device time, the host's launch calls and the kernels by
name, plus the breakdown that the result line carries.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                "cudaLaunchCooperativeKernel")


class Spans:
    """``record_function`` ranges around the program's layers, undone by ``remove``."""

    def __init__(self):
        self._undo: List[Callable[[], None]] = []

    def module(self, module: torch.nn.Module, name: str) -> None:
        """A range over every call of ``module`` (forward hooks)."""
        stack = []

        def pre(_m, _args):
            rf = record_function(name)
            rf.__enter__()
            stack.append(rf)

        def post(_m, _args, _out):
            stack.pop().__exit__(None, None, None)

        handles = [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
        self._undo.append(lambda: [h.remove() for h in handles])

    def function(self, owner, attr: str, name: str) -> None:
        """A range over every call of ``owner.attr`` (a module's function or an instance's method)."""
        original = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            with record_function(name):
                return original(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, original))

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()


class Profile:
    """``torch.profiler`` over a stretch of the window, started and stopped by the traffic driver."""

    def __init__(self):
        self.prof: Optional[profile] = None
        self.start_s = self.stop_s = None
        self._window = None

    def start(self) -> None:
        try:  # the ranges of every thread: the server launches from its dispatcher thread
            config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        except (AttributeError, TypeError):
            config = None
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], experimental_config=config)
        self.prof.__enter__()
        self._window = record_function("pb.window")
        self._window.__enter__()
        self.start_s = time.perf_counter()

    @classmethod
    def warmed(cls, device) -> "Profile":
        """A profile whose profiler has been started once already: the first
        start sets up CUPTI, which takes seconds."""
        warm = cls()
        warm.start()
        torch.ones(1, device=device).add_(1)
        warm.stop()
        return cls()

    @property
    def active(self) -> bool:
        return self.prof is not None and self.stop_s is None

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.stop_s = time.perf_counter()
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def summary(self) -> Dict:
        """The trace reduced: window and busy seconds, spans (count, host
        and device seconds), launch calls, kernel seconds by name, and the
        breakdown."""
        events = self.prof.events()
        window = [e for e in events if e.name == "pb.window" and e.device_type == DeviceType.CPU]
        w0, w1 = window[0].time_range.start, window[0].time_range.end
        device, cpu = [], []
        for e in events:
            if e.device_type == DeviceType.CUDA:  # kernels and copies; not the ranges' device-side copies
                if not e.name.startswith("pb.") and e.time_range.end > e.time_range.start:
                    device.append((e.time_range.start, e.time_range.end, e.name))
            elif e.device_type == DeviceType.CPU:
                cpu.append(e)
        intervals = _union([(max(s, w0), min(t, w1)) for s, t, _ in device if t > w0 and s < w1])
        busy_us = sum(t - s for s, t in intervals)
        kernels_s: Dict[str, float] = defaultdict(float)
        for s, t, name in device:
            kernels_s[name] += (t - s) / 1e6
        spans: Dict[str, Dict[str, float]] = defaultdict(lambda: {"count": 0, "host_s": 0.0, "device_s": 0.0})
        for e in cpu:
            if e.name.startswith("pb.") and e.name != "pb.window":
                sp = spans[e.name]
                sp["count"] += 1
                sp["host_s"] += (e.time_range.end - e.time_range.start) / 1e6
                sp["device_s"] += e.device_time_total / 1e6
        launches = sum(1 for e in cpu if e.name in LAUNCH_CALLS)
        top = sorted(kernels_s.items(), key=lambda kv: -kv[1])[:10]
        return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6, "spans": dict(spans), "launches": launches,
                "kernels_s": dict(kernels_s),
                "breakdown": {"device_ops": [[name, s] for name, s in top],
                              "idle_gaps": _idle_gaps(intervals, w0, w1, cpu)}}


def _union(intervals):
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _idle_gaps(intervals, w0, w1, cpu, longest: int = 400) -> List[list]:
    """The device's idle time summed by what the host was doing when each
    gap began (the innermost host event spanning that moment), over the
    ``longest`` gaps; the ten largest sums."""
    edges = [w0] + [x for s, t in intervals for x in (s, t)] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
    cpu = [e for e in cpu if e.name != "pb.window"]
    if not gaps or not cpu:
        return []
    starts = np.array([e.time_range.start for e in cpu], dtype=np.float64)
    ends = np.array([e.time_range.end for e in cpu], dtype=np.float64)
    names = [e.name for e in cpu]
    totals: Dict[str, float] = defaultdict(float)
    for s, t in gaps:
        inside = np.nonzero((starts <= s) & (ends > s))[0]
        label = names[inside[np.argmin(ends[inside] - starts[inside])]] if len(inside) else "(no host event)"
        totals[label] += (t - s) / 1e6
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:10]]


def kernel_seconds(summary: Dict, names) -> Optional[float]:
    """Device seconds of the kernels whose name contains one of ``names``; None if none ran."""
    total = sum(s for k, s in summary["kernels_s"].items() if any(n in k for n in names))
    return total if total > 0 else None
