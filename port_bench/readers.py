"""What the metric readers share: the cell's shapes, and the trace's spans and kernels."""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import roofline, trace


def tokens(run) -> int:
    w, cfg = run.workload, run.config["model_config"]
    if "num_tokens" in w:
        return w["num_tokens"]
    lo, hi = cfg["num_tokens_range"]
    return int(lo + (w["resolution_level"] / 9) * (hi - lo))


def shape(run):
    """(version, model config, batch, height, width, tokens, dtype) of a closed-loop cell."""
    w = run.workload
    return (run.config["version"], run.config["model_config"], w["batch"], w["height"], w["width"], tokens(run),
            run.config["dtype"])


def span(run, name: str, field: str) -> Optional[float]:
    """A span's summed ``host_s`` or ``device_s`` in the trace, or None."""
    sp = (run.trace or {}).get("spans", {}).get(name)
    return sp[field] if sp and sp["count"] and sp[field] > 0 else None


def per_image_ms(run, seconds: Optional[float]) -> Optional[float]:
    images = (run.trace or {}).get("images", 0)
    return seconds / images * 1e3 if seconds and images else None


def launches_per_image(run) -> Optional[float]:
    t = run.trace
    return t["launches"] / t["images"] if t and t["images"] and t["launches"] else None


def solve_ms(run) -> Optional[float]:
    host = span(run, "pb.solve", "host_s")
    return host / run.trace["spans"]["pb.solve"]["count"] * 1e3 if host is not None else None


def idle_share(run) -> Optional[float]:
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t and t["window_s"] > 0 else None


def peak_gib(run) -> float:
    return run.window_peak / 2 ** 30


def roofline_share(run, names, least_s_per_forward) -> Optional[float]:
    """Least time of the traced forwards over the matched kernels' device time, in %."""
    t = run.trace
    if not t or not t.get("batches"):
        return None
    seconds = trace.kernel_seconds(t, names)
    if seconds is None:
        return None
    return 100.0 * t["batches"] * least_s_per_forward / seconds


def mfu(run) -> Optional[float]:
    """Model operations of the images completed outside the profiler over
    that time at the peak of the cell's dtype, in %."""
    version, cfg, batch, h, w, n, dtype = shape(run)
    images, seconds = run.records["images"], run.records["window_s"]
    if not images or seconds <= 0:
        return None
    flops = roofline.model_flops(version, cfg, 1, h, w, n) * images
    return 100.0 * flops / seconds / roofline.PEAK_FLOPS[dtype]


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, interpolated linearly between order
    statistics; infinite where either of them is (an unanswered request)."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    k = q / 100 * (len(v) - 1)
    lo, hi = int(np.floor(k)), int(np.ceil(k))
    if not np.isfinite(v[hi]):
        return float("inf")
    return float(v[lo] + (v[hi] - v[lo]) * (k - lo))
