"""The program's own spans and counters in a traced run.

The program (``moge_tpu_torch.utils.tools``) stores its spans while a
profiler records, so after a traced run its store holds the profiled tail:
``infer``'s stages (``moge.upload``, ``moge.post``, ``moge.solve``, ...)
and the server's (``moge.serve.dispatch``, with the batch's device time
by its CUDA events, ...). ``summary`` reads the store once per run, through the program's
``span_summary``, and keeps it on the run for the other readers. A program
without spans, or a run without a trace, reads None, and so does every
metric below it.
"""

from __future__ import annotations

from typing import Dict, Optional


def summary(run) -> Optional[Dict[str, Dict]]:
    """``span_summary()`` of the run's profiled tail, or None."""
    if not hasattr(run, "program_spans"):
        run.program_spans = _read() if run.trace is not None else None
    return run.program_spans


def _read() -> Optional[Dict[str, Dict]]:
    try:
        from moge_tpu_torch.utils.tools import span_summary
    except ImportError:  # a program without spans
        return None
    return span_summary() or None


def total(run, name: str, field: str) -> Optional[float]:
    """A program span's summed ``host_s`` or ``device_s``, or None."""
    sp = (summary(run) or {}).get(name)
    return sp[field] if sp and sp["count"] and sp[field] > 0 else None


def per_call_ms(run, name: str, field: str) -> Optional[float]:
    """A program span's ``host_s`` or ``device_s`` per call, in ms, or None."""
    seconds = total(run, name, field)
    return seconds / summary(run)[name]["count"] * 1e3 if seconds is not None else None
