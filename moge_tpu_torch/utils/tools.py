"""General utilities (reference moge/utils/tools.py): nested-dict metric
averaging, flatten/unflatten, a timer that waits for the card, a profiler
trace of a block of code, the program's spans, and module import by path.
Copies of the JAX package's ``moge_tpu/utils/tools.py``, the trace by
``torch.profiler``.

Spans (``span``, ``span_summary``) name the program's stages on a
profiler's timeline and keep their host and device times. They
are off unless a ``torch.profiler`` session is recording: off, a span reads
one global and returns a shared no-op context, and nothing is stored."""

from __future__ import annotations

import importlib.util
import math
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable, Dict, Generator, List, Optional, Union

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["catch_exception", "key_average", "flatten_nested_dict", "unflatten_nested_dict", "timeit",
           "profile_trace", "span", "span_summary", "import_file_as_module",
           "traverse_nested_dict_keys"]


def catch_exception(fn: Callable) -> Callable:
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            import traceback

            print(f"Exception in {fn.__name__}: {e}")
            traceback.print_exc()
            return None

    return wrapper


def key_average(list_of_dicts: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Average a list of (possibly nested) dicts key-wise, ignoring missing
    keys and non-finite values (reference tools.py:65-83)."""
    keys = set()
    for d in list_of_dicts:
        keys.update(d.keys())
    result: Dict[str, Any] = {}
    for k in keys:
        values = [d[k] for d in list_of_dicts if k in d and d[k] is not None]
        if not values:
            result[k] = None
        elif isinstance(values[0], dict):
            result[k] = key_average(values)
        else:
            nums = [float(v) for v in values if math.isfinite(float(v))]
            result[k] = sum(nums) / len(nums) if nums else float("nan")
    return result


def flatten_nested_dict(d: Dict[str, Any], parent_key: tuple = ()) -> Dict[tuple, Any]:
    """Flatten a nested dict into {tuple_key: value} (reference tools.py:85-97)."""
    items: Dict[tuple, Any] = {}
    for k, v in d.items():
        new_key = parent_key + (k,)
        if isinstance(v, dict):
            items.update(flatten_nested_dict(v, new_key))
        else:
            items[new_key] = v
    return items


def unflatten_nested_dict(d: Dict[tuple, Any]) -> Dict[str, Any]:
    """Inverse of flatten_nested_dict (reference tools.py:100-113)."""
    result: Dict[str, Any] = {}
    for key_tuple, value in d.items():
        node = result
        for k in key_tuple[:-1]:
            node = node.setdefault(k, {})
        node[key_tuple[-1]] = value
    return result


class timeit:
    """Timing context manager / decorator with history averaging
    (reference tools.py:152-207). The bracket opens and closes with
    ``torch.cuda.synchronize()`` when a card is present, so the time is the
    device's work, not its enqueue."""

    _history: Dict[str, List[float]] = defaultdict(list)

    def __init__(self, name: str = "timeit", verbose: bool = True, average: bool = False):
        self.name = name
        self.verbose = verbose
        self.average = average
        self.sync = torch.cuda.is_available()

    def __enter__(self):
        if self.sync:
            torch.cuda.synchronize()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - self.start
        timeit._history[self.name].append(elapsed)
        self.elapsed = elapsed
        if self.verbose:
            if self.average:
                avg = sum(timeit._history[self.name]) / len(timeit._history[self.name])
                print(f"{self.name}: {elapsed * 1e3:.2f} ms (avg {avg * 1e3:.2f} ms)")
            else:
                print(f"{self.name}: {elapsed * 1e3:.2f} ms")
        return False

    def __call__(self, fn: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            with timeit(self.name, self.verbose, self.average):
                return fn(*args, **kwargs)

        return wrapper

    @classmethod
    def history(cls, name: str) -> List[float]:
        return cls._history[name]


class profile_trace:
    """A ``torch.profiler`` trace of the block (the host's ops on every
    thread, a server's dispatcher among them, the program's spans, and the
    card's kernels when a card is present), written into ``log_dir`` as a
    Chrome trace (``trace.json``, for Perfetto or chrome://tracing):

        with profile_trace("/tmp/moge_trace"):
            model.infer(image)
    """

    def __init__(self, log_dir: Union[str, Path]):
        self.log_dir = Path(log_dir)
        self.path = self.log_dir / "trace.json"

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.prof = profile(activities=activities, experimental_config=_all_threads_config())
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        print(f"profiler trace written to {self.path}")
        return False


def _all_threads_config():
    """The profiler config that records the ranges of every thread, those
    started before the profiler included; None where torch lacks it."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
# closed spans: (name, parent's name, host ns, (start, end) CUDA events or None)
_SPANS: List[tuple] = []
_OPEN = threading.local()  # each thread's stack of open span names


class _Span:
    __slots__ = ("name", "device", "args", "host_range", "parent", "range", "events", "t0")

    def __init__(self, name: str, device: bool, args: Optional[Dict[str, Any]], host_range: bool):
        self.name, self.device, self.args, self.host_range = name, device, args, host_range

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.range = None
        if self.host_range:
            # an operator's range, not record_function's user annotation: the
            # profiler copies an annotation onto the device's timeline, where its
            # extent (gaps and all) reads as busy; an operator's range takes the
            # kernels launched inside it outside any other operator instead
            fast = torch._C._profiler._RecordFunctionFast
            self.range = fast(self.name) if self.args is None else fast(self.name, keyword_values=self.args)
            self.range.__enter__()
        self.events = None
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ns = time.perf_counter_ns() - self.t0
        if self.events is not None:
            self.events[1].record()
        if self.range is not None:
            self.range.__exit__(*exc)
        _OPEN.stack.pop()
        if _autograd_profiler._is_profiler_enabled:  # not one the profiler's stop held up
            _SPANS.append((self.name, self.parent, host_ns, self.events))
        return False


def span(name: str, device: bool = False, args: Optional[Dict[str, Any]] = None, host_range: bool = True):
    """A named stage of the program, as a context manager.

    Off unless a ``torch.profiler`` session is recording (on any thread).
    On, it opens a host range ``name`` (``args`` its keyword values), so
    the stage lies on the trace's timeline beside the kernels, and on
    closing, if the profiler still records, stores its host time
    (``perf_counter_ns``) and the name of the span it opened inside; with
    ``device``, also a pair of CUDA events on the current stream around it
    (when CUDA is in use). ``span_summary`` reads the store.

    ``host_range=False`` stores the times and opens no range: for a stage
    that a range of its own caller wraps to read its kernels' device time
    from the trace (the benchmark's ``pb.encoder``, ``pb.decode``), where an
    operator range inside would take the kernels that the ctypes wrappers
    launch outside any operator, and with them move that reading."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, device, args, host_range)


def span_summary() -> Dict[str, Dict[str, Any]]:
    """The spans closed since the last call, by name: ``count``, ``host_s``,
    ``device_s`` (the CUDA events' elapsed time, 0 without events) and
    ``parent`` (the span they were opened inside, first seen). Synchronizes
    the card to resolve the events, then empties the store."""
    spans = _SPANS[:]
    del _SPANS[:len(spans)]
    if any(events is not None for *_, events in spans):
        torch.cuda.synchronize()
    out: Dict[str, Dict[str, Any]] = {}
    for name, parent, host_ns, events in spans:
        s = out.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0, "parent": parent})
        s["count"] += 1
        s["host_s"] += host_ns / 1e9
        if events is not None:
            s["device_s"] += events[0].elapsed_time(events[1]) / 1e3
    return out


def import_file_as_module(path: Union[str, Path], module_name: Optional[str] = None):
    """Import a python file as a module (reference tools.py:285-288)."""
    path = Path(path)
    module_name = module_name or path.stem
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


def traverse_nested_dict_keys(d: Dict[str, Dict]) -> Generator[tuple, None, None]:
    for k, v in d.items():
        if isinstance(v, dict):
            for sub_key in traverse_nested_dict_keys(v):
                yield (k,) + sub_key
        else:
            yield (k,)
