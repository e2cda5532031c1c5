"""General utilities (reference moge/utils/tools.py): nested-dict metric
averaging, flatten/unflatten, a timer that waits for the card, a profiler
trace of a block of code, and module import by path. Copies of the JAX
package's ``moge_tpu/utils/tools.py``, the trace by ``torch.profiler``."""

from __future__ import annotations

import importlib.util
import math
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable, Dict, Generator, List, Optional, Union

import torch

__all__ = ["catch_exception", "key_average", "flatten_nested_dict", "unflatten_nested_dict", "timeit",
           "profile_trace", "import_file_as_module", "traverse_nested_dict_keys"]


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
    """A ``torch.profiler`` trace of the block (the host's ops, and the card's
    kernels when a card is present), written into ``log_dir`` as a Chrome
    trace (``trace.json``, for Perfetto or chrome://tracing):

        with profile_trace("/tmp/moge_trace"):
            model.infer(image)
    """

    def __init__(self, log_dir: Union[str, Path]):
        self.log_dir = Path(log_dir)
        self.path = self.log_dir / "trace.json"

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        print(f"profiler trace written to {self.path}")
        return False


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
