"""Threaded dataflow combinators: Sequential / Parallel / Batch / Unbatch / Buffer.

Rebuild of the external `pipeline` package the reference pins
(reference pyproject.toml:21; used by moge/train/dataloader.py:63-71 and
moge/test/dataloader.py:55-60): a small host-side threaded pipeline feeding
the card, a generator source, per-stage worker threads connected by bounded
queues, and a blocking ``get()`` at the sink. A copy of the JAX package's
``moge_tpu/utils/pipeline.py`` (pure Python).
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Callable, List, Optional, Sequence

_STOP = object()


class _Stage:
    """Base stage: consumes from self.input, produces to self.output."""

    def __init__(self):
        self.input: Optional[queue.Queue] = None
        self.output: Optional[queue.Queue] = None
        self._threads: List[threading.Thread] = []
        self._stopping = threading.Event()

    def spawn(self):
        raise NotImplementedError

    def start(self):
        self._stopping.clear()
        self.spawn()
        for t in self._threads:
            t.daemon = True
            t.start()

    def stop(self):
        self._stopping.set()
        # drain queues so blocked workers can exit
        for q in (self.input, self.output):
            if q is not None:
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass

    def _put(self, item):
        while not self._stopping.is_set():
            try:
                self.output.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _get(self):
        while not self._stopping.is_set():
            try:
                return self.input.get(timeout=0.1)
            except queue.Empty:
                continue
        return _STOP


class Source(_Stage):
    """Wraps a generator function as the pipeline source."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def spawn(self):
        def run():
            try:
                for item in self.fn():
                    if not self._put(item):
                        return
            finally:
                self._put(_STOP)

        self._threads = [threading.Thread(target=run)]


class Parallel(_Stage):
    """N-way parallel map stage, order-preserving.

    A manager thread keeps a bounded window of items in flight on a thread
    pool and emits results in input order (required so downstream Batch
    groups items that share per-batch properties like target image size).
    """

    def __init__(self, fns: Sequence[Callable]):
        super().__init__()
        self.fns = list(fns)

    def spawn(self):
        def run():
            import collections
            from concurrent.futures import ThreadPoolExecutor

            def safe(fn, item):
                try:
                    return fn(item)
                except Exception:
                    import traceback

                    traceback.print_exc()
                    return None

            window = 2 * len(self.fns)
            with ThreadPoolExecutor(max_workers=len(self.fns)) as pool:
                pending = collections.deque()
                i = 0
                exhausted = False
                while True:
                    while not exhausted and len(pending) < window:
                        item = self._get()
                        if item is _STOP:
                            exhausted = True
                            break
                        pending.append(pool.submit(safe, self.fns[i % len(self.fns)], item))
                        i += 1
                    if not pending:
                        break
                    result = pending.popleft().result()
                    if not self._put(result):
                        return
                    if self._stopping.is_set():
                        return
            self._put(_STOP)

        self._threads = [threading.Thread(target=run)]


class Worker(Parallel):
    """Single-threaded map stage."""

    def __init__(self, fn: Callable):
        super().__init__([fn])


class Batch(_Stage):
    """Group consecutive items into lists of size n."""

    def __init__(self, n: int):
        super().__init__()
        self.n = n

    def spawn(self):
        def run():
            buf = []
            while True:
                item = self._get()
                if item is _STOP:
                    break
                buf.append(item)
                if len(buf) == self.n:
                    if not self._put(buf):
                        return
                    buf = []
            if buf:
                self._put(buf)
            self._put(_STOP)

        self._threads = [threading.Thread(target=run)]


class Unbatch(_Stage):
    """Flatten lists back into a stream of items."""

    def __init__(self):
        super().__init__()

    def spawn(self):
        def run():
            while True:
                item = self._get()
                if item is _STOP:
                    break
                for sub in item:
                    if not self._put(sub):
                        return
            self._put(_STOP)

        self._threads = [threading.Thread(target=run)]


class Buffer(_Stage):
    """Pass-through stage whose output queue has the given capacity."""

    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def spawn(self):
        def run():
            while True:
                item = self._get()
                if item is _STOP:
                    break
                if not self._put(item):
                    return
            self._put(_STOP)

        self._threads = [threading.Thread(target=run)]


class Sequential:
    """Chain stages with bounded queues; use as a context manager.

    Accepts callables (map stages), generator functions (source, first
    position), or stage objects (Parallel/Batch/Unbatch/Buffer).
    """

    def __init__(self, stages: Sequence, queue_size: int = 8):
        built: List[_Stage] = []
        for i, s in enumerate(stages):
            if isinstance(s, _Stage):
                built.append(s)
            elif callable(s) and i == 0:
                built.append(Source(s))
            elif callable(s):
                built.append(Worker(s))
            else:
                raise TypeError(f"Unsupported stage: {s}")
        self.stages = built

        q_prev = None
        for i, s in enumerate(self.stages):
            s.input = q_prev
            cap = s.size if isinstance(s, Buffer) else queue_size
            s.output = queue.Queue(maxsize=cap)
            q_prev = s.output
        self.sink = q_prev
        self._ended = False

    def start(self):
        for s in self.stages:
            s.start()

    def stop(self):
        for s in self.stages:
            s.stop()

    def get(self, timeout: Optional[float] = None) -> Any:
        if self._ended:
            raise StopIteration
        item = self.sink.get(timeout=timeout)
        if item is _STOP:
            self._ended = True
            raise StopIteration
        return item

    def __iter__(self):
        while True:
            try:
                yield self.get()
            except StopIteration:
                return

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
