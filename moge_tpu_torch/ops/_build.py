"""Build the CUDA kernels of ``moge_tpu_torch/csrc`` with nvcc, and join them
to the program.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library with a
plain C interface (``<name>-<hash>.so`` in ``moge_tpu_torch/_build``) and
loaded with ``ctypes``. The hash covers the source, the shared headers and
the compiler flags, so an edited source is rebuilt and an unchanged one is
reused. Nothing is built at import time: a CPU-only install never needs
nvcc.

Every hand-written kernel joins the program through this module:

- ``Entry``: a C entry point, typed once from its argtypes. A call launches
  on the tensors' device and PyTorch's current stream, raises on a CUDA
  error and counts the launch under (kernel, variant).
- ``LAUNCHES``: the one launch registry, (kernel, variant) -> launches,
  read by ``read_launches`` and set to zero by ``reset_launches``. Plain
  versions count nothing.
- ``kernel_op``: registers an op ``moge::<name>`` (``define_op``: a CUDA
  implementation that launches the kernel, a CPU one that runs the plain
  version, a fake one that gives the output shapes, so that ``torch.export``
  records each launch as one node) and returns the ``Router`` of its public
  entry.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ._vjp import PlainVJP

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
LIBRARY = torch.library.Library("moge", "FRAGMENT")  # the ops torch.ops.moge.*
BUILD_LOG: Dict[str, str] = {}  # nvcc/ptxas output per kernel (registers, smem, spills)
# (kernel, variant) -> launches since the last reset, every declared variant present (a plain dict: an
# increment costs a third of a Counter's)
LAUNCHES: Dict[Tuple[str, Optional[str]], int] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are built from source on first use")


def _digest(src: Path) -> str:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built if missing)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    so = BUILD_DIR / f"{name}-{_digest(src)}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        BUILD_LOG[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib


def build_all() -> Dict[str, float]:
    """Build (or load) every kernel library, one nvcc per source, all started
    together; seconds taken per kernel."""

    def timed(name: str) -> float:
        t0 = time.perf_counter()
        load(name)
        return time.perf_counter() - t0

    names = [src.stem for src in sorted(CSRC.glob("*.cu"))]
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(timed, names)))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a nonzero CUDA error code
    (its ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        lib.moge_error_string.restype = ctypes.c_char_p
        lib.moge_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {rc} ({lib.moge_error_string(rc).decode()})")


def define_op(schema: str, cuda: Callable, cpu: Callable, fake: Callable) -> str:
    """Register ``moge::<schema>`` with its CUDA (kernel launch), CPU (plain
    version) and fake (output metadata) implementations, unless a copy of
    this package loaded under another name (``tools/host_compare.py``) has
    registered it in this process. Returns the op's name."""
    name = schema.split("(", 1)[0]
    if hasattr(torch.ops.moge, name):
        return name
    LIBRARY.define(schema)
    LIBRARY.impl(name, cuda, "CUDA")
    LIBRARY.impl(name, cpu, "CPU")
    torch.library.register_fake(f"moge::{name}", fake, lib=LIBRARY)
    return name


def require_cuda_tensor(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")


def declare(kernel: str, variants: Sequence[Optional[str]] = (None,)) -> None:
    """Put ``kernel`` and its variants in the registry, at zero launches."""
    for variant in variants:
        LAUNCHES.setdefault((kernel, variant), 0)


def count(kernel: str, variant: Optional[str] = None, n: int = 1) -> None:
    """Count ``n`` launches of ``kernel`` that no ``Entry`` made."""
    LAUNCHES[kernel, variant] = LAUNCHES.get((kernel, variant), 0) + n


def reset_launches() -> None:
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))


def read_launches() -> Dict[str, Dict[Optional[str], int]]:
    """Launches since the last reset: kernel -> variant -> count, every
    declared kernel and variant included."""
    read: Dict[str, Dict[Optional[str], int]] = {}
    for (kernel, variant), n in LAUNCHES.items():
        read.setdefault(kernel, {})[variant] = n
    return read


class Entry:
    """The C entry point ``symbol`` of ``csrc/<library>.cu``: an int-returning
    function of ``argtypes`` whose last argument is the CUDA stream, typed
    once when first called. ``entry(variant, device, *args)`` launches it
    on ``device`` on PyTorch's current stream there (making ``device``
    current only when it is not already), raises on a CUDA error (``check``,
    under the kernel's name) and counts one launch of ``kernel`` under
    ``variant``, one of ``variants``."""

    def __init__(self, kernel: str, library: str, symbol: str, argtypes: Sequence,
                 variants: Sequence[Optional[str]] = (None,)):
        self.kernel, self.library, self.symbol, self.argtypes = kernel, library, symbol, list(argtypes)
        self._lib = self._fn = None
        declare(kernel, variants)

    def function(self):
        """The typed ctypes function (the library built and loaded on first use)."""
        if self._fn is None:
            lib = load(self.library)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def __call__(self, variant: Optional[str], device: torch.device, *args) -> None:
        if self._fn is None:
            self.function()
        if device.index == torch.cuda.current_device():
            rc = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(device):
                rc = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        check(self._lib, rc, self.kernel)
        LAUNCHES[self.kernel, variant] += 1


class Router:
    """The public entry of a kernel-backed op, by four routes in this order:
    without a gradient to take while a program is traced, the op ``op``; a
    CPU tensor, the plain version ``plain``; without a gradient, the launch
    ``launch``, called directly (the dispatcher's hop costs host time on
    every call: PERF.md); else ``autograd``. A gradient is to be taken when
    grad mode is on and one of the first ``grad_args`` arguments requires
    it; the first argument's device decides the rest. Each route is an
    attribute, so a test can put a spy in its place."""

    def __init__(self, name: str, grad_args: int, op: Callable, plain: Callable, launch: Callable,
                 autograd: Optional[Callable]):
        self.name, self.grad_args = name, grad_args
        self.op, self.plain, self.launch, self.autograd = op, plain, launch, autograd

    def __call__(self, *args):
        grad = torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args[:self.grad_args])
        if not grad and torch.compiler.is_compiling():
            return self.op(*args)
        if args[0].device.type == "cpu":
            return self.plain(*args)
        require_cuda_tensor(args[0], self.name)
        if not grad:
            return self.launch(*args)
        return self.autograd(*args)


def _contiguous(plain: Callable) -> Callable:
    """``plain`` with each output made contiguous, as the fake's outputs are."""

    def cpu(*args):
        out = plain(*args)
        return tuple(t.contiguous() for t in out) if isinstance(out, tuple) else out.contiguous()

    return cpu


def kernel_op(schema: str, launch: Callable, plain: Callable, fake: Callable,
              autograd: Optional[Callable] = None) -> Router:
    """Register ``moge::<schema>`` (``define_op``: CUDA ``launch``, CPU
    ``plain`` with contiguous outputs, ``fake``) and return the ``Router`` of
    its public entry over the schema's arguments. The gradient route is
    ``autograd``, by default the kernel forward with the autograd VJP of
    ``plain`` as its backward (``_vjp.PlainVJP``); the schema's Tensor
    arguments decide whether a gradient is to be taken."""
    name = define_op(schema, launch, _contiguous(plain), fake)
    params = schema[schema.index("(") + 1:schema.index(")")].split(",")
    grad_args = sum(p.split()[0].startswith("Tensor") for p in params)
    if autograd is None:
        autograd = functools.partial(PlainVJP.apply, launch, plain)
    return Router(name, grad_args, getattr(torch.ops.moge, name), plain, launch, autograd)
