"""Build the CUDA kernels of ``moge_tpu_torch/csrc`` with nvcc and load them.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library with a
plain C interface (``<name>-<hash>.so`` in ``moge_tpu_torch/_build``) and
loaded with ``ctypes``. The hash covers the source, the shared headers and
the compiler flags, so an edited source is rebuilt and an unchanged one is
reused. Nothing is built at import time: a CPU-only install never needs
nvcc.

The kernel-backed ops also register here as dispatcher ops in the ``moge``
namespace (``define_op``: a CUDA implementation that launches the kernel, a
CPU one that runs the plain version, a fake one that gives the output
shapes), so that ``torch.export`` records each launch as one node.
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
from typing import Callable, Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
LIBRARY = torch.library.Library("moge", "FRAGMENT")  # the ops torch.ops.moge.*
BUILD_LOG: Dict[str, str] = {}  # nvcc/ptxas output per kernel (registers, smem, spills)


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


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a nonzero CUDA error code
    (its ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        lib.moge_error_string.restype = ctypes.c_char_p
        lib.moge_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {rc} ({lib.moge_error_string(rc).decode()})")


def call_on(device: torch.device, fn: Callable[..., int], *args) -> int:
    """``fn(*args, stream)`` with PyTorch's current stream on ``device``,
    making ``device`` current only when it is not already."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Grad mode is on and one of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def define_op(schema: str, cuda: Callable, cpu: Callable, fake: Callable) -> None:
    """Register ``moge::<schema>`` with its CUDA (kernel launch), CPU (plain
    version) and fake (output metadata) implementations, unless a copy of
    this package loaded under another name (``tools/host_compare.py``) has
    registered it in this process."""
    name = schema.split("(", 1)[0]
    if hasattr(torch.ops.moge, name):
        return
    LIBRARY.define(schema)
    LIBRARY.impl(name, cuda, "CUDA")
    LIBRARY.impl(name, cpu, "CPU")
    torch.library.register_fake(f"moge::{name}", fake, lib=LIBRARY)


def require_cuda_tensor(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
