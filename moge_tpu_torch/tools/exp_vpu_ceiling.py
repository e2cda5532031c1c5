"""The FP32-pipe ceiling of the dense-align pair op on one CUDA GPU (port of
tools/exp_vpu_ceiling.py, probe T2).

    python -m moge_tpu_torch.tools.exp_vpu_ceiling [--device cpu]

A (256, 512) fp32 tile held in registers runs 2000 iterations of
``acc += min(1, |a * x - y|)`` (``align``, the pair op of the dense
truncated-L1 objective) or ``acc += a * x + y`` (``fma``), a = 1 + i * 1e-6,
with no device-memory traffic in the loop (kernel ``csrc/exp_vpu_ceiling.cu``).
For each kind it prints the time per launch (CUDA events around 200
back-to-back launches, least of 5), the element-iterations per second, the
card's FP32 instructions per element-iteration (3 for ``align``: FFMA, FMNMX
with |.|, FADD; 2 for ``fma``) and the instruction rate they reach against the
card's 132 SMs x 128 lanes x SM clock: the measured rate of the align pair
op that K4 and the dense layouts of ``exp_dense_pallas`` are read against
(the tile is ~2 blocks per SM, so larger problems can run above it). ``--device cpu``
rehearses the plain version, with host-clock times that say nothing of the card.
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Dict, List

import numpy as np
import torch

from ..ops import _build
from . import roofline

__all__ = ["vpu_ceiling", "vpu_ceiling_plain", "measure", "main", "SHAPE", "ITERS", "INSTRUCTIONS", "REL_TOL"]

SHAPE = (256, 512)  # the resident tile of the TPU probe
ITERS = 2000
INSTRUCTIONS = {"align": 3, "fma": 2}  # FP32 instructions per element-iteration on the card
_MAX_ITERS = 8192   # the kernel keeps the a values in shared memory
# against the plain loop, max |difference| over max |acc|: a * x - y rounded
# once (FMA) or twice, and 2000 fp32 sums; both kinds read 1.4e-7 to 1.1e-6
REL_TOL = 5e-6
T2 = _build.Entry("exp_vpu_ceiling", "exp_vpu_ceiling", "moge_vpu_ceiling",
                  [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p], variants=tuple(INSTRUCTIONS))


def _a(i: int) -> float:
    """a = 1 + i * 1e-6 in fp32, rounded after the product and after the sum, as JAX computes it."""
    return float(np.float32(1.0) + np.float32(i) * np.float32(1e-6))


def vpu_ceiling_plain(x: torch.Tensor, y: torch.Tensor, kind: str, iters: int = ITERS) -> torch.Tensor:
    """The probe's loop in PyTorch: one elementwise pass per iteration."""
    acc = torch.zeros_like(x)
    for i in range(iters):
        a = _a(i)
        acc += (a * x - y).abs().clamp_max(1.0) if kind == "align" else a * x + y
    return acc


def vpu_ceiling(x: torch.Tensor, y: torch.Tensor, kind: str, iters: int = ITERS, launches: int = 1) -> torch.Tensor:
    """``acc`` after ``iters`` iterations of the ``kind`` pair op over fp32
    ``x``, ``y``. CUDA tensors run kernel T2 ``launches`` times back to back
    (each writes the same result), each launch counted under ``kind``; CPU
    tensors run ``vpu_ceiling_plain``."""
    if kind not in INSTRUCTIONS:
        raise ValueError(f"kind must be one of {sorted(INSTRUCTIONS)}, got {kind!r}")
    if x.device.type == "cpu":
        return vpu_ceiling_plain(x, y, kind, iters)
    for name, t in (("x", x), ("y", y)):
        _build.require_cuda_tensor(t, f"vpu_ceiling {name}")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.shape != x.shape or t.device != x.device:
            raise ValueError(f"vpu_ceiling takes contiguous fp32 x and y of one shape and device, "
                             f"got {name} {t.dtype} {tuple(t.shape)}")
    if not 0 <= iters <= _MAX_ITERS or launches < 1 or x.numel() == 0:
        raise ValueError(f"vpu_ceiling needs 0 <= iters <= {_MAX_ITERS}, launches >= 1 and a nonempty tile")
    out = torch.empty_like(x)
    T2(kind, x.device, x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), iters, list(INSTRUCTIONS).index(kind),
       launches)
    _build.count(T2.kernel, kind, launches - 1)  # the entry counted one C call, which made ``launches``
    return out


def inputs(device, shape=SHAPE):
    """x, y drawn as the TPU probe draws them (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    y = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def measure(device="cuda", shape=SHAPE, iters: int = ITERS, launches: int = 200, reps: int = 5,
            clock_hz: float = None) -> List[Dict]:
    """Time each kind; one row per kind (times per launch, ms), bounds at
    ``clock_hz`` (default: the card's maximum SM clock)."""
    device = torch.device(device)
    x, y = inputs(device, shape)
    on_card = device.type == "cuda"
    clock = clock_hz or roofline.default_clock_hz(device)
    elems = x.numel() * iters
    rows = []
    for kind, per in INSTRUCTIONS.items():
        n = launches if on_card else 1
        ms = roofline.min_ms(lambda: vpu_ceiling(x, y, kind, iters, n), device, reps=reps) / n
        bound, _ = roofline.bound_ms(clock, bytes_moved=3 * x.numel() * 4, fp32_instr=elems * per)
        rows.append({"kind": kind, "ms": ms, "elem_iters": elems, "instructions_per": per,
                     "telem_per_s": elems / ms / 1e9, "tinstr_per_s": elems * per / ms / 1e9,
                     "bound_ms": bound, "clock_hz": clock})
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (the measurement) or cpu (a rehearsal)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("exp_vpu_ceiling needs a CUDA GPU (or --device cpu for a rehearsal)")
    label = roofline.device_label(device)
    for r in measure(device):
        if device.type != "cuda":
            print(f"[{label}] {r['kind']:5s}: {r['ms']:.1f} ms host clock for {r['elem_iters'] / 1e6:.0f} M "
                  f"elem-iters", flush=True)
            continue
        peak = roofline.SMS * roofline.FP32_LANES_PER_SM * r["clock_hz"] / 1e12
        print(f"[{label}] {r['kind']:5s}: {r['ms']:.4f} ms per launch for {r['elem_iters'] / 1e6:.0f} M elem-iters "
              f"-> {r['telem_per_s']:.3f} Telem/s, {r['tinstr_per_s']:.2f} T FP32 instr/s at "
              f"{r['instructions_per']} per elem-iter ({r['tinstr_per_s'] / peak:.1%} of the {peak:.2f} T/s "
              f"FP32 instruction rate at {r['clock_hz'] / 1e9:.2f} GHz; bound {r['bound_ms']:.4f} ms)", flush=True)


if __name__ == "__main__":
    main()
