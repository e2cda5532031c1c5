"""Four layouts of the dense truncated-L1 objective against K4 on one CUDA
GPU (port of tools/exp_dense_pallas.py, probes T3-T6).

    python -m moge_tpu_torch.tools.exp_dense_pallas [--shape global|patch_4|patch_16|all] [--n 2] [--reps 4]
                                                    [--sweep] [--device cpu]

F[r, j] = sum_i min(t, |A[r, j] * wx[r, i] - wy[r, i]|) for R rows of L
candidates, at the v2 loss's solve shapes (``SHAPES``), by the kernels of
``csrc/exp_dense.cu``:

- ``dense_objective_v1`` (T3): the terms of a candidate split across the
  lanes of a warp, a shuffle reduction at the end;
- ``dense_objective_v1_unroll`` (T4): v1 with the term loop unrolled;
- ``dense_objective_v2`` (T5): each thread owns candidates and sums their
  terms serially (K4's layout), several rows per block;
- ``dense_objective_bf16`` (T6): candidate-major, bf16x2 pair math (two
  terms per instruction), the fp32 sums on the tensor cores.

For each shape it checks the v1 solve against the port's truncated solve
``ops.alignment._align_trunc_dense`` (which runs K4) and prints both, and the
other layouts, in ms and Tpair/s (interleaved, least of ``--reps`` rounds of
``--n`` calls, CUDA events). ``--sweep`` times every compile-time tile of
every layout at the first shape. ``--device cpu`` rehearses the plain
versions, with host-clock times that say nothing of the card.
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Dict, List, Union

import numpy as np
import torch

from ..ops import _build, alignment
from . import roofline

__all__ = ["dense_objective_v1", "dense_objective_v1_unroll", "dense_objective_v2", "dense_objective_bf16",
           "dense_objective_bf16_plain", "dense_objective_plain", "dense_objective_serial_plain", "make_problem",
           "pairs_bound", "measure", "sweep", "main", "PLAINS", "REL_TOL", "SHAPES", "VARIANTS"]

# (R, L): rows x candidate/term length of the v2 loss's solves, as the TPU probe chunks them
SHAPES = {"global": (606, 6912), "patch_4": (2427, 1728), "patch_16": (4096, 432)}
# variant -> (kernel code, default tile, compile-time tiles); v1/v1_unroll: candidates per warp;
# v2: 10 * rows per block + candidates per thread; bf16: 100 * rows per block + m16 candidate
# tiles per warp (csrc/exp_dense.cu's MOGE_BF16_CASE list)
VARIANTS = {"v1": (0, 4, (2, 4, 8)), "v1_unroll": (1, 4, (4, 8)), "v2": (2, 24, (18, 24, 44, 42)),
            "bf16": (3, 106, (103, 104, 106, 203, 403))}
# instructions per pair at the FP32 dispatch rate (csrc/exp_dense.cu); bf16: the count in its
# SASS: HMUL2, HADD2, LOP3 and HMNMX2 per two pairs, the sums on the tensor cores
INSTRUCTIONS = {"v1": 3.0, "v1_unroll": 3.0, "v2": 3.0, "bf16": 2.0}
# one entry per variant (kernel exp_dense_<variant> in _build's launch count), one C function
ENTRIES = {v: _build.Entry(f"exp_dense_{v}", "exp_dense", "moge_exp_dense", [ctypes.c_void_p] * 3
                           + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
           for v in VARIANTS}
EPS = 1e-7
# a layout against its plain version (PLAINS), max |difference| over max |F|:
# fp32 sums of the same terms in another order. T5 and its plain version add
# in one order and differ only where the plain version's fp64 difference
# rounds twice on its way to fp32
REL_TOL = 1e-5

dense_objective_plain = alignment.dense_objective_plain  # T3 and T4's plain version (fp32)


def dense_objective_bf16_plain(A: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor, t: float) -> torch.Tensor:
    """T6's plain version: A, wx, wy and t rounded to bf16; ``a * x``, ``- y``,
    ``abs`` and ``min`` each in bf16 (no fused multiply-add), summed in fp32."""
    bf = torch.bfloat16
    a, x, y = A.to(bf), wx.to(bf), wy.to(bf)
    tb = torch.tensor(t, dtype=torch.float32).to(bf)
    r, L = A.shape
    cb = max(1, min(L, (1 << 24) // max(r * L, 1)))
    parts = []
    for s in range(0, L, cb):
        v = ((a[:, s:s + cb, None] * x[:, None, :]) - y[:, None, :]).abs()
        parts.append(torch.minimum(v, tb).float().sum(-1))
    return torch.cat(parts, dim=1)


def dense_objective_serial_plain(A: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor, t: float) -> torch.Tensor:
    """T5's plain version: each candidate's terms added one at a time in index
    order, in fp32, as T5's threads add them; ``A * wx - wy`` in fp64, rounded
    once to fp32, as the kernel's fused multiply-add rounds. A long serial sum
    drifts from a pairwise one by up to L / 2 steps of F's last bit where the
    truncated terms are all one inexact t (0.7, say); summed in T5's order,
    the plain version drifts with it, and ``REL_TOL`` stays below one term."""
    a = A.double()
    x, y = wx.double(), wy.double()
    acc = torch.zeros_like(A)
    for i in range(A.shape[1]):
        acc += (a * x[:, i:i + 1] - y[:, i:i + 1]).float().abs().clamp_max(float(t))
    return acc


def _dense(variant: str, A: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor, t: float,
           tile: Union[int, None]) -> torch.Tensor:
    if A.device.type == "cpu":
        return PLAINS[variant](A, wx, wy, float(t))
    code, default, tiles = VARIANTS[variant]
    tile = default if tile is None else tile
    if tile not in tiles:
        raise ValueError(f"dense_objective_{variant}: tile {tile} not built (one of {tiles})")
    for name, x in (("A", A), ("wx", wx), ("wy", wy)):
        _build.require_cuda_tensor(x, f"dense_objective_{variant} {name}")
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape != A.shape or not x.is_contiguous() \
                or x.device != A.device:
            raise ValueError(f"dense_objective_{variant} takes contiguous fp32 (R, L) tensors of one shape and "
                             f"device, got {name} {x.dtype} {tuple(x.shape)}")
    R, L = A.shape
    F = torch.empty_like(A)
    if F.numel() == 0:
        return F
    ENTRIES[variant](None, A.device, A.data_ptr(), wx.data_ptr(), wy.data_ptr(), float(t), F.data_ptr(), R, L,
                     code, tile)
    return F


def dense_objective_v1(A, wx, wy, t: float, tile=None):
    """T3, term-reduce: (R, L) fp32 ``A``, ``wx``, ``wy`` and a scalar ``t`` ->
    (R, L) fp32 F. CUDA tensors run the kernel; CPU tensors ``dense_objective_plain``."""
    return _dense("v1", A, wx, wy, t, tile)


def dense_objective_v1_unroll(A, wx, wy, t: float, tile=None):
    """T4: T3 with the term loop unrolled at compile time."""
    return _dense("v1_unroll", A, wx, wy, t, tile)


def dense_objective_v2(A, wx, wy, t: float, tile=None):
    """T5, candidate-major: each thread owns candidates, several rows per block.
    CPU tensors run ``dense_objective_serial_plain``."""
    return _dense("v2", A, wx, wy, t, tile)


def dense_objective_bf16(A, wx, wy, t: float, tile=None):
    """T6: candidate-major, the pair math in bf16x2 (inputs rounded to bf16),
    fp32 sums on the tensor cores. CPU tensors run ``dense_objective_bf16_plain``."""
    return _dense("bf16", A, wx, wy, t, tile)


FUNCTIONS = {"v1": dense_objective_v1, "v1_unroll": dense_objective_v1_unroll, "v2": dense_objective_v2,
             "bf16": dense_objective_bf16}
PLAINS = {"v1": dense_objective_plain, "v1_unroll": dense_objective_plain, "v2": dense_objective_serial_plain,
          "bf16": dense_objective_bf16_plain}


def make_problem(R: int, L: int, device, seed: int = 0):
    """x, y (normal) and w (uniform in [0.1, 1]) drawn as the TPU probe draws
    them, and the dense objective's operands as the port's truncated solve
    builds them: A = y' / max(x', eps), wx = w x', wy = w y' with x' = |x|,
    y' = y sign(x)."""
    rng = np.random.default_rng(seed)
    x, y = (torch.from_numpy(rng.normal(size=(R, L)).astype(np.float32)).to(device) for _ in range(2))
    w = torch.from_numpy(rng.uniform(0.1, 1.0, size=(R, L)).astype(np.float32)).to(device)
    sign = torch.sign(x)
    xs, ys = x * sign, y * sign
    A = (ys / xs.clamp_min(EPS)).contiguous()
    return xs, ys, w, A, (w * xs).contiguous(), (w * ys).contiguous()


def pairs_bound(R: int, L: int, variant: str, clock: float):
    """(ms, what sets it) of one variant's F over R rows of L candidates and terms."""
    return roofline.bound_ms(clock, bytes_moved=4 * R * L * 4, fp32_instr=R * L * L * INSTRUCTIONS[variant])


def measure(device="cuda", shapes=tuple(SHAPES), n: int = 2, reps: int = 4, trunc: float = 1.0,
            shape_table: Dict = SHAPES, clock_hz: float = None) -> List[Dict]:
    """For each shape: the K4 solve against the T3 solve (parity asserted),
    then K4 and the four layouts timed in turns; one row per (shape, what),
    bounds at ``clock_hz`` (default: the card's maximum SM clock)."""
    device = torch.device(device)
    clock = clock_hz or roofline.default_clock_hz(device)
    rows = []
    for name in shapes:
        R, L = shape_table[name]
        xs, ys, w, A, wx, wy = make_problem(R, L, device)

        def run_k4():
            return alignment._align_trunc_dense(xs, ys, w, trunc, EPS)[1]

        runs = {"K4 solve": run_k4}
        for variant, fn in FUNCTIONS.items():
            runs[variant] = lambda fn=fn: fn(A, wx, wy, trunc).min(-1).values
        want = run_k4()
        torch.testing.assert_close(runs["v1"](), want, rtol=1e-5, atol=1e-5)
        best = roofline.interleaved_ms(runs, device, rounds=2, calls=n, reps=reps)
        pairs = R * L * L
        for k, ms in best.items():
            bound, _ = pairs_bound(R, L, "v1" if k == "K4 solve" else k, clock)
            rows.append({"shape": name, "R": R, "L": L, "what": k, "ms": ms, "tpair_per_s": pairs / ms / 1e9,
                         "bound_ms": bound})
    return rows


def sweep(device="cuda", shape: str = "global", n: int = 2, reps: int = 4, trunc: float = 1.0,
          shape_table: Dict = SHAPES) -> List[Dict]:
    """Every compile-time tile of every layout at one shape, in turns."""
    device = torch.device(device)
    R, L = shape_table[shape]
    _, _, _, A, wx, wy = make_problem(R, L, device)
    runs = {(variant, tile): (lambda fn=FUNCTIONS[variant], tile=tile: fn(A, wx, wy, trunc, tile))
            for variant, (_, _, tiles) in VARIANTS.items() for tile in tiles}
    best = roofline.interleaved_ms(runs, device, rounds=2, calls=n, reps=reps)
    return [{"shape": shape, "variant": v, "tile": t, "ms": ms, "tpair_per_s": R * L * L / ms / 1e9}
            for (v, t), ms in sorted(best.items(), key=lambda kv: kv[1])]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shape", default="all", help=f"one of {sorted(SHAPES)} or all")
    parser.add_argument("--n", type=int, default=2, help="calls per timed round")
    parser.add_argument("--reps", type=int, default=4)
    parser.add_argument("--sweep", action="store_true", help="every layout and compile-time tile at --shape")
    parser.add_argument("--device", default="cuda", help="cuda (the measurement) or cpu (a rehearsal)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("exp_dense_pallas needs a CUDA GPU (or --device cpu for a rehearsal)")
    label = roofline.device_label(device)
    names = list(SHAPES) if args.shape == "all" else [args.shape]
    if args.sweep:
        for r in sweep(device, names[0], args.n, args.reps):
            print(f"[{label}] {r['shape']} {r['variant']:9s} tile {r['tile']:2d}: {r['ms']:9.4f} ms "
                  f"({r['tpair_per_s']:.3f} Tpair/s)", flush=True)
        return
    rows = measure(device, names, args.n, args.reps)
    for r in rows:
        k4 = next(q["ms"] for q in rows if q["shape"] == r["shape"] and q["what"] == "K4 solve")
        bound = f"; FP32 bound {r['bound_ms']:.4f} ms" if device.type == "cuda" else ""
        print(f"[{label}] {r['shape']:8s} R={r['R']} L={r['L']} {r['what']:9s} {r['ms']:9.4f} ms "
              f"({r['tpair_per_s']:.3f} Tpair/s; K4 solve / this {k4 / r['ms']:.2f}x{bound})", flush=True)


if __name__ == "__main__":
    main()
