"""What the softmax chain costs inside a flash-attention forward, on one CUDA
GPU (port of tools/exp_flash_softmax.py, probe T1).

    python -m moge_tpu_torch.tools.exp_flash_softmax [--n 3601] [--depth 24] [--reps 5] [--device cpu]

Seven variants of one forward (kernel ``csrc/exp_flash_softmax.cu``) with
the same tensor-core work and different elementwise chains, at 16 heads of
64 over n tokens padded to a multiple of 128 (ViT-L at 3601 tokens by
default), bf16, unscaled logits as the TPU probe has them:

  base         : bias add (0 / -inf), fp32 max/sub/exp/sum
  nobias       : zero-padded K/V, no bias; the sum corrected by (pad keys) * exp(-m)
  bf16sm       : logits, max and exp in bf16 (fp32 sum)
  noexp        : relu(s - m) for exp (output exactly 0: a cost probe)
  nomax        : exp(min(s, 60)), no max (a cost probe)
  mxusum       : V extended by a validity column, the sum from P . V on the tensor cores
  mxusum_nomax : mxusum without the max

It prints each variant's max |difference| from ``base``, then the time per
layer of a ``--depth``-deep chain (the output feeds the next q), the
variants in turns, least of ``--reps`` (CUDA events), beside the same chain
of ``F.scaled_dot_product_attention`` (flash backend, the n real keys, scale
1) as the library call for ``base``. ``--device cpu`` rehearses the plain
versions, with host-clock times that say nothing of the card.
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import _build
from . import roofline

__all__ = ["flash_softmax_variant", "flash_softmax_variant_plain", "make_inputs", "pad_tokens", "measure", "main",
           "VARIANTS", "REL_TOL"]

VARIANTS = ("base", "nobias", "bf16sm", "noexp", "nomax", "mxusum", "mxusum_nomax")
HEADS, HEAD_DIM = 16, 64
# the kernel against its plain version: max |difference| over max |plain|.
# Both round an fp32 output to bf16 (one bf16 step is 2^-8 to 2^-7 of a
# value); the kernel rounds p against a key tile's running max, the plain
# version against the row's. Two steps at the largest output; bf16sm, which
# also rounds s - m to bf16 against those different maxima, four. noexp is
# exactly 0 on both. A 64-key tile left out moves the largest output by ~36%
# of max |out| at N = 3601 and 1201 (make_inputs, base).
REL_TOL = {**dict.fromkeys(VARIANTS, 2.0 ** -6), "bf16sm": 2.0 ** -5, "noexp": 0.0}
T1 = _build.Entry("exp_flash_softmax", "exp_flash_softmax", "moge_flash_softmax_variant",
                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p], variants=VARIANTS)


def pad_tokens(n: int, quantum: int = 128) -> int:
    """n rounded up to the TPU probe's default 128-row query block."""
    return -(-n // quantum) * quantum


def _ext(variant: str) -> bool:
    return variant.startswith("mxusum")


def flash_softmax_variant_plain(variant: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                bias: torch.Tensor, n_real: int) -> torch.Tensor:
    """The TPU probe's ``make_kernel`` body on whole key rows: fp32 logits of
    (bh, N, 64) q and k, the variant's softmax, p cast to V's dtype before
    P . V, out = acc / max(l, 1e-30) in q's dtype."""
    d = q.shape[-1]
    logits = torch.einsum("bnd,bmd->bnm", q.float(), k.float())
    b = bias.float()[0]
    if variant == "base":
        logits = logits + b
        p = torch.exp(logits - logits.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
    elif variant == "nobias":
        m = logits.amax(-1, keepdim=True).clamp_min(0.0)
        p = torch.exp(logits - m)
        l = p.sum(-1, keepdim=True) - float(k.shape[1] - n_real) * torch.exp(-m)
    elif variant == "bf16sm":
        lg = (logits + b).to(torch.bfloat16)
        p = torch.exp(lg - lg.amax(-1, keepdim=True))
        l = p.float().sum(-1, keepdim=True)
    elif variant == "noexp":
        logits = logits + b
        p = (logits - logits.amax(-1, keepdim=True)).clamp_min(0.0)
        l = p.sum(-1, keepdim=True)
    elif variant == "nomax":
        p = torch.exp((logits + b).clamp_max(60.0))
        l = p.sum(-1, keepdim=True)
    elif variant in ("mxusum", "mxusum_nomax"):
        if variant == "mxusum":
            p = torch.exp(logits - logits.amax(-1, keepdim=True).clamp_min(0.0))
        else:
            p = torch.exp(logits.clamp_max(60.0))
        acc = torch.einsum("bnm,bmd->bnd", p.to(v.dtype).float(), v.float())
        return (acc[..., :d] / acc[..., d:d + 1].clamp_min(1e-30)).to(q.dtype)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    acc = torch.einsum("bnm,bmd->bnd", p.to(v.dtype).float(), v.float())
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def flash_softmax_variant(variant: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                          n_real: int) -> torch.Tensor:
    """One variant's forward: q, k (bh, N, 64) bf16, v (bh, N, 64) or (bh,
    N, 65) for the mxusum variants (last column: key validity), bias (1, N)
    fp32 (0 or -inf), all contiguous; N a multiple of 64 and n_real <= N the
    real keys. CUDA tensors run kernel T1; CPU tensors run
    ``flash_softmax_variant_plain``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if q.device.type == "cpu":
        return flash_softmax_variant_plain(variant, q, k, v, bias, n_real)
    bh, n_pad, d = q.shape
    dv = d + 1 if _ext(variant) else d
    want = {"q": ((bh, n_pad, HEAD_DIM), torch.bfloat16), "k": ((bh, n_pad, HEAD_DIM), torch.bfloat16),
            "v": ((bh, n_pad, dv), torch.bfloat16), "bias": ((1, n_pad), torch.float32)}
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        _build.require_cuda_tensor(t, f"flash_softmax_variant {name}")
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous() or t.device != q.device \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_softmax_variant {variant} takes a contiguous, 16-byte aligned {name} of "
                             f"shape {shape} and {dtype}, got {tuple(t.shape)} {t.dtype}")
    if n_pad % 64 or not 0 < n_real <= n_pad:
        raise ValueError(f"flash_softmax_variant needs N a multiple of 64 and 0 < n_real <= N, "
                         f"got N={n_pad} n_real={n_real}")
    out = torch.empty_like(q)
    T1(variant, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), bh, n_pad,
       n_real, VARIANTS.index(variant))
    return out


def make_inputs(n: int, device, bh: int = HEADS, n_pad: int = None, seed: int = 0):
    """The TPU probe's inputs: q ~ N(0, 1/64), k, v ~ N(0, 1) in bf16 with
    the pad rows of k and v zeroed, the bias row (0 for a real key, -inf
    for a pad) and V extended by the validity column. Returns
    (q, k, v, v_ext, bias)."""
    n_pad = pad_tokens(n) if n_pad is None else n_pad
    rng = np.random.default_rng(seed)

    def draw(scale):
        return torch.from_numpy((rng.standard_normal((bh, n_pad, HEAD_DIM)) * scale).astype(np.float32))

    q, k, v = draw(0.125), draw(1.0), draw(1.0)
    valid = (torch.arange(n_pad) < n)[None, :, None]
    k, v = k * valid, v * valid
    bias = torch.where(torch.arange(n_pad) < n, 0.0, float("-inf"))[None, :]
    v_ext = torch.cat([v, valid.expand(bh, n_pad, 1).float()], dim=-1)
    bf = torch.bfloat16
    return (q.to(device, bf), k.to(device, bf), v.to(device, bf), v_ext.to(device, bf),
            bias.to(device).contiguous())


def bounds(bh: int, n_pad: int, n: int, variant: str, clock: float):
    """(ms, what sets it): the tensor-core flops and exps over the n real keys."""
    dv = HEAD_DIM + 1 if _ext(variant) else HEAD_DIM
    flops = 2.0 * bh * n_pad * n * (HEAD_DIM + dv)
    exps = 0.0 if variant == "noexp" else float(bh) * n_pad * n
    bytes_moved = 2 * bh * n_pad * (3 * HEAD_DIM + dv) + 4 * n_pad
    return roofline.bound_ms(clock, bytes_moved=bytes_moved, tensor_flops=flops, mufu=exps)


def measure(device="cuda", n: int = 3601, depth: int = 24, reps: int = 5, bh: int = HEADS,
            clock_hz: float = None) -> Dict:
    """max |variant - base| per variant, then per-layer ms of each variant's
    chain and of the SDPA chain, in turns, least of ``reps``; bounds at
    ``clock_hz`` (default: the card's maximum SM clock)."""
    device = torch.device(device)
    q, k, v, v_ext, bias = make_inputs(n, device, bh)
    n_pad = q.shape[1]
    clock = clock_hz or roofline.default_clock_hz(device)
    vin = {var: v_ext if _ext(var) else v for var in VARIANTS}
    outs = {var: flash_softmax_variant(var, q, k, vin[var], bias, n) for var in VARIANTS}
    ref = outs["base"][:, :n].float()
    diffs = {var: (o[:, :n].float() - ref).abs().max().item() for var, o in outs.items()}

    def chain(var):
        def run():
            x = q
            for _ in range(depth):
                x = flash_softmax_variant(var, x, k, vin[var], bias, n)
            return x
        return run

    kr, vr = k[None, :, :n].contiguous(), v[None, :, :n].contiguous()

    def sdpa_chain():
        x = q[None]
        for _ in range(depth):
            x = F.scaled_dot_product_attention(x, kr, vr, scale=1.0)
        return x

    runs = {var: chain(var) for var in VARIANTS}
    runs["sdpa (library)"] = sdpa_chain
    if device.type == "cuda":
        from torch.nn.attention import SDPBackend, sdpa_kernel

        ctx = sdpa_kernel([SDPBackend.FLASH_ATTENTION])
    else:
        import contextlib

        ctx = contextlib.nullcontext()
    with ctx:
        best = roofline.interleaved_ms(runs, device, rounds=reps)
    per_layer = {key: ms / depth for key, ms in best.items()}
    rows = [{"variant": var, "ms": per_layer[var], "max_diff_vs_base": diffs[var],
             "bound_ms": bounds(bh, n_pad, n, var, clock)[0]} for var in VARIANTS]
    rows.append({"variant": "sdpa (library)", "ms": per_layer["sdpa (library)"], "max_diff_vs_base": None,
                 "bound_ms": bounds(bh, n_pad, n, "base", clock)[0]})
    return {"n": n, "n_pad": n_pad, "bh": bh, "depth": depth, "reps": reps, "rows": rows}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=3601, help="real tokens (keys and queries), padded to 128")
    parser.add_argument("--depth", type=int, default=24, help="chain depth (out feeds the next q)")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--device", default="cuda", help="cuda (the measurement) or cpu (a rehearsal)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("exp_flash_softmax needs a CUDA GPU (or --device cpu for a rehearsal)")
    label = roofline.device_label(device)
    result = measure(device, args.n, args.depth, args.reps)
    for r in result["rows"]:
        if r["max_diff_vs_base"] is not None:
            print(f"[{label}] {r['variant']:12s} max|diff vs base| = {r['max_diff_vs_base']:.3e}", flush=True)
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    print(f"[{label}] per-layer flash fwd ms at N={result['n']} (padded {result['n_pad']}), {result['bh']} heads, "
          f"chain depth {result['depth']}, least of {result['reps']} ({clock}):", flush=True)
    for r in sorted(result["rows"], key=lambda r: r["ms"]):
        bound = f" (H100 bound {r['bound_ms']:.4f} ms)" if device.type == "cuda" else ""
        print(f"[{label}] {r['variant']:14s} {r['ms']:8.4f} ms{bound}", flush=True)


if __name__ == "__main__":
    main()
