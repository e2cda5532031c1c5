"""Multi-head attention, forward and backward (port of moge_tpu/ops/attention.py).

``flash_attention`` launches kernel K2 (``csrc/flash_attn.cu``) for CUDA
tensors and runs ``attention_plain`` for CPU tensors. The plain version is
the math of the JAX package's ``sdpa_xla``: fp32 logits scaled by D**-0.5,
keys at or past ``kv_valid`` masked with -inf, fp32 softmax, probabilities
rounded to the value dtype before the second product.

``flash_attention_qkv`` is the differentiable entry the encoder uses: it
takes the (B, N, 3, H, D) qkv projection and, on the card, is an autograd
Function whose forward is K2 (saving the output and its logsumexp) and
whose backward is kernels K2b-dq and K2b-dkv (``csrc/flash_attn_bwd.cu``),
which recompute the probabilities from the logsumexp and write one dqkv.
On CPU tensors it is ``attention_plain`` under autograd.

Layout is (B, N, H, D), as in the JAX package. The kernels read q, k, v and
dO through their strides and write dq, dk, dv through theirs, so the
per-head views of a qkv projection and of its gradient need no transposed
copies.

For bf16, K2 is a Hopper kernel (``wgmma`` on K/V tiles brought by TMA);
``flash_plan`` gives its launch (key tile, ring depth, grid, shared memory
and the three tensor maps) and refuses a view TMA cannot read. For fp32,
K2 is a register-blocked FFMA kernel (no TF32); ``f32_plan`` picks which
of its two builds to launch, and its grid, from the call's shape and the SM
count. K2b-dq and K2b-dkv are Hopper kernels of the same kind for bf16
(Q/dO and K/V rings by TMA, P and dS in registers); ``flash_bwd_plan``
gives their launches.

K2 is the op ``moge::flash_attention(q, k, v, kv_valid) -> (out, lse)``.
Registration, routing and the launch count (kernels ``flash_attention``,
``flash_attention_dq`` and ``flash_attention_dkv``, each under variant
``wgmma`` (bf16) or ``fp32``): ``_build``. ``flash_attention_fwd`` takes no
gradient; ``flash_attention_qkv``'s gradient route is ``_FlashQKV``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "attention_bwd_delta", "flash_attention_qkv", "attention_plain",
           "flash_plan", "FlashPlan", "f32_plan", "F32Plan", "flash_bwd_plan", "FlashBwdPlan"]

_HEAD_DIM = 64  # every DINOv2 arch of the repo (S/B/L/G/T) has 64-wide heads
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("wgmma", "fp32")  # the variant of each K2, K2b-dq and K2b-dkv launch: bf16, fp32
K2 = _build.Entry("flash_attention", "flash_attn", "moge_flash_attention_fwd",
                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 9 + [ctypes.c_float]
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p], variants=VARIANTS)
_BWD_TAIL = [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
K2B_DQ = _build.Entry("flash_attention_dq", "flash_attn_bwd", "moge_flash_attention_bwd_dq",
                      [ctypes.c_void_p] * 7 + _BWD_TAIL, variants=VARIANTS)
K2B_DKV = _build.Entry("flash_attention_dkv", "flash_attn_bwd", "moge_flash_attention_bwd_dkv",
                       [ctypes.c_void_p] * 8 + _BWD_TAIL, variants=VARIANTS)
# the bf16 kernel's query rows per block (one warpgroup), keys per K/V tile
# and ring slots, as csrc/flash_fwd.cuh builds it
Q_ROWS, KEY_TILE, STAGES = 64, 128, 2
# the bf16 backward kernels' (csrc/flash_attn_bwd.cu) rows per block (query
# rows for K2b-dq, keys for K2b-dkv), K2b-dq's keys per K/V tile, K2b-dkv's
# queries per Q/dO tile, and the slots of each ring
BWD_ROWS, BWD_KEY_TILE, BWD_QUERY_TILE, BWD_STAGES = 64, 64, 64, 2
# the fp32 kernel's query rows per block (csrc/flash_attn.cu), and per build
# of it (keyed by the blocks an SM holds) the time of a round that leaves 1,
# 2, ... of its blocks on the busiest SM, relative to a full round of the
# 2-a-SM build: fits to CUDA-event times on an H100 at B = 1, 2, 8, 12 and
# Nq = 1370 to 3601, where one block of the 255-register build alone took as
# long as two, and a full round of 3 of the 168-register build 1.7 of them
# (a block of it alone is taken as no faster than one of the other build)
F32_ROWS = 128
F32_ROUNDS = {2: (1.0, 1.0), 3: (1.0, 1.3, 1.7)}
_ROW_BYTES = 2 * _HEAD_DIM
_GRID_YZ = 65535


class FlashPlan(NamedTuple):
    """One bf16 K2 launch: ``bc`` keys per K/V tile in a ring of ``stages``
    slots, the grid (query tiles, H, B), the dynamic shared memory in bytes,
    and per operand (q, k, v) its TMA tensor map as (dims, byte strides,
    box): dims {64, H, N, B} (N = Nq for q, kv_valid for k and v), the byte
    strides of dims 1-3, the box of one head's rows."""
    bc: int
    stages: int
    grid: Tuple[int, int, int]
    smem: int
    maps: Tuple[Tuple[Tuple[int, int, int, int], Tuple[int, int, int], Tuple[int, int, int, int]], ...]


def _tma_check(name: str, t: torch.Tensor):
    """The byte strides (h, n, b) of a (B, N, H, 64) view; ValueError for a
    view TMA cannot read."""
    B, _, H, _ = t.shape
    sb, sn, sh = (s * t.element_size() for s in t.stride()[:3])
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 16 or not 0 <= s < 2 ** 40 for s in (sb, sn, sh)):
        raise ValueError(f"flash_attention kernel reads {name} by TMA: it needs unit-stride rows, byte "
                         f"strides that are multiples of 16 and a 16-byte aligned base (strides "
                         f"{t.stride()}, address {t.data_ptr()})")
    if H > _GRID_YZ or B > _GRID_YZ:
        raise ValueError(f"flash_attention kernel: H={H} and B={B} must each be at most {_GRID_YZ}")
    return sh, sn, sb


def _tma_map(name: str, t: torch.Tensor, n: int, rows: int):
    """The tensor map {64, H, n, B} of a (B, N, H, 64) view, boxes of ``rows``
    rows of one head; ValueError for a view TMA cannot read."""
    B, _, H, _ = t.shape
    return (_HEAD_DIM, H, n, B), _tma_check(name, t), (_HEAD_DIM, 1, rows, 1)


def _store_check(t: torch.Tensor) -> None:
    """ValueError for a backward output the bf16 kernels cannot store as bf16 pairs."""
    if t.stride(-1) != 1 or t.data_ptr() % 4 or any(s % 2 for s in t.stride()[:3]):
        raise ValueError(f"flash_attention_bwd stores bf16 pairs: an output needs unit-stride rows, even "
                         f"strides and a 4-byte aligned base (strides {t.stride()}, address {t.data_ptr()})")


def flash_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: int) -> FlashPlan:
    """The bf16 kernel's launch for (B, N, H, 64) q/k/v views (any device:
    it reads shapes, strides and addresses only). Raises ValueError for a
    view TMA cannot read: each row unit-stride, each byte stride a multiple
    of 16, each base address 16-byte aligned."""
    B, Nq, H, _ = q.shape
    maps = (_tma_map("q", q, Nq, Q_ROWS), _tma_map("k", k, kv_valid, KEY_TILE), _tma_map("v", v, kv_valid, KEY_TILE))
    smem = Q_ROWS * _ROW_BYTES + 2 * STAGES * KEY_TILE * _ROW_BYTES + 1024  # + slack to align to 1 KB
    return FlashPlan(KEY_TILE, STAGES, (-(-Nq // Q_ROWS), H, B), smem, maps)


class F32Plan(NamedTuple):
    """One fp32 K2 launch: ``rows`` query rows per block, the build that
    lets ``per_sm`` blocks share an SM, and the grid (query tiles, H, B)."""
    rows: int
    per_sm: int
    grid: Tuple[int, int, int]


def f32_plan(B: int, H: int, Nq: int, sms: int) -> F32Plan:
    """The fp32 kernel's launch for B x H heads of Nq queries on a card of
    ``sms`` SMs: of the kernel's two builds (3 blocks an SM at 168 registers
    a thread, or 2 at 255), the one whose busiest SM finishes first. Its
    blocks run in rounds of ``per_sm`` an SM; each full round, and the last
    by the blocks it leaves on the busiest SM, costs ``F32_ROUNDS``. Every
    block walks the same keys, so kv_valid scales both alike."""
    blocks = B * H * -(-Nq // F32_ROWS)

    def finish(per_sm: int) -> float:
        full, last = divmod(blocks, per_sm * sms)
        rounds = F32_ROUNDS[per_sm]
        return full * rounds[-1] + (rounds[-(-last // sms) - 1] if last else 0.0)

    return F32Plan(F32_ROWS, min(F32_ROUNDS, key=finish), (-(-Nq // F32_ROWS), H, B))


class FlashBwdPlan(NamedTuple):
    """The bf16 K2b-dq and K2b-dkv launches: K2b-dq walks K/V tiles of
    ``key_tile`` keys, K2b-dkv Q/dO tiles of ``query_tile`` queries, each in
    rings of ``stages`` slots; each kernel's grid (row tiles, H, B) and
    dynamic shared memory in bytes; per kernel the TMA tensor maps of q,
    dout, k and v, as ``FlashPlan.maps`` has them (dims {64, H, N, B} with
    N = Nq for q and dout, kv_valid for k and v; byte strides; box); and
    the element strides (b, n, h) through which each given output (dq, dk,
    dv) is stored, in place."""
    key_tile: int
    query_tile: int
    stages: int
    grid_dq: Tuple[int, int, int]
    grid_dkv: Tuple[int, int, int]
    smem_dq: int
    smem_dkv: int
    maps_dq: Tuple[Tuple[Tuple[int, int, int, int], Tuple[int, int, int], Tuple[int, int, int, int]], ...]
    maps_dkv: Tuple[Tuple[Tuple[int, int, int, int], Tuple[int, int, int], Tuple[int, int, int, int]], ...]
    stores: Tuple[Tuple[int, int, int], ...]


def flash_bwd_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor, kv_valid: int,
                   *outs: torch.Tensor) -> FlashBwdPlan:
    """The bf16 backward kernels' launches for (B, N, H, 64) q/k/v/dout views
    and the outputs ``outs`` they write (any of dq, dk, dv; any device: it
    reads shapes, strides and addresses only). Raises ValueError for an
    input TMA cannot read (as ``flash_plan``) or an output whose rows are
    not unit-stride bf16 pairs on 4-byte boundaries."""
    B, Nq, H, _ = q.shape
    Nkv = k.shape[1]
    maps = {}
    for kernel, q_rows, kv_rows in (("dq", BWD_ROWS, BWD_KEY_TILE), ("dkv", BWD_QUERY_TILE, BWD_ROWS)):
        maps[kernel] = (_tma_map("q", q, Nq, q_rows), _tma_map("dout", dout, Nq, q_rows),
                        _tma_map("k", k, kv_valid, kv_rows), _tma_map("v", v, kv_valid, kv_rows))
    for t in outs:
        _store_check(t)
    own = BWD_ROWS * _ROW_BYTES  # Q and dO (K2b-dq), K and V (K2b-dkv)
    smem_dq = 2 * own + 2 * BWD_STAGES * BWD_KEY_TILE * _ROW_BYTES + 1024  # + slack to align to 1 KB
    stats = 2 * BWD_QUERY_TILE * 4  # a slot's lse and delta
    smem_dkv = 2 * own + 2 * BWD_STAGES * BWD_QUERY_TILE * _ROW_BYTES + BWD_STAGES * stats + 1024
    return FlashBwdPlan(BWD_KEY_TILE, BWD_QUERY_TILE, BWD_STAGES, (-(-Nq // BWD_ROWS), H, B),
                        (-(-Nkv // BWD_ROWS), H, B), smem_dq, smem_dkv, maps["dq"], maps["dkv"],
                        tuple(tuple(t.stride()[:3]) for t in outs))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[int] = None, return_lse: bool = False):
    """Reference attention: (B, Nq, H, D) x (B, Nkv, H, D) -> (B, Nq, H, D)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if kv_valid is not None and kv_valid < k.shape[1]:
        keep = torch.arange(k.shape[1], device=k.device) < kv_valid
        logits = logits.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", probs.to(v.dtype).float(), v.float()).to(v.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: int, **more: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        _build.require_cuda_tensor(t, f"flash_attention {name}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention kernel takes float32 or bfloat16 q/k/v of one dtype, "
                            f"got {q.dtype}/{k.dtype}/{v.dtype}")
        if t.dim() != 4 or t.shape[-1] != _HEAD_DIM:
            raise ValueError(f"flash_attention kernel takes (B, N, H, {_HEAD_DIM}) tensors, "
                             f"got {name} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError("flash_attention q/k/v must be on one device")
        vec = 16 // t.element_size()
        if (t.stride(-1) != 1 or t.data_ptr() % 16 != 0
                or any(s % vec for s in t.stride()[:3])):
            raise ValueError(f"flash_attention kernel needs unit-stride, 16-byte aligned rows "
                             f"({name} strides {t.stride()})")
    if (k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]
            or any(t.shape != q.shape for t in more.values())):
        raise ValueError(f"flash_attention shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}"
                         + "".join(f", {n} {tuple(t.shape)}" for n, t in more.items()))
    if not 0 < kv_valid <= k.shape[1]:
        raise ValueError(f"kv_valid must be in [1, {k.shape[1]}], got {kv_valid}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on CUDA tensors: (out, lse). Raises for anything it does not take."""
    _check(q, k, v, kv_valid)
    B, Nq, H, D = q.shape
    if q.dtype == torch.bfloat16:
        plan = flash_plan(q, k, v, kv_valid)
        tile, variant = (plan.bc, plan.stages), "wgmma"
    else:
        plan = f32_plan(B, H, Nq, _build.sm_count(q.device))
        tile, variant = (plan.rows, plan.per_sm), "fp32"
    out = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Nq), dtype=torch.float32, device=q.device)
    K2(variant, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H, Nq,
       kv_valid, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], D ** -0.5, _DTYPES[q.dtype], *tile)
    return out, lse


def _plain_lse(q, k, v, kv_valid):
    return attention_plain(q, k, v, kv_valid, return_lse=True)


def _fake(q, k, v, kv_valid):
    B, Nq, H, D = q.shape
    return q.new_empty((B, Nq, H, D)), q.new_empty((B, H, Nq), dtype=torch.float32)


# K2's forward entry takes no gradient: with one to take it launches as well
ROUTER = _build.kernel_op("flash_attention(Tensor q, Tensor k, Tensor v, int kv_valid) -> (Tensor, Tensor)",
                          _launch, _plain_lse, _fake, autograd=_launch)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention output (B, Nq, H, D) and per-row logsumexp (B, H, Nq) fp32.

    CUDA tensors run kernel K2; CPU tensors run ``attention_plain``. Without
    a gradient to take, a traced program records the op
    ``moge::flash_attention``."""
    return ROUTER(q, k, v, k.shape[1] if kv_valid is None else kv_valid)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention, (B, N, H, D) layout, scale D**-0.5, fp32 softmax.

    K/V may be longer or shorter than q; keys at or past ``kv_valid``
    (default: all of them) are masked."""
    return flash_attention_fwd(q, k, v, kv_valid)[0]


def _strides(*ts: torch.Tensor):
    """(b, n, h) element strides of each (B, N, H, D) tensor, as one int64 array."""
    flat = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_int64 * len(flat))(*flat)


def _bwd_setup(q, k, v, dout, lse, delta, kv_valid, outs):
    """Check the backward kernels' operands (for bf16, also what
    ``flash_bwd_plan`` refuses; the C side builds the maps); allocate
    missing outputs like their inputs. Returns the variant the launch takes
    and the call's argument groups."""
    _check(q, k, v, kv_valid, dout=dout)
    B, Nq, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, Nq) or t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention_bwd {name} must be a contiguous fp32 ({B}, {H}, {Nq}) tensor")
    filled = []
    for name, dst, like in outs:
        dst = torch.empty_like(like, memory_format=torch.contiguous_format) if dst is None else dst
        if dst.shape != like.shape or dst.dtype != like.dtype or dst.device != q.device or dst.stride(-1) != 1:
            raise ValueError(f"flash_attention_bwd {name} must be a unit-stride {tuple(like.shape)} "
                             f"{like.dtype} tensor on {q.device}")
        filled.append(dst)
    variant = "fp32"
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("dout", dout), ("k", k), ("v", v)):
            _tma_check(name, t)
        for t in filled:
            _store_check(t)
        variant = "wgmma"
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr())
    dims = (B, H, Nq, k.shape[1], kv_valid)
    tail = (q.shape[-1] ** -0.5, _DTYPES[q.dtype])
    return variant, head, dims, tail, filled


def attention_bwd_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta_i = rowsum(dO_i * O_i) in fp32, (B, H, N): plain PyTorch, as the
    JAX package computes it in XLA. The products are formed in fp32 from the
    inputs as they are (exact for bf16 and fp32 factors; no fp32 copies of
    the inputs), then summed per row."""
    prod = torch.addcmul(out.new_zeros((1,) * out.dim(), dtype=torch.float32), dout, out)
    return prod.transpose(1, 2).sum(-1).contiguous()


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, kv_valid: int, dq: Optional[torch.Tensor] = None):
    """dq by kernel K2b-dq (CUDA tensors only)."""
    variant, head, dims, tail, (dq,) = _bwd_setup(q, k, v, dout, lse, delta, kv_valid, [("dq", dq, q)])
    K2B_DQ(variant, q.device, *head, dq.data_ptr(), *dims, _strides(q, k, v, dout, dq), *tail)
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, kv_valid: int, dk: Optional[torch.Tensor] = None,
                            dv: Optional[torch.Tensor] = None):
    """(dk, dv) by kernel K2b-dkv (CUDA tensors only); keys at or past kv_valid get zeros."""
    variant, head, dims, tail, (dk, dv) = _bwd_setup(q, k, v, dout, lse, delta, kv_valid,
                                                     [("dk", dk, k), ("dv", dv, v)])
    K2B_DKV(variant, q.device, *head, dk.data_ptr(), dv.data_ptr(), *dims, _strides(q, k, v, dout, dk, dv), *tail)
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, kv_valid: Optional[int] = None,
                        dq: Optional[torch.Tensor] = None, dk: Optional[torch.Tensor] = None,
                        dv: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of ``flash_attention`` from its output ``out``,
    logsumexp ``lse`` (B, H, Nq) and the output cotangent ``dout``: kernels
    K2b-dq and K2b-dkv for CUDA tensors (deterministic, no atomics), autograd
    through ``attention_plain`` for CPU tensors. ``dq``/``dk``/``dv`` may name
    (strided) tensors to write into, e.g. the views of one dqkv."""
    if kv_valid is None:
        kv_valid = k.shape[1]
    if q.device.type == "cpu":
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            grads = torch.autograd.grad(attention_plain(*leaves, kv_valid), leaves, dout)
        return tuple(g if dst is None else dst.copy_(g) for dst, g in zip((dq, dk, dv), grads))
    dout = dout.contiguous()
    delta = attention_bwd_delta(out, dout)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, kv_valid, dq)
    return (dq, *flash_attention_bwd_dkv(q, k, v, dout, lse, delta, kv_valid, dk, dv))


class _FlashQKV(torch.autograd.Function):
    """Self-attention over a (B, N, 3, H, D) qkv projection on the card:
    forward K2, backward K2b-dq + K2b-dkv into one dqkv."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, kv_valid: int):
        out, lse = _launch(*_views(qkv), kv_valid)
        ctx.save_for_backward(qkv, out, lse)
        ctx.kv_valid = kv_valid
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        qkv, out, lse = ctx.saved_tensors
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        flash_attention_bwd(*_views(qkv), out, lse, dout, ctx.kv_valid, *_views(dqkv))
        return dqkv, None


def flash_attention_qkv(qkv: torch.Tensor, kv_valid: Optional[int] = None) -> torch.Tensor:
    """Differentiable self-attention over a (B, N, 3, H, D) qkv projection ->
    (B, N, H, D). Keys at or past ``kv_valid`` (default N) are masked. CUDA
    tensors run K2 forward and K2b-dq/K2b-dkv backward; CPU tensors run
    ``attention_plain`` under autograd. Without a gradient to take it is
    ``flash_attention`` on the three views."""
    return QKV_ROUTER(qkv, qkv.shape[1] if kv_valid is None else kv_valid)


def _views(qkv: torch.Tensor):
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


# the routes of K2 over one qkv projection: without a gradient, K2's own on
# the three views; with one, attention_plain under autograd or _FlashQKV
QKV_ROUTER = _build.Router("flash_attention", 1,
                           lambda qkv, kv: torch.ops.moge.flash_attention(*_views(qkv), kv)[0],
                           lambda qkv, kv: attention_plain(*_views(qkv), kv),
                           lambda qkv, kv: _launch(*_views(qkv), kv)[0], _FlashQKV.apply)
