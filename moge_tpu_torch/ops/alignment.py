"""Exact weighted-L1 alignment solvers (port of moge_tpu/ops/alignment.py).

The solvers behind MoGe's affine-invariant losses:

* ``align`` without truncation: the exact minimizer of sum_i w_i |a x_i - y_i|
  by the sorted-derivative zero crossing.
* ``align`` with truncation: the minimizer of sum_i min(t, w_i |a x_i - y_i|)
  over the breakpoints a = y_j/x_j, in one of three forms chosen as the JAX
  package chooses them, by ``MOGE_ALIGN_TRUNC_IMPL`` read on every call:

  - ``auto`` or ``dense`` (the default): the objective evaluated densely at
    every breakpoint (``dense_objective``), then the first argmin. On CUDA
    tensors the dense objective is kernel K4 (``csrc/dense_align.cu``) at
    every length; on CPU tensors it is ``dense_objective_plain``, the
    chunked broadcast form of the JAX package.
  - ``events``: one stable sort of the 3n breakpoint events (B_i, A_i, C_i)
    with their slope/intercept deltas as payloads, prefix sums, and the
    objective read at the end of each run of equal candidates. The sort is
    ``torch.sort`` in ``lax.sort``'s order (``sort_stable``). The JAX package
    can sort by its bitonic network instead (``MOGE_BITONIC_MAX``); the port
    does not read that variable: on finite keys the network
    (``ops/bitonic.py``) gives the stable sort's permutation, so the result
    is the same.
  - ``prefix``: the closed form over three sorted orders (A, B, C), their
    prefix sums and six searches per candidate.

  Any other value raises. The sorted forms run in plain PyTorch on the
  tensors' device; ``events`` breaks ties in sorted-value order, ``dense``
  and ``prefix`` in original-index order, as in the JAX package.
* the anchor-enumerating solvers (``align_depth_affine``,
  ``align_points_scale_z_shift``, ``align_points_scale_xyz_shift``), which
  solve one ``align`` per (row, anchor) pair in flat chunks and take the
  best anchor.

The solves run without autograd; gradients flow only through the final
regathered a = y[idx] / x[idx] (and the anchor's values), as in the JAX
package and the reference.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Callable, List, Optional, Tuple, Union

import torch

from . import _build

__all__ = ["align", "dense_objective", "dense_objective_plain", "sort_stable", "align_depth_scale",
           "align_depth_affine", "align_points_scale", "align_points_scale_z_shift", "align_points_scale_xyz_shift",
           "align_points_z_shift", "align_points_xyz_shift", "align_affine_lstsq", "SOLVES"]

# When set to a list, every anchor solve appends (scale, shift, anchor index,
# second index), detached: lets a caller compare the solvers' choices.
SOLVES: Optional[List[Tuple[torch.Tensor, ...]]] = None

Trunc = Union[float, torch.Tensor]

_PLAIN_ELEMS = 1 << 25   # broadcast elements per chunk of the plain dense objective
_ANCHOR_ELEMS = 1 << 22  # elements per problem tensor per chunk of the CPU anchor solve
_SORTED_ELEMS = 1 << 24  # elements per problem tensor per chunk of a sorted form's anchor solve on the card


def dense_objective_plain(A: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor, t: Trunc) -> torch.Tensor:
    """F[r, j] = sum_i min(t[r, i], |A[r, j] * wx[r, i] - wy[r, i]|), evaluated
    as the JAX package's XLA form: a (rows, chunk, L) broadcast over chunks of
    candidates. ``t``: a float, or an (R, L) tensor."""
    r, L = A.shape
    cb = max(1, min(L, _PLAIN_ELEMS // max(r * L, 1)))
    per_term = isinstance(t, torch.Tensor)
    parts = []
    for s in range(0, L, cb):
        v = (A[:, s:s + cb, None] * wx[:, None, :] - wy[:, None, :]).abs()
        parts.append((torch.minimum(t[:, None, :], v) if per_term else v.clamp_max(t)).sum(-1))
    return torch.cat(parts, dim=1)


K4 = _build.Entry("dense_align", "dense_align", "moge_dense_objective",
                  [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])


def dense_objective(A: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor, t: Trunc) -> torch.Tensor:
    """The dense truncated-L1 objective of R problems of length L: (R, L) fp32
    ``A``, ``wx``, ``wy``; ``t`` a float (passed to the kernel as a scalar) or
    an (R, L) tensor. CUDA tensors run kernel K4 (kernel ``dense_align`` in
    ``_build``'s launch count); CPU tensors run ``dense_objective_plain``."""
    if A.device.type == "cpu":
        return dense_objective_plain(A, wx, wy, t)
    per_term = isinstance(t, torch.Tensor)
    for name, x in (("A", A), ("wx", wx), ("wy", wy)) + ((("t", t),) if per_term else ()):
        _build.require_cuda_tensor(x, f"dense_objective {name}")
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape != A.shape or not x.is_contiguous() \
                or x.device != A.device:
            raise ValueError(f"dense_objective kernel takes contiguous fp32 (R, L) tensors of one shape "
                             f"and device, got {name} {x.dtype} {tuple(x.shape)}")
    R, L = A.shape
    F = torch.empty_like(A)
    if F.numel() == 0:
        return F
    K4(None, A.device, A.data_ptr(), wx.data_ptr(), wy.data_ptr(), t.data_ptr() if per_term else None,
       0.0 if per_term else float(t), F.data_ptr(), R, L)
    return F


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx[...]] along the last axis."""
    return torch.take_along_dim(x, idx[..., None], dim=-1)[..., 0]


def _align_trunc_dense(xs, ys, w, trunc: Trunc, eps: float):
    """Truncated exact-L1 align by dense evaluation of the objective
    F_j = sum_i min(trunc, |A_j wx_i - wy_i|) (= w_i |A_j x_i - y_i| for
    w >= 0) at every candidate A_j = y_j / x_j, then the first argmin. The
    objective and the argmin carry no gradient (the JAX package stops
    gradients at their inputs); a = y[idx] / x[idx] is regathered under
    autograd."""
    batch_shape = xs.shape[:-1]
    L = xs.shape[-1]
    r = math.prod(batch_shape)
    with torch.no_grad():
        if isinstance(trunc, torch.Tensor) and trunc.dim():
            t = torch.broadcast_to(trunc, xs.shape).reshape(r, L).float().contiguous()
        else:
            t = float(trunc)
        A, wx, wy = ys / xs.clamp_min(eps), w * xs, w * ys
        f = dense_objective(*(v.reshape(r, L).float().contiguous() for v in (A, wx, wy)), t)
        index = f.argmin(dim=-1)
        loss = _take(f, index)
    index = index.reshape(batch_shape)
    a = _take(ys, index) / _take(xs, index).clamp_min(eps)
    return a, loss.reshape(batch_shape), index


def _trunc_form() -> str:
    """The truncated form ``MOGE_ALIGN_TRUNC_IMPL`` selects, as the JAX
    package reads it: ``dense`` (also for ``auto``), ``events`` or ``prefix``."""
    impl = os.environ.get("MOGE_ALIGN_TRUNC_IMPL", "auto")
    if impl == "auto":
        return "dense"
    if impl not in ("dense", "events", "prefix"):
        raise ValueError(f"MOGE_ALIGN_TRUNC_IMPL={impl!r} — expected 'auto', 'dense', 'events' or 'prefix'")
    return impl


def _sort_key(v: torch.Tensor) -> torch.Tensor:
    """``v`` with -0.0 made 0.0 and every NaN the positive NaN, so that
    ``torch.sort`` orders the keys as ``lax.sort`` compares them (-0.0 equal
    to 0.0, NaN after +inf) on either device, whatever its backend makes of
    the sign bit of a zero or a NaN."""
    v = torch.where(v == 0, 0.0, v)
    return torch.where(v.isnan(), torch.nan, v)


def sort_stable(keys: torch.Tensor, payloads: List[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """``(keys, *payloads)`` sorted by ``keys`` along the last axis, stably, by
    ``torch.sort`` with each payload gathered through its permutation: the
    events form's ``lax.sort(..., is_stable=True, num_keys=1)``."""
    keys_s, perm = torch.sort(_sort_key(keys), dim=-1, stable=True)
    return (keys_s, *(torch.take_along_dim(p, perm, dim=-1) for p in payloads))


def _align_trunc_events(xs, ys, wx, wy, A, B, C, trunc: Trunc, eps: float):
    """Truncated exact-L1 align by one stable sort of breakpoint events.

    Term i, min(t, w_i |a x_i - y_i|), is t for a <= B_i, wy_i - a wx_i on
    [B_i, A_i], a wx_i - wy_i on [A_i, C_i] and t for a >= C_i, so
    F(a) = t K(a) + a S(a) + T(a), with K, S, T prefix sums over the
    value-sorted events of the deltas (dK, dS, dT): B_i (-1, -wx_i, +wy_i),
    A_i (0, +2wx_i, -2wy_i), C_i (+1, -wx_i, +wy_i); K(-inf) = n, and with a
    per-element t the count K becomes a t-weighted prefix (one more
    payload). A stable sort of concat([B, A, C]) breaks ties B < A < C,
    which gives the reference's side conventions; each A event reads the
    prefix at the end of its run of equal values."""
    n = xs.shape[-1]
    dev = xs.device
    per_elem = isinstance(trunc, torch.Tensor) and trunc.dim() > 0
    with torch.no_grad():
        vals = torch.cat([B, A, C], dim=-1)
        one = torch.ones_like(wx)
        payloads = [torch.cat([-wx, 2 * wx, -wx], dim=-1), torch.cat([wy, -2 * wy, wy], dim=-1),
                    torch.cat([-one, torch.zeros_like(wx), one], dim=-1)]
        idx = torch.full((3 * n,), n, dtype=torch.int32, device=dev)
        idx[n:2 * n] = torch.arange(n, dtype=torch.int32, device=dev)
        payloads.append(idx.expand(vals.shape))
        if per_elem:
            t_full = torch.broadcast_to(trunc, xs.shape)
            payloads.append(torch.cat([-t_full, torch.zeros_like(t_full), t_full], dim=-1))
        vals_s, d_s, d_t, d_k, idx_s, *d_tr = sort_stable(vals, payloads)
        del vals, payloads  # the unsorted copies, before the prefix sums (peak memory)

        if per_elem:
            trunc_term = t_full.sum(-1, keepdim=True) + d_tr[0].cumsum(-1)
        else:
            trunc_term = trunc * (n + d_k.cumsum(-1))
        f_all = trunc_term + vals_s * d_s.cumsum(-1) + d_t.cumsum(-1)
        del trunc_term, d_s, d_t, d_k, d_tr

        is_a = idx_s < n
        # a run of equal A values ends at its last A event (C events of the
        # same value sort after every A, so equal A's are contiguous)
        nxt_same = torch.cat([is_a[..., 1:] & (vals_s[..., 1:] == vals_s[..., :-1]),
                              torch.zeros_like(is_a[..., :1])], dim=-1)
        pos = torch.arange(3 * n, device=dev)
        run_end = torch.where(is_a & ~nxt_same, pos, 3 * n - 1)
        end_pos = run_end.flip(-1).cummin(-1).values.flip(-1)  # reverse cummin
        f_masked = torch.where(is_a, torch.take_along_dim(f_all, end_pos, dim=-1), torch.inf)
        best = f_masked.argmin(-1)  # the first sorted position: the first original index in a run
        loss = _take(f_masked, best)
        index = _take(idx_s, best).long()
    a = _take(ys, index) / _take(xs, index).clamp_min(eps)
    return a, loss, index


def _align_trunc_prefix(xs, ys, wx, wy, A, B, C, trunc: Trunc, eps: float):
    """Truncated exact-L1 align by the closed form: F at every candidate A_j
    from the prefix sums of wx and wy in A, B and C order and the counts of
    A (<= A_j), B (<= A_j) and C (< A_j), found by ``torch.searchsorted``.
    F is a difference of A x prefix terms, so a near-flat row carries fp32
    cancellation error of order eps_32 max|A| sum w|x|."""
    n = xs.shape[-1]
    per_elem = isinstance(trunc, torch.Tensor) and trunc.dim() > 0
    with torch.no_grad():
        (a_sorted, order_a), (b_sorted, order_b), (c_sorted, order_c) = (
            torch.sort(_sort_key(v), dim=-1, stable=True) for v in (A, B, C))

        def prefix(v, order):
            cs = torch.take_along_dim(v, order, dim=-1).cumsum(-1)
            return torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)  # (..., n + 1)

        query = A.contiguous()
        n_a = torch.searchsorted(a_sorted, query, right=True)   # elements <= A_j
        n_b = torch.searchsorted(b_sorted, query, right=True)
        n_c = torch.searchsorted(c_sorted, query, right=False)  # elements < A_j
        g = functools.partial(torch.take_along_dim, dim=-1)
        swx_a, swy_a = g(prefix(wx, order_a), n_a), g(prefix(wy, order_a), n_a)
        swx_b, swy_b = g(prefix(wx, order_b), n_b), g(prefix(wy, order_b), n_b)
        swx_c, swy_c = g(prefix(wx, order_c), n_c), g(prefix(wy, order_c), n_c)
        if per_elem:
            # the flat-region total: every t_i, less those whose window has
            # begun (B_i <= a), plus those whose window has ended (C_i < a)
            t_full = torch.broadcast_to(trunc, wx.shape)
            pt_b, pt_c = prefix(t_full, order_b), prefix(t_full, order_c)
            trunc_term = t_full.sum(-1, keepdim=True) - g(pt_b, n_b) + g(pt_c, n_c)
        else:
            trunc_term = trunc * ((n - n_b) + n_c)
        F = trunc_term + A * (swx_a - swx_c) - (swy_a - swy_c) + (swy_b - swy_a) - A * (swx_b - swx_a)
        index = F.argmin(-1)
        loss = _take(F, index)
    a = _take(ys, index) / _take(xs, index).clamp_min(eps)
    return a, loss, index


def align(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, trunc: Optional[Trunc] = None,
          eps: float = 1e-7) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve min_a sum_i w_i |a x_i - y_i| (``trunc`` None) or
    min_a sum_i min(trunc, w_i |a x_i - y_i|). ``x, y, w``: (..., n), w >= 0;
    ``trunc`` a float or a tensor broadcastable to (..., n). Returns
    (a (...), loss (...), index (...)), gradients through a only."""
    x, y, w = torch.broadcast_tensors(x, y, w)
    n = x.shape[-1]
    sign = torch.sign(x)
    xs, ys = x * sign, y * sign

    if trunc is None:
        with torch.no_grad():
            y_div_x = ys / xs.clamp_min(eps)
            order = torch.argsort(y_div_x, dim=-1, stable=True)
            wx_sorted = torch.take_along_dim(xs * w, order, dim=-1)
            derivatives = 2 * wx_sorted.cumsum(-1) - wx_sorted.sum(-1, keepdim=True)
            # first index where the derivative is >= 0
            search = (derivatives < 0).sum(-1).clamp_max(n - 1)
            index = _take(order, search)
        a = _take(ys, index) / _take(xs, index).clamp_min(eps)
        with torch.no_grad():
            loss = (w * (a[..., None] * x - y).abs()).sum(-1)
        return a, loss, index

    form = _trunc_form()
    if form == "dense":
        return _align_trunc_dense(xs, ys, w, trunc, eps)
    with torch.no_grad():
        # trunc in the inputs' dtype, as the JAX package takes it; a float
        # stays a Python number (no copy to the card, no sync)
        t = trunc.to(xs.dtype) if isinstance(trunc, torch.Tensor) else float(trunc)
        wx, wy = w * xs, w * ys
        A = ys / xs.clamp_min(eps)
        B = (wy - t) / wx.clamp_min(eps)
        C = (wy + t) / wx.clamp_min(eps)
    if form == "events":
        return _align_trunc_events(xs, ys, wx, wy, A, B, C, t, eps)
    return _align_trunc_prefix(xs, ys, wx, wy, A, B, C, t, eps)


def _chunk_pairs(total: int, length: int, trunc, device: torch.device) -> int:
    """(row, anchor) pairs per chunk of an anchor solve of ``total`` problems
    of size ``length``. On the card the dense form takes every pair in one
    chunk (one K4 launch per solve, about 8 (pairs, length) fp32 arrays of
    device memory) and the sorted forms ``_SORTED_ELEMS`` elements per
    problem tensor (they hold tens of such arrays: sort keys, payloads,
    permutations, prefix sums); on the CPU ``_ANCHOR_ELEMS`` elements bound
    the memory. At least 128 pairs, at most ``total``."""
    if device.type != "cuda":
        elems = _ANCHOR_ELEMS
    elif trunc is not None and _trunc_form() != "dense":
        elems = _SORTED_ELEMS
    else:
        elems = total * max(length, 1)
    return int(min(total, max(128, elems // max(length, 1))))


def _flat_anchor_align(n_rows: int, n_anchors: int, length: int, make_chunk: Callable, trunc,
                       device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the n_rows * n_anchors independent ``align`` problems of size
    ``length`` in flat chunks of ``_chunk_pairs`` (row, anchor) pairs, without
    autograd. ``make_chunk(row_idx, anchor_idx)`` builds the (M, length)
    problem tensors. Returns per-pair ``(loss, index)``, each (n_rows,
    n_anchors)."""
    total = n_rows * n_anchors
    m = _chunk_pairs(total, length, trunc, device)
    losses, indices = [], []
    with torch.no_grad():
        for start in range(0, total, m):
            flat = torch.arange(start, min(start + m, total), device=device)
            _, loss, idx = align(*make_chunk(flat // n_anchors, flat % n_anchors), trunc=trunc)
            losses.append(loss)
            indices.append(idx)
    return torch.cat(losses).reshape(n_rows, n_anchors), torch.cat(indices).reshape(n_rows, n_anchors)


def align_depth_scale(depth_src, depth_tgt, weight, trunc=None):
    """Scale-only alignment."""
    return align(depth_src, depth_tgt, weight, trunc)[0]


def align_depth_affine(depth_src, depth_tgt, weight, trunc=None):
    """Affine (scale + shift) exact weighted-L1 alignment of (..., N) depths.
    Anchors are every index with weight > 0. Returns (scale (...), shift (...))."""
    batch_shape = depth_src.shape[:-1]
    n = depth_src.shape[-1]
    src = depth_src.reshape(-1, n)
    tgt = depth_tgt.reshape(-1, n)
    w = torch.broadcast_to(weight, depth_src.shape).reshape(-1, n)

    def make_chunk(r, a_idx):
        src_r, tgt_r = src[r], tgt[r]
        return src_r - src_r.gather(1, a_idx[:, None]), tgt_r - tgt_r.gather(1, a_idx[:, None]), w[r]

    loss, idx = _flat_anchor_align(src.shape[0], n, n, make_chunk, trunc, src.device)
    anchors = torch.where(w > 0, loss, math.inf).argmin(-1)
    idx2 = _take(idx, anchors)
    src_1, tgt_1 = _take(src, anchors), _take(tgt, anchors)
    src_2, tgt_2 = _take(src, idx2), _take(tgt, idx2)
    scale = (tgt_2 - tgt_1) / torch.where(src_2 != src_1, src_2 - src_1, 1e-7)
    shift = tgt_1 - scale * src_1
    return scale.reshape(batch_shape), shift.reshape(batch_shape)


def align_points_scale(points_src, points_tgt, weight, trunc=None):
    """One scale shared by x, y and z: (..., N, 3) points, (..., N) weight."""
    n3 = points_src.shape[-2] * 3
    return align(points_src.reshape(*points_src.shape[:-2], n3), points_tgt.reshape(*points_tgt.shape[:-2], n3),
                 weight.repeat_interleave(3, dim=-1), trunc)[0]


def _scale_shift_from_indices(points_src, points_tgt, z_only: bool, i1, idx2):
    """(scale, shift) reproduced under autograd from the winning indices: i1
    the anchor's flat (N*3) index (its z channel only when ``z_only``), idx2
    the align solution's."""
    bsz, n, _ = points_src.shape
    flat_src = points_src.reshape(bsz, n * 3)
    flat_tgt = points_tgt.reshape(bsz, n * 3)
    zeros = torch.zeros((bsz, n), dtype=points_src.dtype, device=points_src.device)
    src_00z = torch.stack([zeros, zeros, points_src[..., 2]], dim=-1)
    tgt_00z = torch.stack([zeros, zeros, points_tgt[..., 2]], dim=-1)
    anchor_src, anchor_tgt = (src_00z, tgt_00z) if z_only else (points_src, points_tgt)

    src_1, tgt_1 = _take(anchor_src.reshape(bsz, n * 3), i1), _take(anchor_tgt.reshape(bsz, n * 3), i1)
    src_2, tgt_2 = _take(flat_src, idx2), _take(flat_tgt, idx2)
    scale = (tgt_2 - tgt_1) / torch.where(src_2 != src_1, src_2 - src_1, 1.0)

    pix = (i1 // 3)[:, None, None].expand(bsz, 1, 3)
    src_a, tgt_a = anchor_src.gather(1, pix)[:, 0], anchor_tgt.gather(1, pix)[:, 0]
    return scale, tgt_a - scale[:, None] * src_a


def _align_points_scale_shift(points_src, points_tgt, weight, trunc, z_only: bool):
    batch_shape = points_src.shape[:-2]
    n = points_src.shape[-2]
    src = points_src.reshape(-1, n, 3)
    tgt = points_tgt.reshape(-1, n, 3)
    w = weight.reshape(-1, n)
    z_mask = torch.tensor([0.0, 0.0, 1.0], dtype=src.dtype, device=src.device) if z_only else None

    def make_chunk(r, a_idx):
        src_r, tgt_r = src[r], tgt[r]                      # (M, n, 3)
        av_s, av_t = src[r, a_idx], tgt[r, a_idx]          # (M, 3)
        if z_mask is not None:                             # anchor vector = (0, 0, z_a)
            av_s, av_t = av_s * z_mask, av_t * z_mask
        m = av_s.shape[0]
        xs = (src_r - av_s[:, None, :]).reshape(m, n * 3)
        ys = (tgt_r - av_t[:, None, :]).reshape(m, n * 3)
        return xs, ys, w[r][:, :, None].expand(m, n, 3).reshape(m, n * 3)

    loss, idx = _flat_anchor_align(src.shape[0], n, n * 3, make_chunk, trunc, src.device)
    anchor = torch.where(w > 0, loss, math.inf).argmin(-1)
    idx2 = _take(idx, anchor)
    i1 = anchor * 3 + idx2 % 3  # the anchor pixel, same coordinate as idx2
    scale, shift = _scale_shift_from_indices(src, tgt, z_only, i1, idx2)
    if SOLVES is not None:
        SOLVES.append((scale.detach(), shift.detach(), anchor, idx2))
    return scale.reshape(batch_shape), shift.reshape(*batch_shape, 3)


def align_points_scale_z_shift(points_src, points_tgt, weight, trunc=None):
    """One xyz scale and a z shift (the global loss's solver)."""
    return _align_points_scale_shift(points_src, points_tgt, weight, trunc, z_only=True)


def align_points_scale_xyz_shift(points_src, points_tgt, weight, trunc=None):
    """One xyz scale and an xyz shift (the local loss's solver)."""
    return _align_points_scale_shift(points_src, points_tgt, weight, trunc, z_only=False)


def align_points_z_shift(points_src, points_tgt, weight, trunc=None):
    """Z shift only: (..., 3) shift with zero x and y."""
    shift = align(torch.ones_like(points_src[..., 2]), points_tgt[..., 2] - points_src[..., 2], weight, trunc)[0]
    zeros = torch.zeros_like(shift)
    return torch.stack([zeros, zeros, shift], dim=-1)


def align_points_xyz_shift(points_src, points_tgt, weight, trunc=None):
    """One shift per axis: (..., 3)."""
    return align(torch.ones_like(points_src.transpose(-2, -1)), (points_tgt - points_src).transpose(-2, -1),
                 weight[..., None, :], trunc)[0]


def align_affine_lstsq(x, y, w=None):
    """Weighted least-squares affine fit y ~ a x + b over the last axis, by
    the 2x2 normal equations in the inputs' dtype. Returns (a, b)."""
    w_sqrt = torch.ones_like(x) if w is None else w.sqrt()
    A = torch.stack([w_sqrt * x, torch.ones_like(x)], dim=-1)
    b = (w_sqrt * y)[..., None]
    AtA = A.transpose(-2, -1) @ A
    Atb = A.transpose(-2, -1) @ b
    sol = torch.linalg.solve(AtA + 1e-12 * torch.eye(2, dtype=x.dtype, device=x.device), Atb)[..., 0]
    return sol[..., 0], sol[..., 1]
