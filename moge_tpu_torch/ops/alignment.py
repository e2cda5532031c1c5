"""Exact weighted-L1 alignment solvers (port of moge_tpu/ops/alignment.py).

The solvers behind MoGe's affine-invariant losses:

* ``align`` without truncation: the exact minimizer of sum_i w_i |a x_i - y_i|
  by the sorted-derivative zero crossing.
* ``align`` with truncation: the minimizer of sum_i min(t, w_i |a x_i - y_i|),
  found by evaluating the objective densely at every breakpoint a = y_j/x_j
  (``dense_objective``) and taking the first argmin. On CUDA tensors the
  dense objective is kernel K4 (``csrc/dense_align.cu``) at every length;
  on CPU tensors it is ``dense_objective_plain``, the chunked broadcast form
  of the JAX package. The sorted ``events``/``prefix`` forms are not ported.
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
import math
from typing import Callable, List, Optional, Tuple, Union

import torch

from . import _build

__all__ = ["align", "dense_objective", "dense_objective_plain", "align_depth_scale", "align_depth_affine",
           "align_points_scale", "align_points_scale_z_shift", "align_points_scale_xyz_shift",
           "align_points_z_shift", "align_points_xyz_shift", "align_affine_lstsq", "LAUNCHES", "SOLVES"]

LAUNCHES = 0  # K4 launches made by dense_objective (never by the plain version)
# When set to a list, every anchor solve appends (scale, shift, anchor index,
# second index), detached: lets a caller compare the solvers' choices.
SOLVES: Optional[List[Tuple[torch.Tensor, ...]]] = None

Trunc = Union[float, torch.Tensor]

_PLAIN_ELEMS = 1 << 25   # broadcast elements per chunk of the plain dense objective
_ANCHOR_ELEMS = 1 << 22  # elements per problem tensor per chunk of the CPU anchor solve


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


def dense_objective(A: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor, t: Trunc) -> torch.Tensor:
    """The dense truncated-L1 objective of R problems of length L: (R, L) fp32
    ``A``, ``wx``, ``wy``; ``t`` a float (passed to the kernel as a scalar) or
    an (R, L) tensor. CUDA tensors run kernel K4; CPU tensors run
    ``dense_objective_plain``."""
    global LAUNCHES
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
    lib = _build.load("dense_align")
    fn = lib.moge_dense_objective
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(A.device):  # launch on the tensors' card
        rc = fn(A.data_ptr(), wx.data_ptr(), wy.data_ptr(), t.data_ptr() if per_term else None,
                0.0 if per_term else float(t), F.data_ptr(), R, L, _build.stream_ptr(A))
    _build.check(lib, rc, "dense_objective")
    LAUNCHES += 1
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

    return _align_trunc_dense(xs, ys, w, trunc, eps)


def _flat_anchor_align(n_rows: int, n_anchors: int, length: int, make_chunk: Callable, trunc,
                       device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the n_rows * n_anchors independent ``align`` problems of size
    ``length`` in flat chunks over (row, anchor) pairs, without autograd.
    ``make_chunk(row_idx, anchor_idx)`` builds the (M, length) problem
    tensors. On the card everything is one chunk (one K4 launch per solve,
    about 8 (pairs, length) fp32 arrays of device memory); on the CPU chunks
    of ``_ANCHOR_ELEMS`` elements bound the memory. Returns per-pair
    ``(loss, index)``, each (n_rows, n_anchors)."""
    total = n_rows * n_anchors
    elems = total * max(length, 1) if device.type == "cuda" else _ANCHOR_ELEMS
    m = int(min(total, max(128, elems // max(length, 1))))
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
