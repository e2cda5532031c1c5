"""A bitonic sorting network for batched row sorts, in plain PyTorch (port of
moge_tpu/ops/bitonic.py).

Each compare-swap stage is a reshape and elementwise compare/select over the
whole (batch, L) array, on whatever device the keys are on: O(L log^2 L)
elementwise passes, one stage per (m, d) of the network, as in the JAX
package. The JAX package's events form of the truncated align takes it when
``3n <= MOGE_BITONIC_MAX``; the port's events form sorts by ``torch.sort``
(``ops/alignment.sort_stable``), which gives the same permutation on finite
keys, so no path of the port calls the network.

Stability: a bitonic network is not stable, so the comparator orders by
(key, original position), which gives a stable sort's permutation. Keys are
compared with IEEE ``>`` and ``==`` as in the JAX network (``-0.0 == 0.0``;
a NaN key never compares out of order).

Padding: rows are padded to the next power of two with +inf keys and zero
payloads, which sort behind every real key (a real +inf key too, by
position) and are sliced off.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["sort_with_payloads"]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def sort_with_payloads(keys: torch.Tensor, payloads: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Sort ``keys`` ascending along the last axis, stably, carrying each of
    ``payloads`` (same shape, any dtype) through the same permutation.
    Returns ``(keys, *payloads)`` sorted, each of the input's shape."""
    n = keys.shape[-1]
    lp = _next_pow2(n)
    batch_shape = keys.shape[:-1]
    dev = keys.device

    pos = torch.arange(lp, dtype=torch.int32, device=dev).expand(*batch_shape, lp)
    streams = [keys, *payloads]
    if lp != n:
        streams = [torch.cat([keys, keys.new_full((*batch_shape, lp - n), torch.inf)], dim=-1)] + [
            torch.cat([p, p.new_zeros((*batch_shape, lp - n))], dim=-1) for p in payloads]
    streams.insert(1, pos)

    m = 2
    while m <= lp:
        d = m // 2
        while d >= 1:
            # pairs (i, i ^ d): the last axis as (lp / 2d, 2, d); axis -2 holds
            # the lower and upper halves of each 2d group
            shaped = [s.reshape(*batch_shape, lp // (2 * d), 2, d) for s in streams]
            lo = [s[..., 0, :] for s in shaped]
            hi = [s[..., 1, :] for s in shaped]
            # ascending where the m-bit of the flat position is 0; each 2d
            # group lies inside one m block, so the direction is per group
            g = torch.arange(lp // (2 * d), dtype=torch.int32, device=dev) * (2 * d)
            asc = ((g & m) == 0)[:, None]
            k_lo, p_lo, k_hi, p_hi = lo[0], lo[1], hi[0], hi[1]
            out_of_order = (k_lo > k_hi) | ((k_lo == k_hi) & (p_lo > p_hi))
            swap = torch.where(asc, out_of_order, ~out_of_order)
            streams = [torch.stack([torch.where(swap, hi_s, lo_s), torch.where(swap, lo_s, hi_s)], dim=-2)
                       .reshape(*batch_shape, lp) for lo_s, hi_s in zip(lo, hi)]
            d //= 2
        m *= 2

    return (streams[0][..., :n], *(s[..., :n] for s in streams[2:]))
