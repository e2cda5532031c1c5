"""Derived weights cached on a module.

Parameters stay fp32 (as the JAX package keeps them); compute casts them
to the activation dtype, and the decoder expands some of them (folded and
parity-expanded up2 conv weights). ``derived`` computes such a tensor once
and reuses it until one of its source parameters changes (in-place update,
``load_state_dict`` or a move to another device).
"""

from __future__ import annotations

from typing import Any, Callable, Hashable

import torch
from torch import nn


def derived(module: nn.Module, key: Hashable, fn: Callable[..., Any], *params: torch.Tensor,
            tag: Hashable = None) -> Any:
    """``fn(*params)`` under no_grad, memoized on ``module`` under ``key``.
    A different ``tag`` (e.g. the shape it was built for) replaces the entry,
    so each key holds one tensor."""
    stamp = (tag, tuple((p._version, p.data_ptr(), p.device) for p in params))
    cache = module.__dict__.setdefault("_derived", {})
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        with torch.no_grad():
            hit = (stamp, fn(*params))
        cache[key] = hit
    return hit[1]


def cast(module: nn.Module, name: str, dtype: torch.dtype) -> torch.Tensor:
    """Parameter ``name`` of ``module`` in ``dtype`` (cached copy when it differs)."""
    p = getattr(module, name)
    if p.dtype == dtype:
        return p
    return derived(module, (name, dtype), lambda t: t.to(dtype), p)
