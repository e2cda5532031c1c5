"""Derived weights of a module: cached for inference, differentiable for training.

Parameters stay fp32 (as the JAX package keeps them); compute casts them
to the activation dtype, and the decoder expands some of them (folded and
parity-expanded up2 conv weights). Under ``torch.no_grad()`` or
``torch.inference_mode()`` ``derived`` computes such a tensor once and
reuses it until one of its source parameters changes (in-place update,
``load_state_dict`` or a move to another device). With grad mode on and a
source parameter that requires grad, it recomputes the tensor on every call
under autograd, so gradients reach the parameters and no cached tensor
outlives a parameter update. While a program is traced (``torch.export``)
it reads no parameter's address or version (a traced parameter may be a
fake tensor): it returns the entry cached under the key for the same tag,
so a program exported after one eager call of the same shapes holds the
derived weights as constants (``models/export.py``). ``remat_call`` runs
a module as an activation checkpoint (the models' ``remat``), its derived
weights rebuilt inside it.
"""

from __future__ import annotations

from typing import Any, Callable, Hashable

import torch
import torch.utils.checkpoint
from torch import nn


def derived(module: nn.Module, key: Hashable, fn: Callable[..., Any], *params: torch.Tensor,
            tag: Hashable = None) -> Any:
    """``fn(*params)``: under autograd when grad mode is on and a parameter
    requires grad, else memoized on ``module`` under ``key``. A different
    ``tag`` (e.g. the shape it was built for) replaces the entry, so each key
    holds one tensor."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return fn(*params)
    cache = module.__dict__.setdefault("_derived", {})
    hit = cache.get(key)
    if torch.compiler.is_compiling():
        return hit[1] if hit is not None and hit[0][0] == tag else fn(*params)
    stamp = (tag, tuple((p._version, p.data_ptr(), p.device) for p in params))
    if hit is None or hit[0] != stamp:
        with torch.no_grad():  # from detached parameters: a view of one would still require grad
            hit = (stamp, fn(*(p.detach() for p in params)))
        cache[key] = hit
    return hit[1]


def drop_derived(module: nn.Module) -> None:
    """Forget every cached derived weight of ``module`` and its submodules."""
    for sub in module.modules():
        sub.__dict__.pop("_derived", None)


def cast(module: nn.Module, name: str, dtype: torch.dtype) -> torch.Tensor:
    """Parameter ``name`` of ``module`` in ``dtype`` (a cached copy for inference when it differs)."""
    p = getattr(module, name)
    if p.dtype == dtype:
        return p
    return derived(module, (name, dtype), lambda t: t.to(dtype), p)


def remat_call(module: nn.Module, remat: bool, *args: Any) -> Any:
    """``module(*args)``; with ``remat`` and grad mode on, as an activation
    checkpoint: the region keeps only its inputs for the backward and runs
    its forward again there to rebuild what its backward needs. The
    checkpoint is the non-reentrant form: the reentrant one runs the first
    forward under ``no_grad``, where ``derived`` hands out detached cached
    weights. With grad mode off no checkpoint is entered, so inference runs
    as without ``remat``."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(module, *args, use_reentrant=False)
    return module(*args)
