"""Optimizer and LR-schedule builders from the reference JSON config schema
(port of moge_tpu/train/utils.py).

Param groups select parameters by fnmatch include/exclude patterns over the
state-dict names (``configs/train/v2.json``, "optimizer"); the first
matching group wins and unmatched parameters are frozen. LR schedules are
plain functions of the number of applied updates. ``Optimizer`` is AdamW
(``torch.optim.AdamW``) behind a global-norm clip with the JAX package's
(optax's) formula, and advances its schedule count only when it applies an
update.
"""

from __future__ import annotations

import fnmatch
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

__all__ = ["parse_lr_lambda", "build_lr_schedule", "build_optimizer", "Optimizer", "clip_by_global_norm"]

_SAFE_FUNCS = {
    "min": min, "max": max, "abs": abs, "pow": pow, "floor": math.floor, "ceil": math.ceil,
    "sqrt": math.sqrt, "exp": math.exp, "log": math.log, "sin": math.sin, "cos": math.cos,
    "pi": math.pi, "e": math.e,
}


def _matches(name: str, include: Sequence[str], exclude: Sequence[str]) -> bool:
    # names get a leading and trailing dot so that "*.backbone.*" matches
    # "encoder.backbone.blocks.0.norm1.weight"
    dotted = "." + name + "."
    inc = any(fnmatch.fnmatch(dotted, pat) or fnmatch.fnmatch(name, pat) for pat in include)
    exc = any(fnmatch.fnmatch(dotted, pat) or fnmatch.fnmatch(name, pat) for pat in exclude)
    return inc and not exc


def parse_lr_lambda(expr: str) -> Callable[[int], float]:
    """An lr-lambda expression of ``epoch`` (e.g. "max(0.0, min(1.0, (epoch -
    1000) / 1000))") as a function of the update count; only the names of
    ``_SAFE_FUNCS`` and ``epoch`` are allowed."""
    code = compile(expr, "<lr_lambda>", "eval")
    for name in code.co_names:
        if name not in _SAFE_FUNCS and name != "epoch":
            raise ValueError(f"Disallowed name in lr_lambda: {name}")
    return lambda epoch: eval(code, {"__builtins__": {}}, {**_SAFE_FUNCS, "epoch": epoch})


def build_lr_schedule(config: Dict[str, Any], group_index: int = 0) -> Callable[[int], float]:
    """LR multiplier as a function of the update count, for param group
    ``group_index``: SequentialLR / LambdaLR / StepLR / ConstantLR /
    ExponentialLR compositions."""
    typ = config["type"]
    params = config.get("params", {})
    if typ == "LambdaLR":
        lams = params["lr_lambda"]
        lam = lams[group_index] if isinstance(lams, list) else lams
        return parse_lr_lambda(lam) if isinstance(lam, str) else lam
    if typ == "StepLR":
        size, gamma = params["step_size"], params.get("gamma", 0.1)
        return lambda step: gamma ** (step // size)
    if typ == "ConstantLR":
        factor, total = params.get("factor", 1.0 / 3), params.get("total_iters", 5)
        return lambda step: factor if step < total else 1.0
    if typ == "ExponentialLR":
        gamma = params["gamma"]
        return lambda step: gamma ** step
    if typ == "SequentialLR":
        subs = [build_lr_schedule(s, group_index) for s in params["schedulers"]]
        starts = [0] + list(params["milestones"])

        def fn(step):
            # the active scheduler sees a step count local to its start
            i = max(k for k, start in enumerate(starts) if step >= start)
            return subs[i](step - starts[i])

        return fn
    raise ValueError(f"Unsupported lr_scheduler type: {typ}")


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float) -> Dict[str, torch.Tensor]:
    """optax's clip: g unchanged when ||g|| < max_norm, else g / ||g|| * max_norm
    (no epsilon), with ||g|| the fp32 norm over every gradient."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    return {k: torch.where(norm < max_norm, g, g / norm.to(g.dtype) * max_norm) for k, g in grads.items()}


class Optimizer:
    """AdamW over fnmatch param groups, with per-group LR schedules and a
    global-norm clip. ``step(grads)`` applies one update from a dict of
    gradients by state-dict name; gradients of frozen parameters count in
    the clip's norm (as in the JAX package's chain) but update nothing."""

    def __init__(self, named_params: List[Tuple[str, nn.Parameter]], groups: List[List[str]],
                 group_cfgs: List[Dict[str, Any]], schedules: List[Optional[Callable[[int], float]]],
                 max_grad_norm: Optional[float]):
        self.params = dict(named_params)
        self.groups = groups
        self.base_lrs = [cfg["lr"] for cfg in group_cfgs]
        self.schedules = schedules
        self.max_grad_norm = max_grad_norm
        self.count = 0  # updates applied so far: the schedules' step
        torch_groups = [{"params": [self.params[n] for n in names], **cfg}
                        for names, cfg in zip(groups, group_cfgs) if names]
        self.adamw = torch.optim.AdamW(torch_groups)  # every group sets its own lr
        self._active = [i for i, names in enumerate(groups) if names]

    def lrs(self) -> List[float]:
        """Each group's learning rate for the next update."""
        return [base * (1.0 if s is None else s(self.count)) for base, s in zip(self.base_lrs, self.schedules)]

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        if self.max_grad_norm is not None:
            grads = clip_by_global_norm(grads, self.max_grad_norm)
        lrs = self.lrs()
        for torch_group, gi in zip(self.adamw.param_groups, self._active):
            torch_group["lr"] = lrs[gi]
        for gi in self._active:
            for name in self.groups[gi]:
                self.params[name].grad = grads[name]
        self.adamw.step()
        for gi in self._active:
            for name in self.groups[gi]:
                self.params[name].grad = None
        self.count += 1


def build_optimizer(module: nn.Module, optimizer_config: Dict[str, Any],
                    lr_scheduler_config: Optional[Dict[str, Any]] = None,
                    max_grad_norm: Optional[float] = 1.0) -> Optimizer:
    """AdamW with fnmatch param groups over ``module``'s trainable parameters,
    an optional schedule and a global-norm clip. Group keys: ``lr`` (default
    1e-4), ``betas`` (0.9, 0.999), ``weight_decay`` (0.01), ``eps`` (1e-8),
    each falling back to the optimizer config's own."""
    if optimizer_config.get("type", "AdamW") not in ("AdamW", "Adam"):
        raise ValueError(f"unsupported optimizer {optimizer_config.get('type')!r}")
    named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
    specs = optimizer_config["params"]
    groups: List[List[str]] = [[] for _ in specs]
    for name, _ in named:
        for gi, spec in enumerate(specs):
            sel = spec["params"]
            if _matches(name, sel.get("include", ["*"]), sel.get("exclude", [])):
                groups[gi].append(name)
                break
    cfgs = []
    for spec in specs:
        get = lambda key, default: spec.get(key, optimizer_config.get(key, default))  # noqa: E731
        cfgs.append({"lr": spec.get("lr", 1e-4), "betas": tuple(get("betas", (0.9, 0.999))),
                     "weight_decay": get("weight_decay", 0.01), "eps": get("eps", 1e-8)})
    schedules = [None if lr_scheduler_config is None else build_lr_schedule(lr_scheduler_config, gi)
                 for gi in range(len(specs))]
    return Optimizer(named, groups, cfgs, schedules, max_grad_norm)
