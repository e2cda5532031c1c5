"""The host's time per kernel call and batch-1 ``infer`` latency of this
checkout against a second one (a parent commit), both loaded in one process
and timed in alternating rounds on one CUDA GPU, so that drift of the host
and the card falls on both alike.

    python3 moge_tpu_torch/tools/host_compare.py --parent DIR [--rounds 5] [--tokens 1369] [--repeats 5]

``--parent`` is a checkout whose ``moge_tpu_torch`` is loaded beside this
one under the package name ``parent_moge_tpu_torch`` (the package imports
itself only relatively) and builds its own kernels. Measurements:

- host µs per call (``roofline.host_us``: the host clock over 200
  back-to-back calls, median of 21) of the K1, K2 and K3 wrappers without a
  gradient, bf16 at main-path shapes: K1 M = 1370 D = 1024; K2 B = 1
  N = 1370 H = 16 on the views of one qkv; K3 148^2 128->128 with ReLU,
  bias and residual; for this checkout also each ``torch.ops.moge`` op
  called through the dispatcher (its ``.default`` overload: the route of an
  exported program) and the same launch behind a
  ``torch.library.custom_op`` defined here (namespace ``moge_probe``), the
  other way to register an op. Each call is timed once per round; the
  median and least over the rounds are reported.
- warm ``infer`` of moge-2-vitl-normal (random weights from seed 0, the
  parent's model loaded with this one's weights; bf16, sequential heads,
  518x518, batch 1, ``--tokens``): per round ``--repeats`` calls of each
  side in turn, each ended by a synchronize; the median and least over all
  calls.

Prints one line per measurement, then one JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def _load_package(alias: str, root: Path):
    """``root/moge_tpu_torch`` imported as the top-level package ``alias``."""
    init = root / "moge_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(alias, init, submodule_search_locations=[str(init.parent)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


def _custom_op_probes(norm, attention, conv):
    """K1, K2 and K3's launches registered a second time through
    ``torch.library.custom_op`` (namespace ``moge_probe``)."""

    @torch.library.custom_op("moge_probe::layer_norm", mutates_args=())
    def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
        return norm._launch(x, scale, bias, eps)

    @torch.library.custom_op("moge_probe::flash_attention", mutates_args=())
    def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return attention._launch(q, k, v, kv_valid)

    @torch.library.custom_op("moge_probe::conv3x3", mutates_args=())
    def conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                residual: Optional[torch.Tensor], input_relu: bool) -> torch.Tensor:
        return conv._launch(x, kernel, bias, residual, input_relu)

    return layer_norm, flash_attention, conv3x3


def _synced_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, required=True, help="the checkout to compare against")
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--tokens", type=int, default=1369)
    parser.add_argument("--repeats", type=int, default=5, help="warm infer calls per side and round")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("host_compare needs a CUDA GPU")
    sys.path.insert(0, str(HERE.parent.parent))
    from moge_tpu_torch.models.presets import get_preset
    from moge_tpu_torch.models.v2 import MoGeModel
    from moge_tpu_torch.ops import _build, attention, conv, norm
    from moge_tpu_torch.tools import roofline

    parent = _load_package("parent_moge_tpu_torch", args.parent.resolve())
    p_ops = {name: importlib.import_module(f"parent_moge_tpu_torch.ops.{name}")
             for name in ("_build", "norm", "attention", "conv")}
    p_v2 = importlib.import_module("parent_moge_tpu_torch.models.v2")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = roofline.card_label()
    _build.build_all()
    p_ops["_build"].build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1370, 1024, generator=gen, device="cuda").to(torch.bfloat16)
    s, b = torch.randn(1024, generator=gen, device="cuda"), torch.randn(1024, generator=gen, device="cuda")
    qkv = torch.randn(1, 1370, 3, 16, 64, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    xc = torch.randn(1, 148, 148, 128, generator=gen, device="cuda").to(torch.bfloat16)
    kc = (torch.randn(3, 3, 128, 128, generator=gen, device="cuda") / 34).to(torch.bfloat16)
    bc, rc = torch.randn(128, generator=gen, device="cuda"), torch.randn_like(xc)
    probes = _custom_op_probes(norm, attention, conv)
    ops = torch.ops.moge
    calls = {}
    for side, (n, a, c) in (("parent", (p_ops["norm"], p_ops["attention"], p_ops["conv"])),
                            ("change", (norm, attention, conv))):
        calls.update({f"K1 {side}": lambda n=n: n.layer_norm_fp32(x, s, b),
                      f"K2 {side}": lambda a=a: a.flash_attention(q, k, v),
                      f"K3 {side}": lambda c=c: c.conv3x3_replicate(xc, kc, bc, rc, True)})
    calls.update({"K1 op": lambda: ops.layer_norm.default(x, s, b, 1e-6),
                  "K2 op": lambda: ops.flash_attention.default(q, k, v, 1370),
                  "K3 op": lambda: ops.conv3x3.default(xc, kc, bc, rc, True),
                  "K1 custom_op": lambda: probes[0](x, s, b, 1e-6),
                  "K2 custom_op": lambda: probes[1](q, k, v, 1370),
                  "K3 custom_op": lambda: probes[2](xc, kc, bc, rc, True)})
    host = {name: [] for name in calls}
    for _ in range(args.rounds):
        for name, fn in calls.items():
            host[name].append(roofline.host_us(fn))
    out = {"card": card, "host_us": {name: {"median": statistics.median(us), "min": min(us), "rounds": us}
                                     for name, us in host.items()}}
    for name, row in out["host_us"].items():
        print(f"host us per call, {name}: median {row['median']:.2f}, min {row['min']:.2f} over {args.rounds} "
              f"rounds ({card})", flush=True)
    del x, qkv, q, k, v, xc, rc

    config = get_preset("moge-2-vitl-normal")["config"]
    change = MoGeModel(config, "cuda", torch.bfloat16, batched_heads=False).init_random(seed=0)
    models = {"parent": p_v2.MoGeModel(config, "cuda", torch.bfloat16, batched_heads=False), "change": change}
    models["parent"].module.load_state_dict(change.module.state_dict(), strict=True)
    image = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 518, 518, 3)).astype(np.float32)).cuda()
    times = {side: [] for side in models}
    for side, model in models.items():
        model.infer(image, num_tokens=args.tokens)  # warm-up
    for _ in range(args.rounds):
        for side, model in models.items():
            times[side] += [_synced_ms(lambda: model.infer(image, num_tokens=args.tokens))
                            for _ in range(args.repeats)]
    out["infer_ms"] = {side: {"median": statistics.median(t), "min": min(t), "calls": t} for side, t in times.items()}
    for side, row in out["infer_ms"].items():
        print(f"infer {args.tokens} tokens batch 1, {side}: median {row['median']:.2f} ms, min {row['min']:.2f} "
              f"over {len(times[side])} calls in {args.rounds} alternating rounds ({card})", flush=True)
    del parent
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
