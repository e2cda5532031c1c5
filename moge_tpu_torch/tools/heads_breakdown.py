"""Batched against sequential MoGe-2 output heads on one CUDA GPU.

    python -m moge_tpu_torch.tools.heads_breakdown [--tokens 1369 3600] [--batch 1 8] [--repeats 5]

``moge-2-vitl-normal``, random weights from seed 0, bf16, 518x518 images.
Three paths over the same weights: the sequential heads, the batched heads
with the folded finest projections padded to ``multihead.FOLD_PAD`` (32
channels, as JAX), and the batched heads with the fold padded only to the
widest head. For each token count and batch size it holds the batched
paths' raw maps against the sequential ones, prints host-clock medians of
``infer`` with the paths run in turns, then a torch.profiler table per
path: kernel time per ``infer``, busy share (kernel time over the profiled
wall time), launches per ``infer``, the time of K3 (with K3-grouped) and of
K2, and the largest kernels.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import time

import numpy as np
import torch

from ..models import multihead
from ..models.presets import get_preset
from ..models.v2 import MoGeModel, base_token_grid
from ..ops import _build
from ..ops.resize import resize_2d
from . import roofline

RAW_RTOL = 3e-2  # relative L2 of each raw map, batched vs sequential heads (bf16 sums in another order)


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tokens", type=int, nargs="+", default=[1369, 3600])
    parser.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    parser.add_argument("--repeats", type=int, default=5, help="infer calls of each path in turns")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("heads_breakdown needs a CUDA GPU")
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = roofline.card_label()
    _build.build_all()
    config = get_preset("moge-2-vitl-normal")["config"]
    seq = MoGeModel(config, "cuda", torch.bfloat16, batched_heads=False).init_random(seed=0)
    paths = {"sequential": (seq, multihead.FOLD_PAD)}
    for name, pad in (("batched", multihead.FOLD_PAD), ("batched, fold unpadded", 1)):
        model = MoGeModel(config, "cuda", torch.bfloat16, batched_heads=True)
        model.module.load_state_dict(seq.module.state_dict(), strict=True)
        paths[name] = (model, pad)
    default_pad = multihead.FOLD_PAD

    def call(name, fn):
        model, pad = paths[name]
        multihead.FOLD_PAD = pad  # read when the model first builds its stacked weights
        return fn(model)

    rng = np.random.default_rng(0)
    try:
        for tokens in args.tokens:
            for batch in args.batch:
                label = f"{tokens} tokens batch {batch}"
                images = torch.from_numpy(rng.uniform(0, 1, (batch, 518, 518, 3)).astype(np.float32)).cuda()
                base_h, base_w = base_token_grid(tokens, 1.0)
                image_14 = resize_2d(images, (14 * base_h, 14 * base_w), mode="bilinear", antialias=True)
                with torch.inference_mode():
                    raws = {name: call(name, lambda m: m.module.decode(image_14, base_h, base_w, 1.0, torch.bfloat16))
                            for name in paths}
                for name in list(paths)[1:]:
                    for key, want in raws["sequential"].items():
                        got, want = raws[name][key].float(), want.float()
                        rel = ((got - want).norm() / want.norm()).item()
                        if not rel <= RAW_RTOL:
                            raise AssertionError(f"{label} {name} {key}: relative L2 {rel} > {RAW_RTOL}")

                times = collections.defaultdict(list)
                for rep in range(args.repeats):
                    for name in (list(paths) if rep % 2 == 0 else list(paths)[::-1]):
                        times[name].append(_timed(lambda: call(name, lambda m: m.infer(images, num_tokens=tokens))))
                print(f"[turns] {label}: " + ", ".join(
                    f"{n} {statistics.median(t):.2f} ms (min {min(t):.2f})" for n, t in times.items()) + f" ({card})")

                for name in paths:
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        wall = _timed(lambda: [call(name, lambda m: m.infer(images, num_tokens=tokens))
                                               for _ in range(3)]) / 3
                    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
                    ms, count = collections.Counter(), collections.Counter()
                    for e in kernels:
                        ms[e.name] += e.device_time_total / 1e3 / 3
                        count[e.name] += 1
                    busy = sum(ms.values())
                    k3 = sum(v for k, v in ms.items() if "conv3x3" in k)
                    k2 = sum(v for k, v in ms.items() if "flash_fwd" in k)
                    print(f"[profile] {label} {name}: wall {wall:.2f} ms/infer (profiled), kernel time {busy:.2f} "
                          f"ms/infer, busy {busy / wall:.3f}, {len(kernels) // 3} launches/infer, K3 (+grouped) "
                          f"{k3:.2f} ms, K2 {k2:.2f} ms ({card})")
                    for k, v in ms.most_common(8):
                        print(f"    {v:8.3f} ms x{count[k] // 3:4d}  {k[:100]}")
    finally:
        multihead.FOLD_PAD = default_pad


if __name__ == "__main__":
    main()
