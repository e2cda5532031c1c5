"""K2, T1 and ViT-L ``infer`` of one checkout of the port on one CUDA GPU, so
that two checkouts (a parent commit and a change) can be run in turns on one
card and compared by the same measures.

    python3 moge_tpu_torch/tools/attention_compare.py [--root DIR] [--label NAME]
        [--tokens 1369 3600] [--batch 1 8] [--repeats 5]

``--root`` is the checkout whose ``moge_tpu_torch`` is timed (default: the
one this file lies in); the timing code is this file's own (``roofline.py``
beside it, loaded by path).

- K2 device ms (``roofline.device_ms``: kernel durations from
  torch.profiler, median of 3 traces of 20 calls), bf16, H = 16, q/k/v the
  per-head views of a (B, N, 3, H, 64) projection, at B = 1 and 8 and N =
  1370 and 3601, beside SDPA's flash backend on the same inputs (heads
  first, moved outside the timed call).
- T1 ``base`` device ms at N = 3601 (16 heads, padded to 3712), beside
  SDPA over the 3601 real keys with scale 1.
- ``infer`` of moge-2-vitl-normal (random weights from seed 0, bf16,
  sequential heads, 518x518) at each ``--tokens`` and ``--batch``: the host
  clock's median of ``--repeats`` warm calls, each ended by a synchronize;
  then torch.profiler over 3 calls: kernel ms per infer, K2's share (the
  kernels whose name holds ``flash_fwd``), busy share (kernel time over the
  profiled wall time).

Prints one line per measurement, then one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def _roofline():
    spec = importlib.util.spec_from_file_location("attention_compare_roofline", HERE / "roofline.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sdpa(q, k, v, scale=None):
    """SDPA's flash backend on (B, N, H, 64) views, heads moved first outside the timed call."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def call():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
    return call


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=HERE.parent.parent, help="checkout whose port is timed")
    parser.add_argument("--label", default=None, help="name printed with the results (default: --root)")
    parser.add_argument("--tokens", type=int, nargs="+", default=[1369, 3600])
    parser.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    parser.add_argument("--repeats", type=int, default=5, help="warm infer calls per shape")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_compare needs a CUDA GPU")
    roofline = _roofline()
    sys.path.insert(0, str(args.root.resolve()))
    from torch.profiler import ProfilerActivity, profile

    from moge_tpu_torch.models.presets import get_preset
    from moge_tpu_torch.models.v2 import MoGeModel
    from moge_tpu_torch.ops import _build, attention
    from moge_tpu_torch.tools import exp_flash_softmax as fs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = args.label or str(args.root)
    card = roofline.card_label()
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"label": label, "card": card, "k2_device_ms": {}, "infer": {}}

    for b in (1, 8):
        for n in (1370, 3601):
            qkv = torch.randn(b, n, 3, 16, 64, generator=gen, device="cuda").to(torch.bfloat16)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            ms = roofline.device_ms(lambda: attention.flash_attention(q, k, v))
            lib = roofline.device_ms(_sdpa(q, k, v))
            out["k2_device_ms"][f"B={b} N={n}"] = {"kernel": ms, "sdpa": lib}
            print(f"[{label}] K2 B={b} H=16 N={n}: device {ms:.4f} ms, SDPA flash {lib:.4f} ms ({card})", flush=True)
            del qkv, q, k, v

    q, k, v, _, bias = fs.make_inputs(3601, "cuda")
    ms = roofline.device_ms(lambda: fs.flash_softmax_variant("base", q, k, v, bias, 3601))
    lib = roofline.device_ms(_sdpa(q[None].transpose(1, 2), k[None, :, :3601].transpose(1, 2),
                                   v[None, :, :3601].transpose(1, 2), scale=1.0))
    out["t1_base_device_ms"] = {"kernel": ms, "sdpa": lib}
    print(f"[{label}] T1 base bh=16 N=3601 (padded {q.shape[1]}): device {ms:.4f} ms, SDPA {lib:.4f} ms ({card})",
          flush=True)
    del q, k, v, bias

    model = MoGeModel(get_preset("moge-2-vitl-normal")["config"], "cuda", torch.bfloat16,
                      batched_heads=False).init_random(seed=0)
    rng = np.random.default_rng(0)
    for tokens in args.tokens:
        for batch in args.batch:
            images = torch.from_numpy(rng.uniform(0, 1, (batch, 518, 518, 3)).astype(np.float32)).cuda()
            _timed(lambda: model.infer(images, num_tokens=tokens))  # warm-up
            times = [_timed(lambda: model.infer(images, num_tokens=tokens)) for _ in range(args.repeats)]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                wall = _timed(lambda: [model.infer(images, num_tokens=tokens) for _ in range(3)]) / 3
            ms = collections.Counter()
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    ms[e.name] += e.device_time_total / 1e3 / 3
            kernel = sum(ms.values())
            k2 = sum(t for name, t in ms.items() if "flash_fwd" in name)
            row = {"warm_ms": statistics.median(times), "warm_min_ms": min(times), "kernel_ms": kernel,
                   "k2_ms": k2, "busy": kernel / wall}
            out["infer"][f"{tokens} tokens batch {batch}"] = row
            print(f"[{label}] infer {tokens} tokens batch {batch}: warm median {row['warm_ms']:.2f} ms (min "
                  f"{row['warm_min_ms']:.2f}, {args.repeats} calls); profiled: kernel {kernel:.2f} ms/infer, K2 "
                  f"{k2:.2f} ms/infer, busy {row['busy']:.3f} ({card})", flush=True)
            del images
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
