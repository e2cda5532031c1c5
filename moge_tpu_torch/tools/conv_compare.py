"""K3 of one checkout of the port on one CUDA GPU: device time at the main
path's conv shapes and the host's time per launch of the wrapper, so that
two checkouts (a parent commit and a change) can be run in turns on one
card and compared by the same measure.

    python3 moge_tpu_torch/tools/conv_compare.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``moge_tpu_torch.ops.conv`` is timed
(default: the one this file lies in); its ``conv3x3_replicate`` takes (x,
kernel, bias, residual, input_relu), as in every version of the port. The
timing code is this file's own (``roofline.py`` beside it, loaded by path).

- Device ms: ``roofline.device_ms`` (the kernels' durations from
  torch.profiler, median of 3 traces of 20 calls), bf16, batch 1, at the
  conv shapes of a moge-2-vitl-normal ``infer`` at 1369 tokens (launches
  per infer beside each, and their sum) and K3-grouped at G=3, B0=1, 296^2
  64->64.
- Host us per launch: the host clock around ``CALLS`` back-to-back calls
  of the wrapper on a 1x8x8x64 -> 64 input with ReLU and residual, issued
  after a synchronize and timed before the next one (fewer calls than the
  launch queue holds, so the host never waits for the card), over
  ``CALLS``, median of ``REPS``. Beside it the same call's device time.

Prints one line per shape, then one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
CALLS = 200
REPS = 21
# (H, C, O, input ReLU, residual, launches per infer): the three ConvStack
# levels' res-block convs, then the up2 convs at 296^2 (the neck's 4 x 32
# parities, the points and normal heads' 4 x 3, the mask head's 4 x 1)
SHAPES = [(h, c, c, relu, res, n) for h, c in ((74, 256), (148, 128), (296, 64))
          for relu, res, n in ((True, False, 5), (True, True, 5), (False, False, 4))] + \
         [(296, 64, 128, False, False, 1), (296, 64, 12, False, False, 2), (296, 64, 4, False, False, 1)]


def _roofline():
    spec = importlib.util.spec_from_file_location("conv_compare_roofline", HERE / "roofline.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(gen, G, B0, H, C, O, residual):
    dev = torch.device("cuda")
    x = torch.randn(G * B0, H, H, C, generator=gen, device=dev).to(torch.bfloat16)
    kern = (torch.randn(*((G,) if G > 1 else ()), 3, 3, C, O, generator=gen, device=dev) * (9 * C) ** -0.5)
    bias = torch.randn(*((G,) if G > 1 else ()), O, generator=gen, device=dev) * 0.1
    res = torch.randn(G * B0, H, H, O, generator=gen, device=dev).to(torch.bfloat16) if residual else None
    return x, kern.to(torch.bfloat16).contiguous(), bias, res


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=HERE.parent.parent, help="checkout whose K3 is timed")
    parser.add_argument("--label", default=None, help="name printed with the results (default: --root)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_compare needs a CUDA GPU")
    roofline = _roofline()
    sys.path.insert(0, str(args.root.resolve()))
    from moge_tpu_torch.ops import conv

    label = args.label or str(args.root)
    card = roofline.card_label()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"label": label, "card": card, "device_ms": {}}
    per_infer = 0.0
    for h, c, o, relu, use_res, n in SHAPES:
        x, kern, bias, res = _inputs(gen, 1, 1, h, c, o, use_res)
        ms = roofline.device_ms(lambda: conv.conv3x3_replicate(x, kern, bias, res, relu))
        key = f"{h}^2 {c}->{o} relu={relu} residual={use_res}"
        out["device_ms"][key] = ms
        per_infer += n * ms
        print(f"[{label}] K3 {key}: device {ms:.4f} ms x {n} per infer ({card})", flush=True)
    out["per_infer_ms"] = per_infer
    x, kern, bias, res = _inputs(gen, 3, 1, 296, 64, 64, True)
    out["grouped_ms"] = roofline.device_ms(lambda: conv.conv3x3_replicate(x, kern, bias, res, True))
    print(f"[{label}] K3 per infer {per_infer:.4f} ms; K3-grouped G=3 B0=1 296^2 64->64 relu+res: device "
          f"{out['grouped_ms']:.4f} ms ({card})", flush=True)

    x, kern, bias, res = _inputs(gen, 1, 1, 8, 64, 64, True)

    def launch():
        conv.conv3x3_replicate(x, kern, bias, res, True)

    for _ in range(100):
        launch()
    per_launch = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            launch()
        per_launch.append((time.perf_counter() - t0) / CALLS * 1e6)
    torch.cuda.synchronize()
    out["host_us_per_launch"] = statistics.median(per_launch)
    out["small_device_us"] = roofline.device_ms(launch) * 1e3
    print(f"[{label}] host {out['host_us_per_launch']:.2f} us per launch (1x8x8x64->64 relu+res, "
          f"{CALLS} calls, median of {REPS}, range {min(per_launch):.2f}-{max(per_launch):.2f}); device "
          f"{out['small_device_us']:.2f} us per launch ({card})", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
