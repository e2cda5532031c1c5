"""K2, K2b, T1, K1, T6, ViT-L ``infer`` and the ViT-L train step of one
checkout of the port on one CUDA GPU, so that two checkouts (a parent commit
and a change) can be run in turns on one card and compared by the same
measures.

    python3 moge_tpu_torch/tools/attention_compare.py [--root DIR] [--label NAME]
        [--parts k2 t1 infer k2b train k1 t6] [--tokens 1369 3600] [--batch 1 8] [--repeats 5]

``--root`` is the checkout whose ``moge_tpu_torch`` is timed (default: the
one this file lies in); the timing code is this file's own (``roofline.py``
beside it, loaded by path), and so are the training batches (this
checkout's ``chip_smoke``, loaded by path). ``--parts`` picks
the measurements (default: all):

- ``k2``: K2 device ms (``roofline.device_ms``: kernel durations from
  torch.profiler, median of 3 traces of 20 calls), bf16, H = 16, q/k/v the
  per-head views of a (B, N, 3, H, 64) projection, at B = 1 and 8 and N =
  1370 and 3601, beside SDPA's flash backend on the same inputs (heads
  first, moved outside the timed call).
- ``t1``: T1 ``base`` device ms at N = 3601 (16 heads, padded to 3712),
  beside SDPA over the 3601 real keys with scale 1.
- ``infer``: ``infer`` of moge-2-vitl-normal (random weights from seed 0,
  bf16, sequential heads, 518x518) at each ``--tokens`` and ``--batch``: the
  host clock's median of ``--repeats`` warm calls, each ended by a
  synchronize; then torch.profiler over 3 calls: kernel ms per infer, K2's
  share (the kernels whose name holds ``flash_fwd``), busy share (kernel
  time over the profiled wall time).
- ``k2b``: the flash backward by device time, bf16, B = 2, H = 16, N = 1370
  and 3601, q/k/v the views of one qkv projection: the whole
  ``flash_attention_bwd`` (delta + K2b-dq + K2b-dkv), K2b-dq and K2b-dkv
  alone, beside SDPA's flash backward (dq, dk and dv in one call) on the
  same inputs.
- ``k1``: K1 (``layer_norm_fp32``), bf16, D = 1024, at M = 1370, 3601 and
  28808 (ViT-L rows at 1369 and 3600 tokens, batch 1, and 3600 tokens,
  batch 8) by device time beside ``F.layer_norm`` in bf16; at M = 1370 also
  the CUDA-event median per call (``chip_smoke.cuda_ms``, host and device
  together) and the host's time per call (``roofline.host_us``) of both.
- ``t6``: T6 (``exp_dense_pallas.dense_objective_bf16``, the checkout's
  default tile) by device time at the tool's three ``SHAPES``.
- ``train``: ``chip_smoke.py``'s train path (``train_setup``: ViT-L from
  ``configs/train/v2.json``, random weights from seed 0, bf16 compute; batch
  2 at ``TRAIN_HW``, at each of ``TRAIN_TOKENS``): the host clock's median of
  ``TRAIN_STEPS`` warm ``make_train_step`` steps, each ended by a
  synchronize, after one warm-up step; then torch.profiler over one step:
  kernel ms per step and K2b's share (kernels whose name holds ``flash_dq``
  or ``flash_dkv``).

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
PARTS = ("k2", "t1", "infer", "k2b", "train", "k1", "t6")


def _roofline():
    return _load("attention_compare_roofline", HERE / "roofline.py")


def _sdpa(q, k, v, scale=None):
    """SDPA's flash backend on (B, N, H, 64) views, heads moved first outside the timed call."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def call():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
    return call


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sdpa_bwd(q, k, v, dout):
    """SDPA's flash backward (dq, dk and dv in one call) on (B, N, H, 64) views, as ``_sdpa``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        out = F.scaled_dot_product_attention(*leaves)
    dt = dout.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, leaves, dt, retain_graph=True)


def _kernel_ms(prof, calls: int, *names: str):
    """Device ms per call of all kernels in a trace, and of those whose name holds one of ``names``."""
    ms = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms[e.name] += e.device_time_total / 1e3 / calls
    return sum(ms.values()), sum(t for name, t in ms.items() if any(n in name for n in names))


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
    parser.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS))
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
    out = {"label": label, "card": card}

    if "k2" in args.parts:
        out["k2_device_ms"] = {}
        for b in (1, 8):
            for n in (1370, 3601):
                qkv = torch.randn(b, n, 3, 16, 64, generator=gen, device="cuda").to(torch.bfloat16)
                q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
                ms = roofline.device_ms(lambda: attention.flash_attention(q, k, v))
                lib = roofline.device_ms(_sdpa(q, k, v))
                out["k2_device_ms"][f"B={b} N={n}"] = {"kernel": ms, "sdpa": lib}
                print(f"[{label}] K2 B={b} H=16 N={n}: device {ms:.4f} ms, SDPA flash {lib:.4f} ms ({card})",
                      flush=True)
                del qkv, q, k, v

    if "t1" in args.parts:
        q, k, v, _, bias = fs.make_inputs(3601, "cuda")
        ms = roofline.device_ms(lambda: fs.flash_softmax_variant("base", q, k, v, bias, 3601))
        lib = roofline.device_ms(_sdpa(q[None].transpose(1, 2), k[None, :, :3601].transpose(1, 2),
                                       v[None, :, :3601].transpose(1, 2), scale=1.0))
        out["t1_base_device_ms"] = {"kernel": ms, "sdpa": lib}
        print(f"[{label}] T1 base bh=16 N=3601 (padded {q.shape[1]}): device {ms:.4f} ms, SDPA {lib:.4f} ms "
              f"({card})", flush=True)
        del q, k, v, bias

    if "infer" in args.parts:
        out["infer"] = {}
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
                kernel, k2 = _kernel_ms(prof, 3, "flash_fwd")
                row = {"warm_ms": statistics.median(times), "warm_min_ms": min(times), "kernel_ms": kernel,
                       "k2_ms": k2, "busy": kernel / wall}
                out["infer"][f"{tokens} tokens batch {batch}"] = row
                print(f"[{label}] infer {tokens} tokens batch {batch}: warm median {row['warm_ms']:.2f} ms (min "
                      f"{row['warm_min_ms']:.2f}, {args.repeats} calls); profiled: kernel {kernel:.2f} ms/infer, "
                      f"K2 {k2:.2f} ms/infer, busy {row['busy']:.3f} ({card})", flush=True)
                del images
        del model

    if "k2b" in args.parts:
        out["k2b_device_ms"] = {}
        for n in (1370, 3601):
            qkv = torch.randn(2, n, 3, 16, 64, generator=gen, device="cuda").to(torch.bfloat16)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            dout = torch.randn(2, n, 16, 64, generator=gen, device="cuda").to(torch.bfloat16)
            o, lse = attention.flash_attention_fwd(q, k, v)
            delta = attention.attention_bwd_delta(o, dout)
            row = {"bwd": roofline.device_ms(lambda: attention.flash_attention_bwd(q, k, v, o, lse, dout)),
                   "dq": roofline.device_ms(lambda: attention.flash_attention_bwd_dq(q, k, v, dout, lse, delta, n)),
                   "dkv": roofline.device_ms(
                       lambda: attention.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, n)),
                   "sdpa_bwd": roofline.device_ms(_sdpa_bwd(q, k, v, dout))}
            out["k2b_device_ms"][f"B=2 N={n}"] = row
            print(f"[{label}] K2b B=2 H=16 N={n}: device ms: backward (delta + dq + dkv) {row['bwd']:.4f}, dq "
                  f"{row['dq']:.4f}, dkv {row['dkv']:.4f}; SDPA flash backward {row['sdpa_bwd']:.4f} ({card})",
                  flush=True)
            del qkv, q, k, v, dout, o, lse, delta
        torch.cuda.empty_cache()

    if "k1" in args.parts:
        import torch.nn.functional as F

        from moge_tpu_torch.ops import norm

        smoke = _load("attention_compare_chip_smoke", HERE.parent.parent / "chip_smoke.py")
        out["k1"] = {}
        for m in (1370, 3601, 28808):
            x = (torch.randn(m, 1024, generator=gen, device="cuda") * 3 + 1).to(torch.bfloat16)
            s, b = torch.randn(1024, generator=gen, device="cuda"), torch.randn(1024, generator=gen, device="cuda")
            sb, bb = s.to(torch.bfloat16), b.to(torch.bfloat16)
            kernel = lambda: norm.layer_norm_fp32(x, s, b)  # noqa: E731
            library = lambda: F.layer_norm(x, (1024,), sb, bb, 1e-6)  # noqa: E731
            row = {"device_ms": roofline.device_ms(kernel), "library_device_ms": roofline.device_ms(library)}
            text = f"device {row['device_ms']:.4f} ms, F.layer_norm {row['library_device_ms']:.4f} ms"
            if m == 1370:
                row.update(events_ms=smoke.cuda_ms(kernel), library_events_ms=smoke.cuda_ms(library),
                           host_us=roofline.host_us(kernel), library_host_us=roofline.host_us(library))
                text += (f"; events {row['events_ms']:.4f} ms, F.layer_norm {row['library_events_ms']:.4f} ms; host "
                         f"us per call {row['host_us']:.2f}, F.layer_norm {row['library_host_us']:.2f}")
            out["k1"][f"M={m}"] = row
            print(f"[{label}] K1 bf16 M={m} D=1024: {text} ({card})", flush=True)
            del x

    if "t6" in args.parts:
        from moge_tpu_torch.tools import exp_dense_pallas as dense

        out["t6_device_ms"] = {}
        for shape, (R, L) in dense.SHAPES.items():
            _, _, _, A, wx, wy = dense.make_problem(R, L, "cuda")
            ms = roofline.device_ms(lambda: dense.dense_objective_bf16(A, wx, wy, 1.0))
            out["t6_device_ms"][shape] = ms
            print(f"[{label}] T6 {shape} R={R} L={L} (tile {dense.VARIANTS['bf16'][1]}): device {ms:.4f} ms ({card})",
                  flush=True)
            del A, wx, wy
        torch.cuda.empty_cache()

    if "train" in args.parts:
        from moge_tpu_torch.train.step import make_train_step

        smoke = _load("attention_compare_chip_smoke", HERE.parent.parent / "chip_smoke.py")
        cfg, module, tx, state = smoke.train_setup("cuda")
        label_types = list(cfg["loss"])
        rng = np.random.default_rng(2)
        tgen = torch.Generator(device="cuda").manual_seed(0)
        out["train"] = {}
        for tokens in smoke.TRAIN_TOKENS:
            step = make_train_step(module, tx, cfg["loss"], label_types, tokens, dtype=torch.bfloat16)
            batch = smoke.train_batch(rng, 2, smoke.TRAIN_HW, label_types.index("A"), "cuda")

            def one():
                nonlocal state
                state, _ = step(state, batch, tgen)

            _timed(one)  # warm-up
            times = [_timed(one) for _ in range(smoke.TRAIN_STEPS)]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _timed(one)
            kernel, k2b = _kernel_ms(prof, 1, "flash_dq", "flash_dkv")
            row = {"step_ms": statistics.median(times), "step_min_ms": min(times), "kernel_ms": kernel,
                   "k2b_ms": k2b}
            out["train"][f"{tokens} tokens"] = row
            print(f"[{label}] train step ViT-L batch 2 512x512 {tokens} tokens: warm median {row['step_ms']:.1f} ms "
                  f"(min {row['step_min_ms']:.1f}, {smoke.TRAIN_STEPS} steps); profiled: kernel {kernel:.1f} ms/step, "
                  f"K2b {k2b:.2f} ms/step ({card})", flush=True)
            del batch
        del module, state, tx
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
