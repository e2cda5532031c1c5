#!/usr/bin/env python3
"""Drive the PyTorch port's MoGe-2 inference once on one CUDA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py`` (one GPU, nvcc on
PATH or under $CUDA_HOME). Phases, any failure raising:

1. device: require CUDA, print the card's name and power limit, disable TF32;
2. build the hand-written kernels from ``moge_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes plus ragged edges, with errors and median times;
4. the slice at full width: ``moge-2-vitl-normal`` with random weights from a
   seed, bf16, four ``infer`` requests, launch counters per forward;
5. whole-model parity: ``moge-2-vits-normal`` decode, bf16 with the kernels on
   the card against fp32 with the plain versions on the CPU.

Prints a JSON line with the kernels' numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. No CPU fallback: without a
GPU, or without the package beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
# rtol of the relative L2 error of each raw map (bf16 on the card vs fp32 on the CPU)
MODEL_L2_RTOL = 3e-2
K2_MAX_ABS = 2e-2
K3_REL = 1e-2


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN")
    return smi.splitlines()[0]


def phase_build():
    from moge_tpu_torch.ops import _build

    times = _build.build_all()
    log("[build] " + ", ".join(f"{k} {v:.1f}s" for k, v in times.items()))
    for name, text in _build.BUILD_LOG.items():  # ptxas -v: registers and spills per library
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", text))
        log(f"[build] {name}: {len(regs)} kernels, at most {max(regs, default=0)} registers, "
            f"{spills} bytes of spill stores")


def phase_kernels():
    """Each kernel vs its plain version (fp32 from the same bf16 inputs)."""
    import torch

    from moge_tpu_torch.ops import attention, conv, norm

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf16)

    results = {}

    # K1 LayerNorm: tolerance one bf16 ulp at the output's largest magnitude
    k1 = []
    for m, d in ((1370, 1024), (3601, 1024), (37, 192)):
        x = randn(m, d, scale=3.0) + 1.0
        s = torch.randn(d, generator=gen, device=dev)
        b = torch.randn(d, generator=gen, device=dev)
        got = norm.layer_norm_fp32(x, s, b).float()
        want = norm.layer_norm_plain(x.float(), s, b)
        err = (got - want).abs().max().item()
        tol = want.abs().max().item() * 2.0 ** -8
        ms = cuda_ms(lambda: norm.layer_norm_fp32(x, s, b))
        plain_ms = cuda_ms(lambda: norm.layer_norm_plain(x, s, b))
        log(f"[K1] M={m} D={d}: max_abs_err {err:.3e} (tol {tol:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not err <= tol:
            raise AssertionError(f"K1 LayerNorm disagrees at M={m} D={d}: {err} > {tol}")
        k1.append((err, ms, plain_ms))
    results["layer_norm"] = k1

    # K2 flash attention: q/k/v as strided views of a (B, N, 3, H, 64) qkv tensor
    k2 = []
    for n, kv_valid in ((1370, None), (3601, None), (1201, None), (1370, 1000)):
        qkv = randn(1, n, 3, 16, 64)
        q, k, v = qkv[:, :, 0] * 2, qkv[:, :, 1], qkv[:, :, 2]  # sharper softmax than unit logits
        got = attention.flash_attention(q, k, v, kv_valid).float()
        want = attention.attention_plain(q.float(), k.float(), v.float(), kv_valid)
        err = (got - want).abs().max().item()
        ms = cuda_ms(lambda: attention.flash_attention(q, k, v, kv_valid))
        plain_ms = cuda_ms(lambda: attention.attention_plain(q, k, v, kv_valid))
        log(f"[K2] B=1 H=16 N={n} kv_valid={kv_valid or n}: max_abs_err {err:.3e} (tol {K2_MAX_ABS}), "
            f"out max {want.abs().max().item():.3f}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not err <= K2_MAX_ABS:
            raise AssertionError(f"K2 flash attention disagrees at N={n}: {err} > {K2_MAX_ABS}")
        k2.append((err, ms, plain_ms))
    results["flash_attention"] = k2

    # K3 conv: the decoder's shapes (ViT-L, 1369 tokens), ReLU/residual on and off
    k3 = []
    cases = [(74, 74, 256, 256, True, True), (74, 74, 256, 256, False, False),
             (148, 148, 128, 128, True, True), (296, 296, 64, 64, True, True),
             (296, 296, 64, 64, False, False), (296, 296, 64, 128, False, False),
             (296, 296, 64, 12, False, False), (296, 296, 64, 4, False, False),
             (37, 53, 64, 64, True, True), (37, 53, 24, 20, True, False)]
    for h, w, c, o, relu, use_res in cases:
        x = randn(1, h, w, c)
        kern = randn(3, 3, c, o, scale=(9 * c) ** -0.5)
        bias = torch.randn(o, generator=gen, device=dev) * 0.1
        res = randn(1, h, w, o) if use_res else None
        got = conv.conv3x3_replicate(x, kern, bias, res, relu).float()
        want = conv.conv3x3_plain(x.float(), kern.float(), bias, None if res is None else res.float(), relu)
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        ms = cuda_ms(lambda: conv.conv3x3_replicate(x, kern, bias, res, relu))
        plain_ms = cuda_ms(lambda: conv.conv3x3_plain(x, kern, bias, res, relu))
        log(f"[K3] {h}x{w} {c}->{o} relu={relu} residual={use_res}: max_abs_err {err:.3e} rel {rel:.3e} "
            f"(tol {K3_REL}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not rel <= K3_REL:
            raise AssertionError(f"K3 conv disagrees at {h}x{w} {c}->{o}: rel {rel} > {K3_REL}")
        k3.append((err, ms, plain_ms))
    results["conv3x3"] = k3
    torch.cuda.synchronize()
    return results


def expected_launches(config) -> dict:
    """Kernel launches per forward implied by a MoGe-2 config."""
    from moge_tpu_torch.models.dinov2 import VIT_ARCHS

    vit = VIT_ARCHS[config["encoder"]["backbone"]]
    layers = config["encoder"]["intermediate_layers"]
    n_take = layers if isinstance(layers, int) else len(layers)
    convs = 0
    for name in ("neck", "points_head", "normal_head", "mask_head"):
        stack = config.get(name)
        if stack is not None:
            convs += 2 * sum(stack["num_res_blocks"]) + len(stack["dim_res_blocks"]) - 1
    return {"layer_norm": 2 * vit.depth + n_take, "flash_attention": vit.depth, "conv3x3": convs}


def reset_counts():
    from moge_tpu_torch.ops import attention, conv, norm

    norm.LAUNCHES = attention.LAUNCHES = conv.LAUNCHES = 0


def read_counts() -> dict:
    from moge_tpu_torch.ops import attention, conv, norm

    return {"layer_norm": norm.LAUNCHES, "flash_attention": attention.LAUNCHES, "conv3x3": conv.LAUNCHES}


def phase_slice(card: str):
    """moge-2-vitl-normal at full width, random weights, bf16, four requests."""
    import math

    import numpy as np
    import torch

    from moge_tpu_torch.models.presets import get_preset
    from moge_tpu_torch.models.v2 import MoGeModel

    config = get_preset("moge-2-vitl-normal")["config"]
    expect = expected_launches(config)
    t0 = time.perf_counter()
    model = MoGeModel(config, device="cuda:0", dtype=torch.bfloat16).init_random(seed=SEED)
    torch.cuda.synchronize()
    log(f"[slice] moge-2-vitl-normal init_random(seed={SEED}) on cuda:0 in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(SEED)
    requests = [("518x518 num_tokens=1369", (518, 518), dict(num_tokens=1369)),
                ("518x518 resolution_level=9", (518, 518), dict()),
                ("480x960", (480, 960), dict()),
                ("960x480 fov_x=60", (960, 480), dict(fov_x=60.0))]
    counts_seen = []
    latencies = {}
    for label, (h, w), kwargs in requests:
        image = torch.from_numpy(rng.uniform(0, 1, (h, w, 3)).astype(np.float32)).to("cuda:0")
        reset_counts()
        out = model.infer(image, **kwargs)
        torch.cuda.synchronize()
        counts = read_counts()
        counts_seen.append(counts)
        if counts != expect:
            raise AssertionError(f"{label}: kernel launches {counts}, expected {expect} per forward")
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        want = {"points": (h, w, 3), "depth": (h, w), "intrinsics": (3, 3), "mask": (h, w), "normal": (h, w, 3)}
        if shapes != want:
            raise AssertionError(f"{label}: output shapes {shapes}, expected {want}")
        if out["mask"].dtype != torch.bool:
            raise AssertionError(f"{label}: mask dtype {out['mask'].dtype}")
        if not torch.isfinite(out["intrinsics"]).all():
            raise AssertionError(f"{label}: intrinsics not finite: {out['intrinsics']}")
        mask = out["mask"]
        if not torch.isfinite(out["depth"][mask]).all() or not torch.isfinite(out["points"][mask]).all():
            raise AssertionError(f"{label}: non-finite depth or points inside the mask")
        if "fov_x" in kwargs:
            fx = out["intrinsics"][0, 0].item()
            want_fx = 0.5 / math.tan(math.radians(kwargs["fov_x"]) / 2)
            if abs(fx - want_fx) > 1e-5 * want_fx:
                raise AssertionError(f"{label}: fx {fx} does not follow fov_x (want {want_fx})")
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.infer(image, **kwargs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        latencies[label] = statistics.median(times)
        log(f"[slice] {label}: mask {mask.float().mean().item():.3f} of pixels, "
            f"fx {out['intrinsics'][0, 0].item():.4f}, launches {counts}, "
            f"warm median {latencies[label]:.2f} ms ({card})")
    return counts_seen[0], latencies


def phase_parity():
    """moge-2-vits-normal decode: card bf16 (kernels) vs CPU fp32 (plain versions)."""
    import numpy as np
    import torch

    from moge_tpu_torch.models.presets import get_preset
    from moge_tpu_torch.models.v2 import MoGeModel
    from moge_tpu_torch.ops.resize import resize_2d

    config = get_preset("moge-2-vits-normal")["config"]
    gpu = MoGeModel(config, device="cuda:0", dtype=torch.bfloat16).init_random(seed=SEED)
    cpu = MoGeModel(config, device="cpu", dtype=torch.float32)
    cpu.module.load_state_dict({k: v.cpu() for k, v in gpu.module.state_dict().items()}, strict=True)
    image = torch.from_numpy(np.random.default_rng(SEED + 1).uniform(0, 1, (1, 518, 518, 3)).astype(np.float32))
    image_14 = resize_2d(image, (37 * 14, 37 * 14), mode="bilinear", antialias=True)
    with torch.inference_mode():
        got = gpu.module.decode(image_14.to("cuda:0"), 37, 37, 1.0, torch.bfloat16)
        want = cpu.module.decode(image_14, 37, 37, 1.0, torch.float32)
    for key in sorted(want):
        a, b = got[key].float().cpu(), want[key]
        rel = ((a - b).norm() / b.norm()).item()
        log(f"[parity] moge-2-vits-normal {key}: relative L2 {rel:.3e} (tol {MODEL_L2_RTOL})")
        if not rel <= MODEL_L2_RTOL:
            raise AssertionError(f"{key}: bf16-on-card vs fp32-on-CPU relative L2 {rel} > {MODEL_L2_RTOL}")


KERNELS = [
    ("layer_norm", "moge_tpu_torch/csrc/layernorm.cu", "moge_tpu/ops/norm.py:40"),
    ("flash_attention", "moge_tpu_torch/csrc/flash_attn.cu", "moge_tpu/ops/attention.py:57"),
    ("conv3x3", "moge_tpu_torch/csrc/conv3x3.cu", "moge_tpu/ops/conv.py:132"),
]
# which phase-3 case carries the reported time: the 1369-token main-path shape
REPORT_CASE = {"layer_norm": 0, "flash_attention": 0, "conv3x3": 3}


def main() -> int:
    import torch

    card = phase_device()
    if not (ROOT / "moge_tpu_torch").is_dir():
        raise RuntimeError(f"moge_tpu_torch/ not found beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT))
    phase_build()
    kernel_results = phase_kernels()
    launches, latencies = phase_slice(card)
    phase_parity()
    kernels = []
    for name, source, replaces in KERNELS:
        cases = kernel_results[name]
        _, ms, plain_ms = cases[REPORT_CASE[name]]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": max(c[0] for c in cases),
                        "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels, "infer_ms": latencies}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
