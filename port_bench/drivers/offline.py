"""Closed-loop ``MoGeModel.infer``: one caller labels a folder or a
dataset, batch after batch, and reads every batch's maps back to host
memory before it sends the next.

The cell gives the batch, the image size, the ``resolution_level`` and how
many distinct seeded images the caller cycles through (``pool``). The
window runs whole batches until ``seconds`` have passed; the last one
finishes past the mark and counts, and so does its time. A seeded
reservoir keeps ``sample`` images' answers for the check. In a traced run
the profiler takes the batches of the last ``profile_tail_s`` seconds, and
the rates come from the batches before them.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from port_bench import compare, program, trace, weights


def setup(ctx) -> SimpleNamespace:
    w, cfg = ctx.workload, ctx.config
    sd = weights.draw(cfg["version"], cfg["model_config"], cfg["weights"], ctx.seed, ctx.device)
    model = program.build(cfg, sd, ctx.device, ctx.int8)
    del sd
    pool = weights.images(ctx.seed, w["pool"], w["height"], w["width"], ctx.device)
    batches = [pool[i:i + w["batch"]] for i in range(0, w["pool"], w["batch"])]
    state = SimpleNamespace(ctx=ctx, model=model, batches=batches, kept={}, fp16=program.use_fp16(cfg))
    for _ in range(2):  # the cell's one shape, to its readback
        _infer(state, 0)
    state.setup_peak = torch.cuda.max_memory_allocated()
    state.profile = trace.Profile.warmed(ctx.device) if ctx.traced else None
    return state


def _infer(state, k: int) -> dict:
    out = state.model.infer(state.batches[k % len(state.batches)], resolution_level=state.ctx.workload["resolution_level"],
                            use_fp16=state.fp16)
    return {name: v.cpu() for name, v in out.items()}


def window(state, seconds: float, traced: bool) -> dict:
    w = state.ctx.workload
    keep = max(1, math.ceil(w["sample"] / w["batch"]))
    rng = np.random.default_rng(state.ctx.seed + 1)
    spans = profile = None
    if traced:
        spans = trace.Spans()
        module = state.model.module
        if state.ctx.config["version"] == "v2":
            spans.module(module.encoder, "pb.encoder")
            spans.function(module, "decode", "pb.decode")
            import moge_tpu_torch.models.v2 as owner
        else:
            spans.module(module.backbone, "pb.encoder")
            spans.module(module.head, "pb.head")
            import moge_tpu_torch.models.v1 as owner
        spans.function(owner, "recover_focal_shift", "pb.solve")
        profile = state.profile
    done = 0
    pre = None
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if profile is not None and not profile.active and now >= t_end - w["profile_tail_s"]:
            pre = (done, now - t0)
            profile.start()
        host = _infer(state, done // w["batch"])
        k = done // w["batch"]
        slot = k if k < keep else int(rng.integers(0, k + 1))
        if slot < keep:  # reservoir of the batches' answers
            state.kept[slot] = (k, host)
        done += w["batch"]
    t1 = time.perf_counter()
    records = {"attempted": done, "failed": 0, "images": done, "window_s": t1 - t0}
    if profile is not None:
        profile.stop()
        spans.remove()
        records["trace"] = profile.summary()
        records["trace"]["images"] = done - pre[0]
        records["trace"]["batches"] = (done - pre[0]) // w["batch"]
        records["images"], records["window_s"] = pre
    return records


def answers(state):
    """The kept batches' answers, image by image, beside their images."""
    w = state.ctx.workload
    level, cfg = w["resolution_level"], state.ctx.config["model_config"]
    lo, hi = cfg["num_tokens_range"]
    tokens = int(lo + (level / 9) * (hi - lo))
    samples = []
    for k, host in sorted(state.kept.values(), key=lambda kv: kv[0]):
        images = state.batches[k % len(state.batches)]
        for i in range(images.shape[0]):
            samples.append({"image": images[i], "answer": {name: v[i].numpy() for name, v in host.items()},
                            "num_tokens": tokens})
    state.model = None
    return samples[:w["sample"]], 0


def check(ctx, found) -> dict:
    """The sampled answers against the reference (``compare.check_images``)."""
    return compare.check_images(ctx, found)
