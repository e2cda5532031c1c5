"""Open-loop serving: requests arrive at a fixed mean rate, as independent
users of the HTTP server send them, into the program's micro-batcher
(``scripts/serve.py::InferenceBatcher``) driven in process.

Arrivals: the cell's ``rate_per_s`` x ``seconds`` requests at one fixed
sequence of Poisson arrival times (exponential gaps drawn once, scaled to
span the window), the same for every seed, so that every seed offers the
same load; the seed draws the weights and the cell's ``pool`` of
distinct images at the served size, which the requests carry in turn (a
pool for every request held 9 GB of host memory at 56 req/s over 51 s;
the batcher keeps no cache, so a repeated image costs what a new one
does). The generator submits
each request at its due time to a pool of client threads that call
``InferenceBatcher.infer``; a request's latency runs from when it was due
to when its host arrays are back, and its lateness from when it was due to
when it was submitted. A failed or unanswered request has no latency.
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from types import SimpleNamespace

import numpy as np
import torch

from port_bench import compare, program, trace, weights

MAPS = ("depth", "normal", "mask", "intrinsics")
CLIENTS = 64
TAIL_WAIT_S = 60.0


def arrivals(rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of round(rate x seconds) requests."""
    n = max(1, round(rate * seconds))
    gaps = np.random.default_rng(0).exponential(1.0, n)
    gaps = gaps / gaps.sum() * seconds
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def setup(ctx) -> SimpleNamespace:
    from moge_tpu_torch.scripts.serve import InferenceBatcher

    w, cfg = ctx.workload, ctx.config
    sd = weights.draw(cfg["version"], cfg["model_config"], cfg["weights"], ctx.seed, ctx.device)
    model = program.build(cfg, sd, ctx.device, ctx.int8)
    del sd
    # the profiler's first start (seconds) before the dispatcher thread
    # exists: a thread that lived through an earlier profile had its kernels
    # left out of the next one
    profile = trace.Profile.warmed(ctx.device) if ctx.traced else None
    batcher = InferenceBatcher(model, w["height"], w["width"], w["num_tokens"], w["max_batch"], w["max_wait_ms"],
                               program.use_fp16(cfg))
    batcher.warmup()
    due = arrivals(w["rate_per_s"], ctx.seconds)
    images = weights.images(ctx.seed, min(w["pool"], len(due)), w["height"], w["width"], ctx.device).numpy()
    keep = set(np.random.default_rng(ctx.seed + 1).choice(len(due), min(w["sample"], len(due)), replace=False).tolist())
    return SimpleNamespace(ctx=ctx, model=model, batcher=batcher, due=due, images=images, keep=keep, answers={},
                           profile=profile, setup_peak=torch.cuda.max_memory_allocated())


def offer(state, due: np.ndarray, seconds: float, profile=None) -> dict:
    """Send the requests at their due times (s from now) and wait for them,
    at most ``TAIL_WAIT_S`` past the window's close; with a ``profile``,
    trace the window's last ``profile_tail_s`` seconds."""
    batcher = state.batcher
    n = len(due)
    latency = np.full(n, np.inf)
    late = np.zeros(n)

    def client(i: int, t_due: float) -> None:
        answer = batcher.infer(state.images[i % len(state.images)], None, maps=MAPS)
        latency[i] = time.perf_counter() - t_due
        if i in state.keep:
            state.answers[i] = answer

    pool = cf.ThreadPoolExecutor(max_workers=CLIENTS)
    stats0 = dict(batcher.stats)
    t0 = time.perf_counter() + 0.01
    tail_start = t0 + seconds - (state.ctx.workload["profile_tail_s"] if profile else 0.0)
    futures, prof0 = [], None

    def start_profile():
        nonlocal prof0
        prof0 = batcher.stats["batched_images"]
        profile.start()

    for i, offset in enumerate(due):
        t_due = t0 + offset
        if profile is not None and prof0 is None and t_due >= tail_start:
            start_profile()
        pause = t_due - time.perf_counter()
        if pause > 0:
            time.sleep(pause)
        late[i] = time.perf_counter() - t_due
        futures.append(pool.submit(client, i, t_due))
    records = {}
    if profile is not None:
        pause = t0 + seconds - time.perf_counter()
        if pause > 0:
            time.sleep(pause)
        if prof0 is None:
            start_profile()
        profile.stop()
        records["trace_images"] = batcher.stats["batched_images"] - prof0
    done, _ = cf.wait(futures, timeout=max(0.0, t0 + seconds + TAIL_WAIT_S - time.perf_counter()))
    failed = sum(1 for f in futures if f not in done or f.exception() is not None)
    t_end = time.perf_counter()
    pool.shutdown(wait=False, cancel_futures=True)
    stats1 = dict(batcher.stats)
    records.update({"attempted": n, "failed": failed, "latency_s": latency, "due_s": np.asarray(due),
                    "window_s": t_end - t0, "late_p95_ms": float(np.percentile(late, 95) * 1e3),
                    "late_max_ms": float(late.max() * 1e3), "batches": stats1["batches"] - stats0["batches"],
                    "batched_images": stats1["batched_images"] - stats0["batched_images"]})
    return records


def window(state, seconds: float, traced: bool) -> dict:
    spans = profile = None
    if traced:
        spans = trace.Spans()
        spans.module(state.model.module.encoder, "pb.encoder")
        spans.function(state.model.module, "decode", "pb.decode")
        import moge_tpu_torch.models.v2 as v2

        spans.function(v2, "recover_focal_shift", "pb.solve")
        profile = state.profile
    records = offer(state, state.due, seconds, profile)
    state.failed = records["failed"]
    state.batcher.stop()
    if spans is not None:
        spans.remove()
        records["trace"] = profile.summary()
        records["trace"]["images"] = records.pop("trace_images")
    return records


def answers(state):
    """The sampled requests' answers beside their images, and how many never came."""
    w = state.ctx.workload
    samples = [{"image": torch.from_numpy(state.images[i % len(state.images)]), "answer": state.answers[i],
                "num_tokens": w["num_tokens"]}
               for i in sorted(state.keep) if i in state.answers]
    missing = len(state.keep) - len(samples) + state.failed
    state.model = state.batcher = None
    return samples, missing


def check(ctx, found) -> dict:
    """The sampled answers against the reference (``compare.check_images``)."""
    return compare.check_images(ctx, found)
