"""The H100's published peaks, the least time a piece of work can take on
it, and the timing and labelling helpers the probe tools share.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at the full 700 W): 3.35 TB/s
of HBM, 989 TFLOP/s of bf16 and 1979 TOP/s of int8 on the tensor cores.
The rates outside the tensor cores scale with the SM clock: 132 SMs x 128
FP32 lanes execute one FP32 instruction per lane per clock (an FFMA counts
2 flops: 67 TFLOP/s at 1.98 GHz), and 16 MUFU lanes per SM evaluate one
``ex2`` per clock.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Dict, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
INT8_TENSOR_OPS = 1979e12
SMS = 132
FP32_LANES_PER_SM = 128
MUFU_PER_SM = 16
DEFAULT_SM_CLOCK_HZ = 1.98e9  # H100 SXM's maximum SM clock


def sm_clock_hz() -> float:
    """The card's maximum SM clock as ``nvidia-smi`` reads it (Hz)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.splitlines()[0]) * 1e6


def default_clock_hz(device: torch.device) -> float:
    """The clock the bounds are taken at: the card's, or the H100 SXM's maximum off the card."""
    return sm_clock_hz() if device.type == "cuda" else DEFAULT_SM_CLOCK_HZ


def card_label() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.splitlines()[0].strip()


def device_label(device: torch.device) -> str:
    """What every printed result names: the card and its power limit, or the CPU."""
    return card_label() if device.type == "cuda" else "cpu (plain versions; no device metric)"


def bound_ms(clock_hz: float, bytes_moved: float = 0.0, tensor_flops: float = 0.0, fp32_instr: float = 0.0,
             mufu: float = 0.0, int8_ops: float = 0.0) -> Tuple[float, str]:
    """The least time (ms) of a piece of work and what sets it: the bytes it
    must move over the HBM rate, or its operations over the peak rate of
    their type (the larger of the operation times)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(tensor_flops / BF16_TENSOR_FLOPS, int8_ops / INT8_TENSOR_OPS,
                fp32_instr / (SMS * FP32_LANES_PER_SM * clock_hz),
                mufu / (SMS * MUFU_PER_SM * clock_hz))
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def min_ms(fn: Callable[[], object], device: torch.device, calls: int = 1, reps: int = 5,
           warmup: int = 1) -> float:
    """Least over ``reps`` of the mean time (ms) of ``calls`` back-to-back
    calls of ``fn``: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / calls)
    return best


def device_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3, windows: int = 3) -> float:
    """Device time (ms) per call of ``fn`` on the card: the summed durations
    of the kernels it launches, from torch.profiler (CUPTI) traces of
    ``iters`` calls, median over ``windows`` traces. Unlike CUDA events
    around a call, this leaves out the host's time to reach the launch,
    which for a small kernel behind a Python wrapper can exceed the
    kernel's own. A trace that recorded no kernel is taken again (up to
    twice as many traces); if none did, it raises."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(2 * windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.device_time_total for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if total_us > 0:
            per_call.append(total_us / 1e3 / iters)
        if len(per_call) == windows:
            break
    if not per_call:
        raise RuntimeError(f"torch.profiler recorded no kernel in {2 * windows} traces of {iters} calls")
    return sorted(per_call)[len(per_call) // 2]


def host_us(fn: Callable[[], object], calls: int = 200, reps: int = 21) -> float:
    """The host's time (us) per call of ``fn`` on the card: the host clock
    around ``calls`` back-to-back calls launched after a synchronize and timed
    before the next one (fewer calls than the launch queue holds, so the
    host does not wait for the card where a call's device time is below its
    host time), median of ``reps``."""
    for _ in range(calls // 2):
        fn()
    per_call = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def interleaved_ms(runs: Dict[str, Callable[[], object]], device: torch.device, rounds: int, calls: int = 1,
                   reps: int = 1) -> Dict[str, float]:
    """``min_ms`` of each of ``runs``, the runs taken in turns for
    ``rounds`` rounds (so drift of the card falls on all of them), least
    over the rounds; each run is warmed up once, in the first round."""
    best = {key: float("inf") for key in runs}
    for r in range(rounds):
        for key, fn in runs.items():
            best[key] = min(best[key], min_ms(fn, device, calls, reps, warmup=1 if r == 0 else 0))
    return best
