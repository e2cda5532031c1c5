"""The reduction of a trace and the readers, on made-up events and records."""

import math
from types import SimpleNamespace

import numpy as np
import pytest

from port_bench import readers, trace


def test_union_of_device_intervals():
    assert trace._union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]


def test_idle_gaps_are_labelled_by_the_innermost_host_event():
    ev = lambda name, s, t: SimpleNamespace(name=name, time_range=SimpleNamespace(start=s, end=t))  # noqa: E731
    cpu = [ev("outer", 0, 100), ev("cudaStreamSynchronize", 5, 40), ev("pb.window", 0, 100)]
    gaps = trace._idle_gaps([[0, 10], [30, 90]], 0, 100, cpu)  # idle 10-30 and 90-100 (us)
    assert gaps == [["cudaStreamSynchronize", 20e-6], ["outer", 10e-6]]


def test_kernel_seconds_match_by_name_and_are_silent_without_a_match():
    summary = {"kernels_s": {"void conv3x3_wgmma<128>": 0.5, "flash_fwd_wgmma": 0.25}}
    assert trace.kernel_seconds(summary, ("conv3x3_wgmma", "conv3x3_f32")) == 0.5
    assert trace.kernel_seconds(summary, ("dense_objective",)) is None


def test_readers():
    run = SimpleNamespace(trace={"window_s": 2.0, "busy_s": 1.5, "images": 10, "launches": 3000, "batches": 0,
                                 "kernels_s": {}, "spans": {"pb.solve": {"count": 4, "host_s": 0.2, "device_s": 0.0}}},
                          window_peak=2 ** 31)
    assert readers.idle_share(run) == 25.0
    assert readers.launches_per_image(run) == 300.0
    assert readers.solve_ms(run) == 50.0
    assert readers.span(run, "pb.solve", "device_s") is None  # no device time: no reading, not 0
    assert readers.peak_gib(run) == 2.0
    assert readers.roofline_share(run, ("conv3x3_wgmma",), 1e-3) is None
    assert readers.percentile([0.1, 0.2, math.inf], 95) == math.inf
    assert readers.percentile(np.linspace(0, 1, 101), 95) == pytest.approx(0.95)
    assert readers.percentile([1.0, 2.0, 3.0], 50) == 2.0
