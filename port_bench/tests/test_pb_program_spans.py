"""The readers of the program's own spans and counters, on made-up stores
and on a tiny traced run on the CPU; and the trace's reduction, whose keys
the program's spans leave as they were."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from port_bench import harness, program_spans, trace
from port_bench.tests import tiny

STORE = {
    "moge.serve.dispatch": {"count": 2, "host_s": 0.05, "device_s": 0.16, "parent": None},
    "moge.upload": {"count": 2, "host_s": 0.006, "device_s": 0.0, "parent": "moge.infer"},
    "moge.post": {"count": 2, "host_s": 0.1, "device_s": 0.04, "parent": "moge.infer"},
    "moge.solve": {"count": 2, "host_s": 0.08, "device_s": 0.03, "parent": "moge.post"},
}
VALUES = {"dispatch_ms.serve": 25.0, "batch_device_ms.serve": 80.0, "upload_ms.serve": 3.0,
          "post_ms_per_image.images": 0.625}


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py", "pb_metric")


def _run(store, images=16, traced=True):
    run = SimpleNamespace(trace={"images": images} if traced else None)
    run.program_spans = store  # as ``program_spans.summary`` leaves it
    return run


@pytest.mark.parametrize("name", sorted(VALUES))
def test_readers_of_the_program_spans(name):
    assert _reader(name).read(_run(dict(STORE))) == pytest.approx(VALUES[name])
    assert _reader(name).read(_run(None)) is None  # a program without spans
    assert _reader(name).read(_run({})) is None
    zero = {k: dict(v, host_s=0.0, device_s=0.0) for k, v in STORE.items()}
    assert _reader(name).read(_run(zero)) is None  # no time: no reading, not 0


def test_an_untraced_run_or_a_program_without_span_summary_reads_none(monkeypatch):
    assert program_spans.summary(SimpleNamespace(trace=None)) is None
    import moge_tpu_torch.utils.tools as tools

    monkeypatch.delattr(tools, "span_summary")
    assert program_spans.summary(SimpleNamespace(trace={"images": 1})) is None


def _event(name, start, end, device=DeviceType.CPU, device_us=0.0):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end), device_type=device,
                           device_time_total=device_us)


def test_the_trace_summary_keeps_its_keys_with_the_program_spans_present():
    events = [_event("pb.window", 0, 1000), _event("pb.solve", 100, 300, device_us=50.0),
              _event("cudaLaunchKernel", 110, 120), _event("cudaStreamSynchronize", 400, 600),
              _event("conv3x3_wgmma", 120, 250, DeviceType.CUDA), _event("flash_fwd_wgmma", 650, 900, DeviceType.CUDA)]
    program = [_event("moge.infer", 50, 950), _event("moge.post", 90, 700), _event("moge.serve.collect", 960, 990)]

    def summary(evs):
        prof = trace.Profile()
        prof.prof = SimpleNamespace(events=lambda: evs)
        return prof.summary()

    without, with_spans = summary(events), summary(events + program)
    gaps = lambda s: sum(v for _, v in s["breakdown"]["idle_gaps"])  # noqa: E731
    assert gaps(with_spans) == gaps(without)  # the same gaps, labelled by the innermost host event
    assert with_spans["breakdown"]["device_ops"] == without["breakdown"]["device_ops"]
    without.pop("breakdown"), with_spans.pop("breakdown")
    assert repr(with_spans) == repr(without)


@pytest.mark.parametrize("cell", ["v2l-serve-518-poisson", "v2l-offline-b8-3600", "v1l-folder-fp32-480x640"])
def test_a_tiny_traced_run_reports_the_host_readings(cell, monkeypatch):
    tiny.no_card(monkeypatch)
    bench, workload, config = tiny.cell(cell)
    workload["profile_tail_s"] = 2.0  # room for a batch that a busy CPU makes slow
    result = harness.execute(bench, cell, workload, config, 2 ** 31 + 11, 4.0, True, torch.device("cpu"), 0.0)
    metrics = result["metrics"]
    if workload["kind"] == "serve":
        for name in ("dispatch_ms.serve", "upload_ms.serve"):
            assert metrics[name]["value"] > 0 and metrics[name]["unit"] == "ms"
    assert "batch_device_ms.serve" not in metrics and "post_ms_per_image.images" not in metrics  # no card
