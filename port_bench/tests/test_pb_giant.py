"""The giant's cell, ``v2g-offline-b8-3600`` (MoGe-2 on DINOv2 ViT-g/14):
found by name with its two feed-forward metrics; ``correct`` at a CPU
test's size on the tiny arch with the fused SwiGLU (a sound run passes, the
int8 control and answers handed to the wrong image fail); the feed-forward's
count at the cell's shape; and its readers on made-up stores and on a run
without a trace."""

from types import SimpleNamespace

import pytest

from port_bench import harness
from port_bench.tests import tiny
from port_bench.tests.test_pb_correct import _faulty, _swap_answers

CELL = "v2g-offline-b8-3600"
FFN = ("ffn_ms_per_image.images", "ffn_roofline.images")


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py", "pb_metric")


def test_the_cell_is_found_and_reports_the_feed_forwards_metrics():
    bench, workload, config = harness.load_cell(harness.ROOT, CELL)
    assert config["name"] == workload["config"] == "moge-2-vitg14-normal"
    assert config["model_config"]["encoder"]["backbone"] == "dinov2_vitg14" and config["reduced"] == []
    assert [m["name"] for m in harness.cell_metrics(bench, CELL, False)] == ["images_per_s", "setup_s"]
    traced = {m["name"]: m for m in harness.cell_metrics(bench, CELL, True)}
    for name in FFN:
        assert traced[name]["layer"] == "encoder" and traced[name]["moves"] == "images_per_s"
    assert {"mfu.images", "k2_roofline.images", "encoder_ms_per_image.images"} <= set(traced)


def test_a_sound_run_passes_and_the_int8_control_fails(monkeypatch):
    tiny.no_card(monkeypatch)
    tiny.swiglu(monkeypatch)
    seed = 2 ** 31 + 13
    control = tiny.run(CELL, seed=seed, int8=True)
    assert not control["correct"], control["checks"]
    result = tiny.run(CELL, seed=seed)
    assert result["correct"], result["checks"]


def test_answers_handed_to_the_wrong_image_are_not_correct(monkeypatch):
    tiny.no_card(monkeypatch)
    tiny.swiglu(monkeypatch)
    _faulty(monkeypatch, _swap_answers)
    result = tiny.run(CELL, seconds=1.5)
    assert not result["correct"], result["checks"]


def _cell_run(store=None, traced=True, images=16):
    _, workload, config = harness.load_cell(harness.ROOT, CELL)
    run = SimpleNamespace(workload=workload, config=config, trace={"images": images} if traced else None)
    if store is not None:
        run.program_spans = store  # as ``program_spans.summary`` leaves it
    return run


def test_the_feed_forwards_count_at_the_cells_shape():
    """One call at batch 8 over 52 x 69 = 3588 patches and the cls token:
    2 x 8 x 3589 x 3 x 1536 x 4096 operations, bound by them at 989 TFLOP/s."""
    reader = _reader("ffn_roofline.images")
    flops, nbytes = reader.ffn_fwd("dinov2_vitg14", 8, 3588, "bfloat16")
    assert flops == 1_083_841_708_032
    assert nbytes == 2 * (3 * 1536 * 4096 + 2 * 4096 + 1536 + 2 * 8 * 3589 * 1536)
    assert reader.least_s_per_call(_cell_run()) == pytest.approx(1_083_841_708_032 / 989e12)


def test_the_feed_forwards_readers_on_a_store():
    least = _reader("ffn_roofline.images").least_s_per_call(_cell_run())
    store = {"moge.encoder.ffn": {"count": 80, "host_s": 0.01, "device_s": 80 * least / 0.6, "parent": "moge.encoder"}}
    assert _reader("ffn_roofline.images").read(_cell_run(store)) == pytest.approx(60.0)
    assert _reader("ffn_ms_per_image.images").read(_cell_run(store)) == pytest.approx(80 * least / 0.6 / 16 * 1e3)
    for name in FFN:
        assert _reader(name).read(_cell_run({})) is None  # a program without the span
        assert _reader(name).read(_cell_run(None)) is None  # a program without spans
        zero = {k: dict(v, device_s=0.0) for k, v in store.items()}
        assert _reader(name).read(_cell_run(zero)) is None  # no events (a CPU run): no reading, not 0


@pytest.mark.parametrize("name", FFN)
def test_the_feed_forwards_readers_read_none_without_a_trace(name):
    assert _reader(name).read(_cell_run(traced=False)) is None
