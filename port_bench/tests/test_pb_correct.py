"""``correct`` at a CPU test's size: sound runs pass the committed limits;
the lower-precision controls fail them (for the bf16 MoGe-2 cells the
program's own W8A8 int8 encoder in the timed path, for the fp32 MoGe-1
cell the reference with its products' operands in TF32); and a run whose
timed path is broken underneath, with the harness's look for a card
skipped, comes out not correct for each fault the cells can have: an
answer altered where it is produced, and answers handed to the wrong
request."""

import pytest
import torch

from port_bench import compare, program, weights
from port_bench.tests import tiny

CELLS = ["v2l-serve-518-poisson", "v2l-offline-b8-3600", "v1l-folder-fp32-480x640"]


def _tf32_checks(cell, seed):
    _, workload, config = tiny.cell(cell)
    sd = weights.draw(config["version"], config["model_config"], config["weights"], seed, "cpu")
    images = weights.images(seed, 3, workload["height"], workload["width"], "cpu")
    found = []
    for i in range(3):
        ref = compare.reference_outputs(config, sd, images[i], 36)
        low = compare.reference_outputs(config, sd, images[i], 36, rounding="tf32")
        found.append(compare.readings({k: v[0].numpy() for k, v in low.items()}, ref))
    return compare.judge(found, workload["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_a_sound_run_passes(cell, monkeypatch):
    tiny.no_card(monkeypatch)
    seed = 2 ** 31 + 11
    if cell.startswith("v2l"):
        control = tiny.run(cell, seed=seed, int8=True)
        assert not control["correct"], control["checks"]
    else:
        checks = _tf32_checks(cell, seed)
        assert any(c["value"] > c["limit"] for c in checks.values()), checks
    result = tiny.run(cell, seed=seed)
    assert result["correct"], result["checks"]


def test_a_cells_number_is_its_largest_over_the_sample():
    """One answer far off in a sample of three fails its number."""
    checks = compare.judge([{"focal_rel": 1e-6}, {"focal_rel": 1e-6}, {"focal_rel": 1.0}], {"focal_rel": 1e-3})
    assert checks["focal_rel"]["value"] == 1.0


def _faulty(monkeypatch, alter):
    """Every model the harness builds answers through ``alter``."""
    build = program.build

    def faulty_build(*args, **kwargs):
        model = build(*args, **kwargs)
        infer = model.infer

        def broken(*a, **k):
            return alter(infer(*a, **k))

        model.infer = broken
        return model

    monkeypatch.setattr(program, "build", faulty_build)


def _scale_depth(out):
    return {**out, "depth": out["depth"] * 1.1, "points": out["points"] * 1.1}


def _swap_answers(out):
    if out["depth"].shape[0] < 2:  # one image a call: hand it another call's answer
        _swap_answers.last, prev = out, getattr(_swap_answers, "last", None)
        return prev if prev is not None else out
    order = torch.arange(out["depth"].shape[0]).roll(1)
    return {k: v[order] for k, v in out.items()}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_scale_depth, _swap_answers], ids=["answer_altered", "answers_swapped"])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    tiny.no_card(monkeypatch)
    _faulty(monkeypatch, fault)
    if cell.startswith("v2l-serve"):  # the batcher groups 1-8 requests; let them queue into batches
        monkeypatch.setattr(tiny, "cell", _batched(tiny.cell))
    result = tiny.run(cell, seconds=1.5)
    assert not result["correct"], result["checks"]


def _batched(cell_fn):
    def cell(name):
        bench, workload, config = cell_fn(name)
        return bench, dict(workload, rate_per_s=40.0, sample=6), config
    return cell
