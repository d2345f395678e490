"""The comparison that decides ``correct``, on the CPU at a size a test run
holds: the program (its plain versions on the CPU) against the plain
reference for a training step and a served frame, the control (the
reference in float8 where the configuration rounds to bfloat16) failing
the cell's limits, and a run driven with its timed path broken failing
them too.  On the card (marker ``cuda``), the control at the cell's own
size."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark import cells, correct
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345          # past 32 signed bits, as the driver's are
CELLS = ("flagship.train", "hashgrid.train", "flagship.serve")


def _run(name: str, extra: bool = False, seconds: float = 0.5):
    cell = tiny_cell(name)
    return cell, cells.driver(cell).run(cell, SEED, seconds, False, CPU,
                                        extra_readings=extra)


@pytest.fixture(scope="module")
def runs():
    return {name: _run(name, extra=True) for name in CELLS}


@pytest.mark.parametrize("name", CELLS)
def test_program_matches_reference(runs, name):
    cell, res = runs[name]
    ok, checks = correct.judge(res["readings"], cell.limits)
    assert ok, checks
    assert set(checks) == set(cell.limits)
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(runs, name):
    cell, res = runs[name]
    control = {k[len("control."):]: v for k, v in res["readings"].items()
               if k.startswith("control.")}
    assert control and not correct.judge(control, cell.limits)[0], control


def test_flagship_stage_is_checked(runs):
    _, res = runs["flagship.train"]
    assert {"stage_loss_gap", "stage_grad_gap", "refresh_gap"} <= set(
        res["readings"])


def _judged(name, monkeypatch, patch):
    patch(monkeypatch)
    cell, res = _run(name)
    return correct.judge(res["readings"], cell.limits)


def _state_unchanged(mp):
    from human_body_reconstruction_tpu_torch.train import state

    def step(self, count=None):
        if count is not None:
            self.set_count(count)
        self.count.add_(1)

    mp.setattr(state.GroupedOptimizer, "step", step)


def _half_batch(mp):
    from human_body_reconstruction_tpu_torch.train import step

    loss_fn = step.loss_fn

    def half(field, scene, batch, *a, **kw):
        return loss_fn(field, scene, tuple(x[:x.shape[0] // 2]
                                           for x in batch), *a, **kw)

    mp.setattr(step, "loss_fn", half)


def _answer_altered(mp):
    from human_body_reconstruction_tpu_torch.train import step

    render = step.render_poses_fused

    def altered(*a, **kw):
        img = render(*a, **kw).clone()
        img[..., img.shape[-3] // 2, img.shape[-2] // 2, :] += 0.25
        return img

    mp.setattr(step, "render_poses_fused", altered)


@pytest.mark.parametrize("name,patch", [
    ("flagship.train", _state_unchanged), ("hashgrid.train", _state_unchanged),
    ("flagship.train", _half_batch), ("hashgrid.train", _half_batch),
    ("flagship.serve", _answer_altered)])
def test_broken_timed_path_is_not_correct(monkeypatch, name, patch):
    ok, checks = _judged(name, monkeypatch, patch)
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's "
                    "own size on it")
    cell = cells.load(name)
    for seed in (11, 12, 13):
        res = cells.driver(cell).run(cell, seed, 15.0, False,
                                     torch.device("cuda", 0),
                                     extra_readings=True)
        control = {k[len("control."):]: v
                   for k, v in res["readings"].items()
                   if k.startswith("control.")}
        assert not correct.judge(control, cell.limits)[0], control
        assert correct.judge(res["readings"], cell.limits)[0]


def test_judge_refuses_missing_and_nan():
    ok, checks = correct.judge({"a": 0.1, "b": math.nan}, {"a": 1.0, "b": 1.0,
                                                          "c": 1.0})
    assert not ok and checks["a"] == {"value": 0.1, "limit": 1.0}
