"""The benchmark's neuralangelo traffic driver (benchmark/traffic/
train_sdf.py) on the CPU at a tiny size: the program against the plain
reference passes the cell's limits, the control and the planted faults
fail one; the SDF metrics read a segment.  Test names avoid the words that
tests/conftest.py marks slow."""

import copy

import pytest
import torch

from benchmark import cells, correct
from benchmark.tests.tiny import SCENE

from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SEED = 2 ** 31 + 777          # past 32 signed bits, as the driver's are


def tiny_sdf_cell():
    cell = copy.deepcopy(cells.load("neuralangelo.train"))
    p = cell.config["pipeline"]
    p["hash"].update(num_levels=4, log2_table_size=10, n_max=128)
    p["mlp"].update(sdf_width=32, rgb_width=32)
    p["render"].update(num_samples=8, neus_fine_samples=4, neus_rounds=2)
    p["train"].update(ray_batch=16)
    cell.traffic.update(scene=dict(SCENE), steps_per_call=2, log_every=2,
                        trace_from_step=2, trace_chunks=1)
    return cell


def test_sdf_driver_holds_program_to_reference():
    """A tiny neuralangelo run: the sound readings within the cell's
    limits, the bf16 control and each planted fault past one of them, the
    schedule read at its late stage, the point counters' step."""
    cell = tiny_sdf_cell()
    res = cells.driver(cell).run(cell, SEED, 0.5, False, CPU,
                                 extra_readings=True)
    r = res["readings"]
    ok, checks = correct.judge(r, cell.limits)
    assert ok, checks
    for tag in ("control.", "drop_tap.", "eps.", "no_laplacian."):
        got = {k[len(tag):]: v for k, v in r.items() if k.startswith(tag)}
        assert not correct.judge(got, cell.limits)[0], (tag, got)
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert res["metrics"]["train_rays_per_s"][0] > 0


def test_sdf_metrics_read_a_segment():
    """The SDF metrics read the run's point counts and the segment's
    kernels; other runs read nothing."""
    import types

    from benchmark import counts_sdf

    mods = cells.metric_modules()
    cell = tiny_sdf_cell()
    p = cell.config["pipeline"]
    points = {"centre": 256, "taps": 1536, "upsample": 192}
    run = types.SimpleNamespace(kind="train_sdf", p=p, steps=10,
                                points=points)
    seg = {"window_s": 1.0, "kernels": {
        "void hash_forward_kernel<8>": [10, 0.001],
        "void hash_backward_kernel<8>": [10, 0.002],
        "sm90_xmma_gemm_f32f32": [30, 0.003],
        "void at::native::multi_tensor_apply_kernel<x>": [40, 0.004]}}
    assert mods["gemm_ms.sdf.train"].read(run, seg) == pytest.approx(0.3)
    assert mods["adam_ms.sdf.train"].read(run, seg) == pytest.approx(0.4)
    flops = 10 * counts_sdf.mlp_flops(p, points)
    assert mods["mfu.sdf.train"].read(run, seg) == pytest.approx(
        100 * flops / 67e12)
    roof = mods["hash_roofline.sdf.train"].read(run, seg)
    assert roof == pytest.approx(
        100 * 10 * counts_sdf.hash_bound_s(p, points) / 0.003)
    other = types.SimpleNamespace(kind="train", p=p, steps=10, points=100)
    for name in ("mfu.sdf.train", "hash_roofline.sdf.train",
                 "gemm_ms.sdf.train", "adam_ms.sdf.train"):
        assert mods[name].read(other, seg) is None
    no_points = types.SimpleNamespace(kind="train_sdf", p=p, steps=10,
                                      points=None)
    for name in ("mfu.sdf.train", "hash_roofline.sdf.train"):
        assert mods[name].read(no_points, seg) is None


def test_sdf_idle_share_reads_the_segment():
    """idle_share.sdf.train reads the neuralangelo segment's idle share and
    nothing of another run's."""
    import types

    mod = cells.metric_modules()["idle_share.sdf.train"]
    seg = {"window_s": 2.0, "busy_s": 1.5}
    run = types.SimpleNamespace(kind="train_sdf", steps=10, points=None)
    assert mod.read(run, seg) == pytest.approx(25.0)
    other = types.SimpleNamespace(kind="train", steps=10, points=None)
    assert mod.read(other, seg) is None
