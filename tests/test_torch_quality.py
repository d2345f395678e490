"""The quality protocol of the port (cli/quality_holdout.py) against the JAX
one (scripts/quality_matrix.py) and the humanoid scenes against the JAX
fields, on the CPU at small sizes.

Tolerances: the analytic fields are the same f32 expressions on both sides,
held to 1e-5 (relative and absolute); a ground-truth render composites 384
of them a ray, held to 1e-4.  The protocol's loop is held to the JAX loop
by running both with the training step, the occupancy refresh and the
holdout render replaced by recorders: the step counts at which the grid is
installed and refreshed, and the cells each refresh draws, must be equal.
"""

import argparse
import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu.cli import train_hash as jcli
from human_body_reconstruction_tpu.data import synthetic as jsyn
from human_body_reconstruction_tpu.ops import dense_grid as jdense
from human_body_reconstruction_tpu.ops import occupancy as jocc
from human_body_reconstruction_tpu.train import step as jstep
from human_body_reconstruction_tpu.utils import config as jC
from human_body_reconstruction_tpu_torch.cli import quality_holdout as qh
from human_body_reconstruction_tpu_torch.cli import train_hash
from human_body_reconstruction_tpu_torch.data import synthetic
from human_body_reconstruction_tpu_torch.ops import hash_encoding, occupancy
from human_body_reconstruction_tpu_torch.pipeline import restore
from human_body_reconstruction_tpu_torch.train import step
import port_config
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROW_KEYS = {"mode", "steps", "rays_per_sec", "train_psnr",
                "holdout_psnr", "holdout_std", "holdout_min",
                "holdout_per_pose", "scene", "budget_s", "occ_frac"}


def load_quality_matrix():
    spec = importlib.util.spec_from_file_location(
        "quality_matrix", os.path.join(REPO, "scripts", "quality_matrix.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


QM = load_quality_matrix()


def seeded_points(n=4096, seed=0):
    return np.random.default_rng(seed).uniform(-1.2, 1.2, (n, 3)).astype(
        np.float32)


@pytest.mark.parametrize("name", ["humanoid_field", "textured_humanoid_field",
                                  "textured_field"])
def test_scene_fields_match_jax(name):
    pts = seeded_points()
    rgb, sigma = getattr(synthetic, name)(torch.tensor(pts))
    jrgb, jsigma = getattr(jsyn, name)(jnp.asarray(pts))
    assert float(sigma.max()) > 10.0 and float(rgb.std()) > 0.05
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=1e-5,
                               atol=1e-5)


def jax_protocol(scene, H, views, seed=0):
    """The JAX ``load_or_render_gt`` at a small size, its /tmp cache neither
    read nor written."""
    exists = os.path.exists
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os.path, "exists",
                   lambda p: False if "qm_gt_" in str(p) else exists(p))
        mp.setattr(np, "savez_compressed", lambda *a, **k: None)
        return QM.load_or_render_gt(H, H, views, scene=scene, seed=seed)


@pytest.mark.parametrize("scene", ["textured", "humanoid", "tangle101"])
def test_ground_truth_matches_jax(scene):
    """The protocol's K, pose split and 384-sample renders of every view;
    the tangle drawn from scene seed 101."""
    H, views = 10, 3
    seed = 101 if scene == "tangle101" else 0
    scene = scene.removesuffix("101")
    K, train, hold, train_imgs, hold_imgs = jax_protocol(scene, H, views,
                                                         seed)
    data = qh.protocol_data(H, H, views, scene, "cpu", scene_seed=seed)
    np.testing.assert_array_equal(data["K"].numpy(), np.asarray(K))
    np.testing.assert_array_equal(data["train_poses"].numpy(), train)
    np.testing.assert_array_equal(data["hold_poses"].numpy(), hold)
    for got, ref in ((data["train_imgs"], train_imgs),
                     (data["hold_imgs"], hold_imgs)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    assert float(data["hold_imgs"].std()) > 0.01


def test_holdout_pose_split_matches_jax():
    """20 training views orbit_poses(21)[:20], the interior holdout its last
    pose, then the three off-orbit eyes (the constants are held equal in
    tests/test_torch_boundary.py)."""
    train, hold = qh.protocol_poses(20)
    orbit = jsyn.orbit_poses(21, radius=4.0, elevation=0.35)
    np.testing.assert_array_equal(train, orbit[:20])
    np.testing.assert_array_equal(hold[0], orbit[20])
    np.testing.assert_array_equal(
        hold[1:], np.stack([jsyn.look_at_pose(e) for e in QM.HOLDOUT_EYES[1:]]))


@pytest.mark.parametrize("name", sorted(qh.make_modes()))
def test_mode_configs_match_make_modes(name):
    """The port's mode config equals the JAX ``make_modes`` entry once both
    take the protocol's batch, and its encoder is one the port runs: dense
    coarse levels then CP lines, or a hash grid of 32 features (the corner
    or cell grid alone, or packed with dense coarse levels)."""
    ref = QM.make_modes(jC, jdense)[name]
    port = qh.make_modes()[name]

    def batch(cfg):
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, ray_batch=16384))

    assert port_config.jax_view(batch(port)) == dataclasses.asdict(batch(ref))
    assert hash_encoding.unported(port.hash) is None
    h = port.hash
    if h.variant == "cp":
        assert h.dense_levels in (2, 3) and h.out_dim == (
            h.dense_levels * 2 + (h.num_levels - h.dense_levels) * h.cp_rank)
    else:
        assert h.variant in ("corner", "cell") and h.out_dim == 32
        assert h.dense_levels == 0 or h.packed


# the modes of the JAX make_modes that the port refused before it ported
# the hash variants: the cell variant and the packed bf16/int8 hash grids
REFUSED_MODES = {"cell", "packed", "packed_gsub", "packed_compact",
                 "packed_guided", "packed_dense", "int8_dense",
                 "int8_dense_guided", "int8_dense_guided_lvl",
                 "int8_dense_guided_k32", "int8_dense_guided_k24",
                 "int8_dense_guided_k16", "int8_dense_guided_k32_p128",
                 "int8_dense_guided_k32_mass",
                 "int8_dense_guided_k32_mass_lpair",
                 "int8_dense_guided_k32_mass_g256"}


def test_all_modes_are_jax_make_modes():
    """``all_modes`` is the JAX ``make_modes``, name for name in its order
    and config for config; all 60 run, none is refused, and the 16 variant
    modes train through the JAX branch of their variant (cell, packed bf16
    pairs, int8 words)."""
    ref = QM.make_modes(jC, jdense)
    port = qh.all_modes()
    assert list(port) == list(ref) and len(port) == 60
    for name in ref:
        assert port_config.jax_view(port[name]) == dataclasses.asdict(
            ref[name]), name
    assert qh.refused_modes() == {}
    assert list(qh.make_modes()) == list(ref)
    routes = {name: hash_encoding.hash_route(port[name].hash, True)
              for name in REFUSED_MODES}
    assert routes.pop("cell") == "hash_encode_cell"
    assert {r for n, r in routes.items() if n.startswith("packed")} == {
        "hash_encode_stochastic_packed"}
    assert {r for n, r in routes.items() if n.startswith("int8")} == {
        "hash_encode_stochastic_int8"}


def record_jax_loop(max_steps, monkeypatch):
    """(refreshes as (steps done, num_cells), steps, row) of the JAX
    ``_run_mode`` with its step, refresh and holdout render recorded."""
    events = []

    def train_step(state, *a, **k):
        events.append(None)
        return state, {"loss": 0.0, "psnr": 0.0}

    def update_from_field(occ, params, scene, key, cfg, num_cells):
        events.append(num_cells)
        return occ

    monkeypatch.setattr(jstep, "train_step", train_step)
    monkeypatch.setattr(jocc, "update_from_field", update_from_field)
    monkeypatch.setattr(jstep, "render_image",
                        lambda *a, **k: np.zeros((4, 4, 3), np.float32))
    name = qh.DEFAULT_MODE
    args = argparse.Namespace(batch=64, max_steps=max_steps, budget=1e9,
                              scene="textured", save_params=False)
    results = {}
    QM._run_mode(name, QM.make_modes(jC, jdense)[name], args, results, {},
                 None, None, None, np.zeros((4, 4, 4), np.float32),
                 np.zeros((4, 4, 4, 3), np.float32), 4, 4)
    return refreshes(events), results[name]


def refreshes(events):
    out, steps = [], 0
    for e in events:
        if e is None:
            steps += 1
        else:
            out.append((steps, e))
    return out, steps


@pytest.mark.parametrize("max_steps,cap", [(400, 0), (6000, 300)],
                         ids=["400_steps", "capped_300"])
def test_occupancy_schedule_matches_jax_loop(max_steps, cap, monkeypatch,
                                             tmp_path):
    """Install at 256 (one refresh, then one step), refresh after every
    step count divisible by 64, 2^20 cells each; ``--steps`` caps the run
    where JAX's ``--max_steps`` does.  The row traces every refresh."""
    want = {400: [(256, 2 ** 20), (320, 2 ** 20), (384, 2 ** 20)],
            300: [(256, 2 ** 20)]}[cap or max_steps]
    jref, jrow = record_jax_loop(cap or max_steps, monkeypatch)
    assert jref == (want, cap or max_steps)

    events = []

    def train_step(state, *a, **k):
        events.append(None)
        state.step += 1
        return {"loss": torch.tensor(0.0), "psnr": torch.tensor(0.0)}

    def update_from_field(grid, field, scene, cfg, *, num_cells, generator):
        events.append(num_cells)
        return grid

    monkeypatch.setattr(step, "train_step", train_step)
    monkeypatch.setattr(occupancy, "update_from_field", update_from_field)
    monkeypatch.setattr(step, "render_image",
                        lambda *a, **k: torch.zeros((4, 4, 3)))
    argv = ["--max_steps", str(max_steps), "--height", "4", "--batch", "64",
            "--budget", "1e9", "--device", "cpu",
            "--out", str(tmp_path / "q.json")]
    args = qh.build_parser().parse_args(argv + (["--steps", str(cap)]
                                                if cap else []))
    train, hold = qh.protocol_poses(2)
    data = {"K": torch.tensor([[4.4, 0, 2], [0, 4.4, 2], [0, 0, 1.0]]),
            "train_poses": torch.tensor(train), "hold_poses": torch.tensor(hold),
            "train_imgs": torch.zeros((2, 4, 4, 3)),
            "hold_imgs": torch.zeros((4, 4, 4, 3))}
    row = qh.run_mode(qh.DEFAULT_MODE, qh.make_modes()[qh.DEFAULT_MODE], args,
                      data, torch.device("cpu"), log=lambda s: None)
    assert refreshes(events) == (want, cap or max_steps)
    assert set(row) == JAX_ROW_KEYS | {"seed", "card", "occ_trace"}
    assert set(jrow) == JAX_ROW_KEYS
    assert row["occ_frac"] == jrow["occ_frac"] == 1.0
    assert row["occ_trace"] == [[n, 1.0] for n, _ in want]


def test_refresh_cells_scale_with_the_grid():
    for g, cells in ((64, 2 ** 20), (128, 2 ** 20), (256, 2 ** 21)):
        assert qh.refresh_cells(occupancy.init_grid(g)) == cells == max(
            2 ** 20, jocc.init_grid(g).density.size // 8)


def test_quality_holdout_cpu_run_writes_jax_keys(tmp_path):
    """A tiny protocol run (8 steps, no grid yet) writes {mode: row} with the
    JAX keys (occ_frac comes with the grid), seed and card, and finite
    values; ``--save_params`` a run directory that restores the mode's
    config."""
    import json

    out = tmp_path / "q.json"
    row = qh.main(["--height", "12", "--views", "2", "--batch", "64",
                   "--steps", "8", "--seed", "3", "--device", "cpu",
                   "--out", str(out), "--save_params"], log=lambda s: None)
    with open(out) as f:
        saved = json.load(f)
    assert saved == {qh.DEFAULT_MODE: row}
    assert set(row) == (JAX_ROW_KEYS - {"occ_frac"}) | {
        "seed", "card", "params_path"}
    assert (row["steps"], row["seed"], row["card"]) == (8, 3, "cpu")
    assert set(row["holdout_per_pose"]) == set(qh.HOLDOUT_NAMES)
    assert all(np.isfinite(v) for v in row["holdout_per_pose"].values())
    run_dir = str(tmp_path / "q")
    assert row["params_path"] == os.path.join(run_dir, f"{qh.DEFAULT_MODE}_"
                                              "ckpt.npz")
    res = restore.restore(run_dir, qh.DEFAULT_MODE, device="cpu",
                          log_fn=lambda s: None)
    assert res.cfg == dataclasses.replace(
        qh.make_modes()[qh.DEFAULT_MODE], train=dataclasses.replace(
            res.cfg.train, ray_batch=64))


@pytest.mark.parametrize("mode", ["cp_r21_sdf_guided_es16k",
                                  "cp_r21_hier_xla"])
def test_quality_holdout_sdf_and_hierarchical_modes_run(mode, tmp_path):
    """A tiny protocol run of an SDF and a hierarchical mode at their full
    width: the JAX keys, in SDF mode also the last eikonal term and the
    sharpness (moved from its initial 0.5 by the var group's AdamW)."""
    row = qh.main(["--mode", mode, "--height", "12", "--views", "2",
                   "--batch", "16", "--steps", "4", "--device", "cpu",
                   "--out", str(tmp_path / "q.json")], log=lambda s: None)
    sdf = "sdf" in mode
    assert set(row) == (JAX_ROW_KEYS - {"occ_frac"}) | {"seed", "card"} | (
        {"eikonal", "var_b"} if sdf else set())
    assert row["steps"] == 4
    assert all(np.isfinite(v) for v in row["holdout_per_pose"].values())
    if sdf:
        assert row["eikonal"] > 0 and row["var_b"] != 0.5


@pytest.mark.parametrize("mode,scene", [
    ("cp_r21_guided_k32_p32_tv1e2_strat", "tangle"),
    ("exact", "textured"), ("stochastic", "textured"),
    ("cp_l12_r32_guided_k48_mass", "textured"),
    ("cp_r21_sdf_plain", "textured")],
    ids=["tangle", "exact", "stochastic", "cp_l12", "sdf_full_eikonal"])
def test_quality_holdout_more_modes_run(mode, scene, tmp_path, monkeypatch):
    """A 4-step protocol run of the held-back scene (scene seed 101), the
    corner hash grid exact and single-corner, the 12-level ladder (3 dense,
    9 CP levels) and an SDF mode whose eikonal term covers every sample
    (``eikonal_subsample`` 0): the JAX keys, finite holdout PSNRs, and the
    eikonal term's points are all of the pass's samples."""
    from human_body_reconstruction_tpu_torch.models import nerf

    calls = []
    fd = nerf.sdf_finite_difference_normals
    monkeypatch.setattr(nerf, "sdf_finite_difference_normals",
                        lambda f, s, pts, *a, **k: (calls.append(
                            pts.shape[0]), fd(f, s, pts, *a, **k))[1])
    row = qh.main(["--mode", mode, "--scene", scene, "--scene_seed", "101",
                   "--height", "12", "--views", "2", "--batch", "16",
                   "--steps", "4", "--device", "cpu",
                   "--out", str(tmp_path / "q.json")], log=lambda s: None)
    cfg = qh.make_modes()[mode]
    assert set(row) == (JAX_ROW_KEYS - {"occ_frac"}) | {"seed", "card"} | (
        {"eikonal", "var_b"} if cfg.render.use_sdf else set()) | (
        {"scene_seed"} if scene == "tangle" else set())
    assert row["steps"] == 4 and row["scene"] == scene
    assert all(np.isfinite(v) for v in row["holdout_per_pose"].values())
    if scene == "tangle":
        assert row["scene_seed"] == 101
    if cfg.render.use_sdf:
        assert cfg.train.eikonal_subsample == 0
        # training steps: every sample of the 16-ray batch
        assert calls[:4] == [16 * cfg.render.num_samples] * 4


@pytest.mark.parametrize("argv,match", [
    (["--mode", "cell", "--scene", "tangle"], None),
    (["--mode", "int8_dense_guided"], None),
    (["--mode", "packed_dense"], None),
    (["--mode", "int8_dense_guided_k32_mass_lpair"], None),
    (["--mode", "no_such_mode"], "unknown mode"),
], ids=["tangle", "int8", "hash_exact", "int8_lpair", "unknown"])
def test_quality_holdout_refusals(argv, match, tmp_path):
    """Only an unknown mode is refused: the variant modes that the port
    refused before (cell on the tangle, int8, the packed bf16 grid with
    dense levels, int8 with level-pair routing) run a 2-step protocol to
    finite holdout PSNRs."""
    assert argv[1] == "no_such_mode" or argv[1] in QM.make_modes(jC, jdense)
    tiny = ["--height", "12", "--views", "2", "--batch", "16", "--steps",
            "2", "--device", "cpu", "--out", str(tmp_path / "q.json")]
    if match is not None:
        with pytest.raises(SystemExit, match=match):
            qh.main(argv + tiny)
        return
    row = qh.main(argv + tiny, log=lambda s: None)
    assert row["steps"] == 2 and np.isfinite(row["train_psnr"])
    assert all(np.isfinite(v) for v in row["holdout_per_pose"].values())


def test_synthetic_subjects_match_jax(monkeypatch):
    """``--synthetic_subject human`` and ``tangle`` build the JAX trainer's
    datasets (the same make_dataset arguments; the humanoid field, the
    tangle field seeded with ``--seed``)."""
    calls = {}

    def capture(tag):
        def make_dataset(**kw):
            calls[tag] = kw
            return {}
        return make_dataset

    monkeypatch.setattr(synthetic, "make_dataset", capture("port"))
    monkeypatch.setattr(jsyn, "make_dataset", capture("jax"))
    argv = ["--synthetic", "--synthetic_subject", "human"]
    train_hash.load_dataset(train_hash.build_parser().parse_args(argv), "cpu")
    jcli.load_dataset(jcli.build_parser().parse_args(argv))
    port, ref = calls["port"], calls["jax"]
    assert port.pop("device") == "cpu"
    assert port.pop("field") is synthetic.humanoid_field
    assert ref.pop("field") is jsyn.humanoid_field
    assert port == ref
    argv = ["--synthetic", "--synthetic_subject", "tangle", "--seed", "101"]
    train_hash.load_dataset(train_hash.build_parser().parse_args(argv), "cpu")
    jcli.load_dataset(jcli.build_parser().parse_args(argv))
    port, ref = calls["port"], calls["jax"]
    assert port.pop("device") == "cpu"
    pf, rf = port.pop("field"), ref.pop("field")
    assert (pf.func, pf.args, pf.keywords) == (synthetic.tangle_field, (),
                                               {"seed": 101})
    assert (rf.func, rf.args, rf.keywords) == (jsyn.tangle_field, (),
                                               {"seed": 101})
    assert port == ref


def occ_run_dir(tmp_path, H=16, views=2):
    """A saved run directory of a narrow CP model and a 32^3 grid, half its
    cells occupied: (run dir, mask, K, training poses)."""
    from human_body_reconstruction_tpu_torch.models.nerf import Field
    from human_body_reconstruction_tpu_torch.ops import rays
    from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
    from human_body_reconstruction_tpu_torch.utils import config as C

    cfg = qh.make_modes()[qh.DEFAULT_MODE]
    cfg = dataclasses.replace(cfg, hash=dataclasses.replace(
        cfg.hash, num_levels=3, n_max=64, cp_rank=4, dense_levels=1))
    field = Field(cfg, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    mask = (rng.uniform(size=(32,) * 3) < 0.5).astype(np.float32)
    density = np.where(mask > 0, 1.0, 1e-3).astype(np.float32)
    grid = occupancy.OccupancyGrid(torch.tensor(density), torch.tensor(mask),
                                   torch.tensor(0.01))
    K = torch.tensor([[1.1 * H, 0, H / 2], [0, 1.1 * H, H / 2], [0, 0, 1.0]])
    poses = torch.tensor(qh.protocol_poses(views)[0])
    lo, hi = rays.scene_bounds(H, H, K, poses, 2.0, 6.0)
    run = tmp_path / "run"
    run.mkdir()
    ckpt.save_params(str(run / f"{qh.DEFAULT_MODE}_ckpt.npz"), field,
                     extra=ckpt.occ_extras(grid))
    C.to_json(cfg, str(run / f"{qh.DEFAULT_MODE}_config.json"))
    ckpt.save_bounds(str(run / "bounds_model.npy"), lo.numpy(), hi.numpy())
    return run, mask, K, poses


def test_occ_report_splits_the_occupied_cells(tmp_path):
    """cli/occ_report.py on a saved run directory (a narrow CP model and a
    32^3 grid, half its cells occupied): the four parts add up to the
    occupied fraction, a refresh keeping the largest candidate occupies at
    least as many cells as one keeping the smallest, and a point on a
    training camera's axis is seen between near and far only."""
    from human_body_reconstruction_tpu_torch.cli import occ_report

    H, views = 16, 2
    run, mask, K, poses = occ_run_dir(tmp_path, H, views)
    out = occ_report.main(["--run_dir", str(run), "--height", str(H),
                           "--views", str(views), "--device", "cpu"])
    assert out["cells"] == 32 ** 3
    assert out["occ_frac"] == pytest.approx(float(mask.mean()), abs=1e-6)
    assert sum(out["of_grid"].values()) == pytest.approx(out["occ_frac"],
                                                         abs=1e-5)
    assert 0.0 < out["in_box"] < 1.0 and out["seen_in_box"] <= out["in_box"]
    assert out["refresh_largest"] >= out["refresh_smallest"]
    assert 0.0 < out["drawn_twice"] <= 1.0     # 2^20 draws on 32^3 cells

    c2w = poses[0]
    axis = -c2w[:3, 2]                  # the camera looks down its -z
    pts = c2w[:3, 3] + torch.stack([axis * t for t in (1.0, 3.0, 7.0, -3.0)])
    assert occ_report.seen(pts, K, poses[:1], H, H, 2.0, 6.0).tolist() == [
        False, True, False, False]


def test_occ_report_takes_the_tangle_and_its_seed(tmp_path, monkeypatch):
    """``--scene tangle --scene_seed N`` tests the cells against the tangle
    drawn from seed N: the subject's cells differ between seeds, and the
    report names the seed."""
    from human_body_reconstruction_tpu_torch.cli import occ_report

    run, _, _, _ = occ_run_dir(tmp_path)
    seen_fields, on_subject = [], occ_report.on_subject

    def record(pts, field_fn, *a, **k):
        seen_fields.append(field_fn)
        return on_subject(pts, field_fn, *a, **k)

    monkeypatch.setattr(occ_report, "on_subject", record)
    outs = [occ_report.main(["--run_dir", str(run), "--height", "16",
                             "--views", "2", "--scene", "tangle",
                             "--scene_seed", str(seed), "--device", "cpu"])
            for seed in (0, 101)]
    assert [o["scene_seed"] for o in outs] == [0, 101]
    assert [(f.func, f.keywords) for f in seen_fields] == [
        (synthetic.tangle_field, {"seed": 0}),
        (synthetic.tangle_field, {"seed": 101})]
    assert outs[0]["subject_cells"] != outs[1]["subject_cells"]
