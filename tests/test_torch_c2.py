"""tools/c2_spread.py: the seed-spread measurement of the JAX trainer and the
port, on the CPU.

The JAX side drives the JAX scripts' own loops (``quality_matrix._run_mode``
and ``speedrun_30db.main``); its seed enters only through the keys those
loops make.  Held here: at seed 0 the loops get their own keys (the init key
``PRNGKey(0)``, the step key ``PRNGKey(1)`` and the fold of the step count
into it at steps 0-3, the refresh key ``PRNGKey(steps)``), at seed 1 each is
``fold_in`` of it with 1; the holdout render keeps its own key.  These run
the loops with the step, refresh and render replaced by recorders.  Then
both sides of one mode run two real steps at a tiny size and write rows of
the same keys.  Last, the repair the spreads led to: an occupancy refresh
that draws a cell more than once keeps the candidate of its last draw, as
the JAX ``update`` does on the CPU, where the port kept the largest (held
bit for bit with JAX given its draws).  Test names avoid the words that
tests/conftest.py marks slow.
"""

import argparse
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu.ops import occupancy as jocc
from human_body_reconstruction_tpu.train import step as jstep
from human_body_reconstruction_tpu_torch.cli import quality_holdout as qh
from human_body_reconstruction_tpu_torch.ops import occupancy
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tool():
    spec = importlib.util.spec_from_file_location(
        "c2_spread", os.path.join(REPO, "tools", "c2_spread.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


C2 = load_tool()


def words(key):
    return [int(w) for w in np.asarray(key).reshape(-1)]


def fake_gt(H=4, views=2):
    import jax.numpy as jnp

    K = jnp.asarray([[1.1 * H, 0, H / 2], [0, 1.1 * H, H / 2], [0, 0, 1]],
                    jnp.float32)
    train, hold = qh.protocol_poses(views)
    return (K, train, hold, np.zeros((views, H, H, 3), np.float32),
            np.zeros((4, H, H, 3), np.float32))


def stub_loop(monkeypatch, render_keys):
    """The JAX step, refresh and render replaced by cheap stand-ins (the
    recorder wraps them as it wraps the real ones); the render records the
    key it is handed or makes."""

    def train_step(state, *a, **k):
        return state, {"loss": 0.0, "psnr": 0.0}

    def update_from_field(occ, params, scene, key, cfg, num_cells):
        return occ

    def render_image(*a, key=None, **k):
        render_keys.append(words(jax.random.PRNGKey(0) if key is None
                                 else key))
        return np.ones((4, 4, 3), np.float32)

    monkeypatch.setattr(jstep, "train_step", train_step)
    monkeypatch.setattr(jocc, "update_from_field", update_from_field)
    monkeypatch.setattr(jstep, "render_image", render_image)


def args_for(tmp_path, max_steps, **kw):
    base = dict(height=4, views=2, batch=64, max_steps=max_steps,
                draws_seed=None,
                eval_every=max_steps, scene="textured", scene_seed=0,
                out=str(tmp_path / "jax.json"))
    return argparse.Namespace(**{**base, **kw})


def expected_draws(seed, refresh_steps):
    key = (lambda k: jax.random.PRNGKey(k) if seed == 0 else
           jax.random.fold_in(jax.random.PRNGKey(k), seed))
    return {"seed": seed, "init": words(key(0)), "step": words(key(1)),
            "step_0_3": [words(jax.random.fold_in(key(1), i))
                         for i in range(4)],
            "refresh": [[n, words(key(n))] for n in refresh_steps]}


@pytest.mark.parametrize("seed", [0, 1])
def test_c2_quality_loop_keys(seed, monkeypatch, tmp_path):
    """``_run_mode`` of a guided mode over 322 steps: init, step and the
    refresh keys at the install (256) and at 320; the holdout renders keep
    ``PRNGKey(0)``."""
    renders = []
    stub_loop(monkeypatch, renders)
    qm = C2._load_script("quality_matrix")
    row = C2.jax_mode_row(qm, qh.DEFAULT_MODE, seed,
                          args_for(tmp_path, 322), fake_gt())
    assert row["steps"] == 322 and len(row["loss"]) == 322
    assert row["draws"] == expected_draws(seed, [256, 320])
    assert [n for n, _ in row["occ_trace"]] == [256, 320]
    assert renders == [words(jax.random.PRNGKey(0))] * 4
    if seed:
        zero = expected_draws(0, [256, 320])
        for k in ("init", "step", "step_0_3", "refresh"):
            assert row["draws"][k] != zero[k], k


@pytest.mark.parametrize("seed", [0, 1])
def test_c2_time_to_db_loop_keys(seed, monkeypatch, tmp_path):
    """``speedrun_30db.main`` with ``--encoder int8`` over 320 steps: the
    same keys (the install at 256, a refresh at 320), an evaluation every 64
    steps, each with the render's own key, and no crossing at 0 dB."""
    renders = []
    stub_loop(monkeypatch, renders)
    row = C2.jax_speedrun_row(args_for(tmp_path, 320, eval_every=64), seed,
                              fake_gt())
    assert row["draws"] == expected_draws(seed, [256, 320])
    assert [n for n, _ in row["evals"]] == [64, 128, 192, 256, 320]
    assert row["holdout_psnr"] == row["evals"][-1][1]
    assert renders == [words(jax.random.PRNGKey(0))] * 5
    assert row["crossing"] == {str(t): None for t in C2.TARGETS_DB}


def test_c2_both_sides_write_the_same_row_keys(tmp_path, monkeypatch):
    """Both sides of ``cp_r16`` (the cheapest CP mode: unculled, no grid)
    run two steps at 16x16 with 64-ray batches and write rows of the same
    keys and cut; the port side runs on the CPU.  The JAX holdout renders
    its 256 rays as one chunk (its protocol pads them to 32768)."""
    render = jstep.render_image
    monkeypatch.setattr(jstep, "render_image", lambda *a, **k: render(
        *a, **{**k, "chunk": 256}))
    common = ["--modes", "cp_r16", "--seeds", "0", "--height", "16",
              "--views", "2", "--batch", "64", "--max_steps", "2"]
    jrow, = C2.main(["--side", "jax", *common,
                     "--out", str(tmp_path / "jax.json")], log=lambda s: None)
    prow, = C2.main(["--side", "port", "--device", "cpu", *common,
                     "--out", str(tmp_path / "port.json")],
                    log=lambda s: None)
    assert set(jrow) == set(prow)
    for k in ("mode", "seed", "height", "views", "batch", "max_steps",
              "steps"):
        assert jrow[k] == prow[k], k
    assert (jrow["side"], prow["side"]) == ("jax", "port")
    assert jrow["steps"] == 2 and len(jrow["loss"]) == len(prow["loss"]) == 2
    for r in (jrow, prow):
        assert np.isfinite(r["holdout_psnr"]) and r["occ_trace"] == []
        assert set(r["holdout_per_pose"]) == set(qh.HOLDOUT_NAMES)
    rep = C2.main(["--report", str(tmp_path / "jax.json"),
                   str(tmp_path / "port.json")], log=lambda s: None)
    v = rep["cp_r16@textured/2"]["holdout"]
    assert (v["n_port"], v["n_jax"]) == (1, 1)
    assert v["delta"] == pytest.approx(prow["holdout_psnr"]
                                       - jrow["holdout_psnr"])


def test_c2_decision_rule():
    """Δ and its bar: two sides differ only past both 2·SE and the floor."""
    v = C2.verdict([30.0, 30.2, 30.4, 30.2], [29.0, 29.2, 29.1, 29.1], 0.3)
    assert v["delta"] == pytest.approx(1.1) and v["differ"]
    v = C2.verdict([30.0, 32.0, 28.0], [29.0, 31.0, 30.0], 0.3)
    assert not v["differ"] and v["bar"] > abs(v["delta"])
    v = C2.verdict([30.00, 30.01, 30.02], [29.80, 29.81, 29.82], 0.3)
    assert abs(v["delta"]) > v["bar"] and not v["differ"]


@pytest.mark.parametrize("g,cells,decay", [(16, 8192, 0.95), (32, 2 ** 15, 0.8)],
                         ids=["16cubed_8192", "32cubed_32768"])
def test_c2_refresh_matches_jax_on_cells_drawn_twice(g, cells, decay):
    """One refresh of a grid whose cells are finite, infinite (never
    visited) or above the threshold, with so many draws that most drawn
    cells are drawn more than once: JAX ``update`` from a key against the
    port's ``update`` given the same cells and jitter (made as JAX makes
    them: split, randint, uniform) and the same f32 density function.
    Density and mask bit for bit, so the occupied fractions are equal."""
    rng = np.random.default_rng(g)
    dens = rng.uniform(0.0, 0.03, (g, g, g)).astype(np.float32)
    dens[rng.random((g, g, g)) < 0.3] = np.inf
    mu = np.float32([-1.0, -0.5, -0.8])
    sigma = np.float32(2.5)

    def field(p):              # positive in part of the box, f32 both sides
        return (p[:, 0] * 0.05 + p[:, 1] * p[:, 2] * 0.02) - 0.01

    key = jax.random.PRNGKey(g)
    ref = jocc.update(jocc.OccupancyGrid(jnp.asarray(dens),
                                         jnp.ones((g, g, g)),
                                         jnp.float32(0.01)),
                      field, key, jnp.asarray(mu), jnp.asarray(sigma),
                      num_cells=cells, decay=decay)
    k1, k2 = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k1, (cells,), 0, g ** 3))
    jit = np.asarray(jax.random.uniform(k2, (cells, 3)))
    _, counts = np.unique(idx, return_counts=True)
    assert (counts > 1).mean() > 0.25
    got = occupancy.update(
        occupancy.OccupancyGrid(torch.tensor(dens), torch.ones(g, g, g),
                                torch.tensor(0.01)),
        field, torch.tensor(mu), torch.tensor(sigma), num_cells=cells,
        decay=decay, flat_idx=torch.tensor(idx, dtype=torch.long),
        jitter=torch.tensor(jit))
    np.testing.assert_array_equal(got.density.numpy(), np.asarray(ref.density))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    assert float(occupancy.occupied_fraction(got)) == float(
        jocc.occupied_fraction(ref))
