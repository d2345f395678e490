"""Train-state checkpoints of the port against the JAX package, on the CPU:
the optax optimizer-state layout, a JAX checkpoint continued by the port,
a port checkpoint read by JAX, and the port's own save -> load -> continue
against an uninterrupted run.

A small CP model (4 levels up to n_max 128, rank 4, auto dense levels, MLP
width 16), with and without SDF mode (the ``var`` label), and a small corner
hash grid (a ``table`` with no dense levels).  Gradients are drawn with
numpy.  Both optimizers compute Adam in f32 in different orders: params and
moments after an update atol 1e-6.  Test names avoid the words that
tests/conftest.py marks slow (a continued run is "continue", never the
other word).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from human_body_reconstruction_tpu.ops import occupancy as jocc
from human_body_reconstruction_tpu.train import checkpoint as jckpt
from human_body_reconstruction_tpu.train import state as jstate
from human_body_reconstruction_tpu.train import trainer as jtrainer
from human_body_reconstruction_tpu_torch.cli import train_hash
from human_body_reconstruction_tpu_torch.data import synthetic
from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.ops import dense_grid, occupancy
from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
from human_body_reconstruction_tpu_torch.train import state
from human_body_reconstruction_tpu_torch.train import trainer as trainer_lib
from human_body_reconstruction_tpu_torch.utils import config as C
from torch_threads import one_torch_thread  # noqa: F401

TOTAL = 20


def small_cfg(kind: str) -> C.PipelineConfig:
    """"cp", "cp_sdf" or "hash"."""
    if kind == "hash":
        h = C.HashConfig(num_levels=4, n_max=64, log2_table_size=8)
    else:
        h = C.HashConfig(num_levels=4, n_max=128, variant="cp", cp_rank=4)
        h = dataclasses.replace(h,
                                dense_levels=dense_grid.auto_dense_levels(h))
    sdf = kind == "cp_sdf"
    return C.PipelineConfig(
        hash=h, mlp=C.MLPConfig(width=16, density_activation="sdf" if sdf
                                else "leaky_relu"),
        render=C.RenderConfig(num_samples=16, use_sdf=sdf),
        train=C.TrainConfig(ray_batch=32, eikonal_subsample=64))


def jax_params(cfg):
    return jax.tree.map(jnp.asarray, jtrainer.init_params(
        jax.random.PRNGKey(0), cfg))


def numpy_grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(
        rng.normal(size=np.shape(x)).astype(np.float32)), params)


def port_update(field, opt, grads, count):
    """One port update from a JAX-layout gradient pytree."""
    for (p, tr), g in zip(ckpt._slots(field),
                          jax.tree_util.tree_leaves(grads)):
        g = torch.tensor(np.asarray(g))
        p.grad = g.t().contiguous() if tr else g
    opt.step(count)
    opt.zero_grad()


def jax_update(params, opt_state, tx, grads):
    updates, opt_state = tx.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state


@pytest.mark.parametrize("kind", ["cp", "cp_sdf", "hash"])
def test_opt_state_layout_matches_optax(kind):
    """``opt_leaves`` has the leaves of ``make_optimizer(...).init`` in
    order, shape and dtype (the counts int32, a table label of two counts
    for a CP model, no decay or constant-rate state), and after two
    updates their values."""
    cfg = small_cfg(kind)
    params = jax_params(cfg)
    tx = jstate.make_optimizer(cfg.train, TOTAL, params)
    opt_state = tx.init(params)
    field = ckpt.from_jax_params(jax.tree.map(np.asarray, params), cfg)
    opt = state.make_optimizer(cfg.train, TOTAL, field)
    ref = jax.tree_util.tree_leaves(opt_state)
    got = ckpt.opt_leaves(field, opt, 0)
    assert [(np.shape(a), np.asarray(a).dtype) for a in got] == \
        [(np.shape(b), np.asarray(b).dtype) for b in ref]
    labels = [lb for lb, _, _ in ckpt.opt_blocks(field)]
    assert labels == sorted(opt_state.inner_states)
    for k in range(2):
        grads = numpy_grads(params, k)
        params, opt_state = jax_update(params, opt_state, tx, grads)
        port_update(field, opt, grads, k)
    for a, b in zip(ckpt.opt_leaves(field, opt, 2),
                    jax.tree_util.tree_leaves(opt_state)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["cp", "cp_sdf"])
def test_jax_checkpoint_continues_in_port(kind, tmp_path):
    """A JAX ``save_train_state`` after two updates (with a grid) loads
    into the port, whose next update equals JAX's: params and moments."""
    cfg = small_cfg(kind)
    params = jax_params(cfg)
    jst, tx = jstate.create_train_state(params, cfg.train, TOTAL,
                                        occ=jocc.init_grid(8))
    for k in range(2):
        p, o = jax_update(jst.params, jst.opt_state, tx, numpy_grads(params, k))
        jst = jst._replace(params=p, opt_state=o, step=jst.step + 1)
    path = str(tmp_path / "j_ckpt.npz")
    jckpt.save_train_state(path, jst)

    st = state.create_train_state(nerf.Field(cfg), cfg.train, TOTAL)
    gen = torch.Generator().manual_seed(5)
    ckpt.load_train_state(path, st, generator=gen, seed=3)
    assert st.step == 2 and st.occ is not None
    assert torch.equal(st.occ.mask, torch.tensor(np.asarray(jst.occ.mask)))
    # a JAX file has no generator state: reseeded from (seed, step)
    assert torch.equal(gen.get_state(), torch.Generator().manual_seed(
        3 * 2 ** 32 + 2).get_state())
    for a, b in zip(ckpt.jax_leaves(st.field),
                    jax.tree_util.tree_leaves(jst.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    grads = numpy_grads(params, 2)
    p, o = jax_update(jst.params, jst.opt_state, tx, grads)
    port_update(st.field, st.opt, grads, st.step)
    for a, b in zip(ckpt.jax_leaves(st.field), jax.tree_util.tree_leaves(p)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    for a, b in zip(ckpt.opt_leaves(st.field, st.opt, 3),
                    jax.tree_util.tree_leaves(o)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["cp", "cp_sdf", "hash"])
def test_port_checkpoint_reloads_in_jax(kind, tmp_path):
    """A port ``save_train_state`` after two updates reads back through
    JAX ``load_train_state`` with the same leaves, bit for bit, and the
    step and grid; the generator's state rides along as an extra."""
    cfg = small_cfg(kind)
    params = jax_params(cfg)
    field = ckpt.from_jax_params(jax.tree.map(np.asarray, params), cfg)
    st = state.create_train_state(field, cfg.train, TOTAL,
                                  occ=occupancy.init_grid(8, 0.01))
    for k in range(2):
        port_update(field, st.opt, numpy_grads(params, k), k)
    st.step = 2
    path = str(tmp_path / "p_ckpt.npz")
    ckpt.save_train_state(path, st, generator=torch.Generator().manual_seed(1))
    template, _ = jstate.create_train_state(params, cfg.train, TOTAL)
    jst = jckpt.load_train_state(path, template)
    assert int(jst.step) == 2 and jst.occ is not None
    for a, b in zip(ckpt.jax_leaves(field),
                    jax.tree_util.tree_leaves(jst.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(ckpt.opt_leaves(field, st.opt, 2),
                    jax.tree_util.tree_leaves(jst.opt_state)):
        assert np.asarray(b).dtype == a.dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    with np.load(path) as data:
        assert "extra_torch_rng" in data


def tiny_cfg(sdf: bool) -> C.PipelineConfig:
    """Occupancy installed after 4 steps and refreshed every 3, guided
    placement (the SDF case: the quality protocol's SDF composition with a
    subsampled eikonal term and the hierarchical pass)."""
    h = C.HashConfig(num_levels=4, n_max=64, variant="cp", cp_rank=4)
    h = dataclasses.replace(h, dense_levels=dense_grid.auto_dense_levels(h))
    return C.PipelineConfig(
        hash=h, mlp=C.MLPConfig(width=16, density_activation="sdf" if sdf
                                else "leaky_relu"),
        render=C.RenderConfig(num_samples=16, occupancy=True,
                              occupancy_resolution=16, compact_samples=8,
                              occ_guided=True, occ_probes=8, occ_dt="mass",
                              occ_stratified=True, use_sdf=sdf,
                              hierarchical=sdf,
                              num_fine_samples=8 if sdf else 0),
        train=C.TrainConfig(ray_batch=64, occ_warmup_steps=4, update_rate=3,
                            cp_tv_weight=1e-2, eikonal_subsample=100))


@pytest.fixture(scope="module")
def blobs():
    return synthetic.make_dataset(n_views=3, H=12, W=12, focal=15.0,
                                  gt_samples=64)


def run_steps(cfg, ds, out_dir, steps, load=False):
    tr = trainer_lib.Trainer(cfg=cfg, ds=ds, out_dir=out_dir, model_name="m",
                             total_steps=9, log_fn=lambda s: None)
    if load:
        tr.load()
    tr.run(steps, log_every=1)
    return tr


@pytest.mark.parametrize("k,sdf", [(6, False), (3, False), (6, True)],
                         ids=["across_warmup", "before_warmup",
                              "sdf_hierarchical"])
def test_continue_equals_uninterrupted_run(k, sdf, blobs, tmp_path):
    """k steps, ``save``, a fresh Trainer, ``load``, 9 - k more steps: the
    same per-step losses and the same params, moments, step, grid and
    generator as 9 steps in one go, bit for bit (before_warmup: the grid
    is installed after the load, at step 4)."""
    cfg = tiny_cfg(sdf)
    whole = run_steps(cfg, blobs, str(tmp_path / "whole"), 9)
    first = run_steps(cfg, blobs, str(tmp_path / "split"), k)
    first.save()
    with np.load(first.ckpt_path()) as data:
        assert ("extra_occ_mask" in data) == (k >= 4)
    rest = run_steps(cfg, blobs, str(tmp_path / "split"), 9 - k, load=True)
    assert rest.state.step == whole.state.step == 9
    losses = [r["loss"] for r in whole.history]
    assert [r["loss"] for r in first.history + rest.history] == losses
    assert all(np.isfinite(losses))
    for a, b in zip(ckpt.jax_leaves(rest.state.field),
                    ckpt.jax_leaves(whole.state.field)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ckpt.opt_leaves(rest.state.field, rest.state.opt, 9),
                    ckpt.opt_leaves(whole.state.field, whole.state.opt, 9)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(rest.state.occ, whole.state.occ):
        assert torch.equal(a, b)
    assert torch.equal(rest.generator.get_state(), whole.generator.get_state())


def test_reload_without_occupancy_drops_saved_grid(tmp_path):
    """``allow_occ=False`` leaves a state without a grid as it is, as in
    JAX; True (a run whose warmup holds its grid back) takes the saved
    one; a state with a grid takes it either way."""
    cfg = small_cfg("cp")
    field = nerf.Field(cfg, generator=torch.Generator().manual_seed(0))
    grid = occupancy.init_grid(8, 0.01)
    grid = occupancy.OccupancyGrid(grid.density * 0.5, grid.mask * 0,
                                   grid.threshold)
    st = state.create_train_state(field, cfg.train, TOTAL, occ=grid)
    path = str(tmp_path / "c.npz")
    ckpt.save_train_state(path, st)
    for allow, occ, want in ((False, None, None), (True, None, grid),
                             (False, occupancy.init_grid(8, 0.01), grid)):
        fresh = state.create_train_state(nerf.Field(cfg), cfg.train, TOTAL,
                                         occ=occ)
        ckpt.load_train_state(path, fresh, allow_occ=allow)
        if want is None:
            assert fresh.occ is None
        else:
            assert all(torch.equal(a, b) for a, b in zip(fresh.occ, want))
    bare = str(tmp_path / "bare.npz")
    ckpt.save_params(bare, field)
    with pytest.raises(ValueError, match="no optimizer state"):
        ckpt.load_train_state(bare, state.create_train_state(
            nerf.Field(cfg), cfg.train, TOTAL))


def test_cli_load_continues_the_run(tmp_path, capsys):
    """``train_hash --load`` continues the run in ``--out_dir`` for
    ``--steps`` more steps from its checkpoint, as the JAX CLI does."""
    argv = ["--synthetic", "--num_batch", "32", "--max_res", "64",
            "--num_levels", "3", "--cp_rank", "2", "--num_samples", "8",
            "--compact", "4", "--occ_probes", "4", "--occ_warmup", "2",
            "--log_every", "1", "--device", "cpu", "--out_dir",
            str(tmp_path), "--model_name", "cli"]
    first = train_hash.main(argv + ["--steps", "3"])
    assert first.state.step == 3 and first.state.occ is not None
    second = train_hash.main(argv + ["--steps", "2", "--load"])
    path = os.path.join(str(tmp_path), "cli_ckpt.npz")
    assert f"resumed from {path} at step 3" in capsys.readouterr().out
    assert second.state.step == 5
    assert [r["step"] for r in second.history] == [4, 5]
    with np.load(path) as data:
        assert int(data["extra_step"]) == 5
