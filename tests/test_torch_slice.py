"""The served slice end to end: a run directory written by the JAX package,
restored by the port, rendered by both.

A small CP model (4 levels up to n_max 128, rank 8, auto dense levels, MLP
width 32) is built by the JAX trainer's init_params, saved with the JAX
``save_pytree`` plus occupancy extras, ``to_json`` and ``save_bounds``; the
port's ``restore`` reads the directory and ``render_image`` draws 16x16
frames that are held to the JAX ``render_image_fused`` on the ladder and
with guided placement, in f32 and in bf16.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu.ops import occupancy as jocc
from human_body_reconstruction_tpu.pipeline import restore as jrestore
from human_body_reconstruction_tpu.train import checkpoint as jckpt
from human_body_reconstruction_tpu.train import step as jstep
from human_body_reconstruction_tpu.train import trainer as jtrainer
from human_body_reconstruction_tpu_torch.data.synthetic import orbit_poses
from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.ops import dense_grid
from human_body_reconstruction_tpu_torch.pipeline import restore
from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
from human_body_reconstruction_tpu_torch.train import step
from human_body_reconstruction_tpu_torch.utils import config as C

H = W = 16
LO = np.array([-1.5, -1.5, -1.5], np.float32)
HI = np.array([1.5, 1.5, 1.5], np.float32)


def small_cfg(dense_bf16: bool) -> C.PipelineConfig:
    h = C.HashConfig(num_levels=4, n_max=128, variant="cp", cp_rank=8,
                     dense_bf16=dense_bf16, init_scale=0.5,
                     cp_init_scale=0.6)
    h = dataclasses.replace(h, dense_levels=dense_grid.auto_dense_levels(h))
    return C.PipelineConfig(
        hash=h, mlp=C.MLPConfig(width=32),
        render=C.RenderConfig(num_samples=16, occupancy=True,
                              occupancy_resolution=32, occ_probes=8,
                              occ_dt="mass"))


def occ_mask(g=32):
    """A centred ball of occupied cells (in the normalised scene box)."""
    c = (np.arange(g) + 0.5) / g * np.sqrt(3.0) * 3.0 - 1.5
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    return ((xx ** 2 + yy ** 2 + zz ** 2) < 1.0).astype(np.float32)


def write_jax_run(path, cfg, name="m"):
    params = jtrainer.init_params(jax.random.PRNGKey(0), cfg)
    params = jax.tree.map(np.array, params)       # writable copies
    params["mlp"]["sig"][-1]["b"][0] += 2.0     # visibly opaque density
    mask = occ_mask(cfg.render.occupancy_resolution)
    jckpt.save_pytree(os.path.join(path, f"{name}_ckpt.npz"), params,
                      extra={"occ_density": mask, "occ_mask": mask,
                             "occ_threshold": np.float32(0.01)})
    C.to_json(cfg, os.path.join(path, f"{name}_config.json"))
    jckpt.save_bounds(os.path.join(path, "bounds_model.npy"), LO, HI)
    return params, mask


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    out = {}
    for dense_bf16 in (False, True):
        d = str(tmp_path_factory.mktemp(f"run_bf16_{dense_bf16}"))
        params, mask = write_jax_run(d, small_cfg(dense_bf16))
        out[dense_bf16] = (d, params, mask)
    return out


def camera():
    f = W / (2.0 * np.tan(0.6911112 / 2.0))
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]], np.float32)
    return K, orbit_poses(4)[1]


# Tolerances on pixel values in [0, 1].  f32: both sides compute the same
# function in f32, measured 3e-7: atol 1e-5.  bf16: the port's CPU encoder
# computes the Pallas kernels' roundings, the JAX CPU path the XLA ones (a
# few bf16 ulps per feature, tests/test_torch_encoders.py), and the bf16 MLP
# can carry such a step across a rounding boundary; measured 9e-5: atol 1e-3.
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("guided", [0, 8], ids=["ladder", "guided"])
def test_render_image_matches_jax(run_dirs, bf16, guided):
    d, params, mask = run_dirs[bf16]
    res = restore.restore(d, "m", device="cpu", with_occ=True,
                          log_fn=lambda s: None)
    assert res.cfg_source == "json" and res.occ is not None
    cfg = dataclasses.replace(res.cfg, render=dataclasses.replace(
        res.cfg.render, eval_guided=guided))
    K, c2w = camera()
    img = step.render_image(res.field, res.scene, H, W, torch.tensor(K),
                            torch.tensor(c2w), cfg, occ=res.occ,
                            num_samples=16, chunk=100, bf16=bf16).numpy()

    jcfg = jrestore.load_config(d, "m")[0]
    jcfg = dataclasses.replace(jcfg, render=dataclasses.replace(
        jcfg.render, eval_guided=guided))
    occ = jocc.OccupancyGrid(density=jnp.asarray(mask),
                             mask=jnp.asarray(mask),
                             threshold=jnp.float32(0.01))
    ref = np.asarray(jstep.render_image_fused(
        jax.tree.map(jnp.asarray, params), jrestore.scene_from_bounds(LO, HI),
        H, W, jnp.asarray(K), jnp.asarray(c2w), jcfg, occ=occ,
        num_samples=16, chunk=128, bf16=bf16))
    assert img.shape == ref.shape == (H, W, 3)
    assert np.isfinite(img).all() and img.std() > 1e-3
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-3 if bf16 else 1e-5)


def test_checkpoint_round_trips(run_dirs, tmp_path):
    d, params, mask = run_dirs[True]
    cfg = small_cfg(True)
    field = ckpt.from_jax_params(params, cfg)
    back = ckpt.to_jax_params(field)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    # port-written checkpoint restores in the JAX package
    path = str(tmp_path / "p_ckpt.npz")
    fresh = nerf.Field(cfg)    # zeros: a template of the right shapes
    ckpt.save_params(path, field, extra={"occ_mask": torch.tensor(mask)})
    loaded, extra = jckpt.load_pytree(path, params, extra_keys=("occ_mask",))
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(extra["occ_mask"], mask)
    # and back into a fresh port field
    ckpt.load_params(path, fresh)
    for a, b in zip(fresh.parameters(), field.parameters()):
        assert torch.equal(a, b)
    # bounds under the other spelling
    os.rename(os.path.join(d, "bounds_model.npy"), os.path.join(d, "bounds.npy"))
    try:
        lo, hi = ckpt.load_bounds(os.path.join(d, "bounds_model.npy"))
    finally:
        os.rename(os.path.join(d, "bounds.npy"),
                  os.path.join(d, "bounds_model.npy"))
    np.testing.assert_array_equal(lo, LO)
    np.testing.assert_array_equal(hi, HI)


def test_checkpoint_shape_mismatch_raises(run_dirs):
    d, _, _ = run_dirs[True]
    other = dataclasses.replace(small_cfg(True), hash=dataclasses.replace(
        small_cfg(True).hash, cp_rank=4))
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_params(os.path.join(d, "m_ckpt.npz"), nerf.Field(other))
