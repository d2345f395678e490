"""PyTorch port vs the JAX package: ray, sampling, compositing and occupancy
ops, and the level geometry.

Inputs are made with numpy from a seed and fed to both sides.  Both sides
compute in f32 on the CPU; the only differences are summation order and
transcendental rounding, so the tolerance is atol 1e-5 throughout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu.ops import compositing as jcomp
from human_body_reconstruction_tpu.ops import dense_grid as jdense
from human_body_reconstruction_tpu.ops import hash_encoding as jhe
from human_body_reconstruction_tpu.ops import lowrank as jlowrank
from human_body_reconstruction_tpu.ops import occupancy as jocc
from human_body_reconstruction_tpu.ops import positional as jpos
from human_body_reconstruction_tpu.ops import rays as jrays
from human_body_reconstruction_tpu.ops import sampling as jsampling
from human_body_reconstruction_tpu_torch.ops import (
    compositing, dense_grid, lowrank, occupancy, positional, rays, sampling)
from human_body_reconstruction_tpu_torch.utils import config as C

ATOL = 1e-5


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=0,
                               atol=atol)


def _camera(rng):
    K = np.array([[20.0, 0, 8.0], [0, 20.0, 8.0], [0, 0, 1]], np.float32)
    from human_body_reconstruction_tpu_torch.data.synthetic import orbit_poses

    c2w = orbit_poses(5)[rng.integers(5)]
    return K, c2w


def _occ_grid(rng, g=16):
    mask = (rng.random((g, g, g)) < 0.4).astype(np.float32)
    return mask


def _occ_pair(mask):
    j = jocc.OccupancyGrid(density=jnp.asarray(mask), mask=jnp.asarray(mask),
                           threshold=jnp.float32(0.01))
    t = occupancy.OccupancyGrid(torch.tensor(mask), torch.tensor(mask),
                                torch.tensor(0.01))
    return j, t


def _rays(rng, n=64):
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.3 + [0, 0, 4.0]
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.2 + [0, 0, -1.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o.astype(np.float32), d


MU = np.array([-1.5, -1.5, -1.5], np.float32)
SIGMA = np.float32(3.0 * np.sqrt(3.0))


def test_rays_match():
    rng = np.random.default_rng(0)
    K, c2w = _camera(rng)
    i = rng.uniform(0, 16, 50).astype(np.float32)
    j = rng.uniform(0, 16, 50).astype(np.float32)
    close(rays.pixel_dirs(torch.tensor(i), torch.tensor(j), torch.tensor(K)),
          jrays.pixel_dirs(jnp.asarray(i), jnp.asarray(j), jnp.asarray(K)))
    for a, b in zip(rays.full_image_rays(12, 16, torch.tensor(K),
                                         torch.tensor(c2w)),
                    jrays.full_image_rays(12, 16, jnp.asarray(K),
                                          jnp.asarray(c2w))):
        assert tuple(a.shape) == b.shape
        close(a, b)
    from human_body_reconstruction_tpu_torch.data.synthetic import orbit_poses

    poses = orbit_poses(3)
    for a, b in zip(rays.scene_bounds(8, 8, torch.tensor(K),
                                      torch.tensor(poses), 2.0, 6.0),
                    jrays.scene_bounds(8, 8, jnp.asarray(K),
                                       jnp.asarray(poses), 2.0, 6.0)):
        close(a, b, atol=1e-4)


def test_orbit_poses_match():
    from human_body_reconstruction_tpu.data import synthetic as jsyn
    from human_body_reconstruction_tpu_torch.data import synthetic

    np.testing.assert_array_equal(synthetic.orbit_poses(7, 3.0, 0.3),
                                  np.asarray(jsyn.orbit_poses(7, 3.0, 0.3)))


@pytest.mark.parametrize("mode", ["linear", "nerf"])
def test_positional_match(mode):
    x = np.random.default_rng(1).normal(size=(33, 3)).astype(np.float32)
    close(positional.positional_encode(torch.tensor(x), 4, mode),
          jpos.positional_encode(jnp.asarray(x), 4, mode))


@pytest.mark.parametrize("with_dt", [False, True])
def test_composite_match(with_dt):
    rng = np.random.default_rng(2)
    t = np.sort(rng.uniform(2, 6, (40, 24)), axis=-1).astype(np.float32)
    rgb = rng.uniform(size=(40, 24, 3)).astype(np.float32)
    sigma = rng.uniform(-0.5, 8.0, (40, 24)).astype(np.float32)
    dn = rng.uniform(0.8, 1.3, (40, 1)).astype(np.float32)
    dt = rng.uniform(0, 0.3, (40, 24)).astype(np.float32) if with_dt else None
    port = compositing.composite(
        torch.tensor(t), torch.tensor(rgb), torch.tensor(sigma),
        torch.tensor(dn), dt=None if dt is None else torch.tensor(dt))
    ref = jcomp.composite(jnp.asarray(t), jnp.asarray(rgb),
                          jnp.asarray(sigma), jnp.asarray(dn),
                          dt=None if dt is None else jnp.asarray(dt))
    for a, b in zip(port, ref):
        close(a, b)
    close(compositing.psnr(torch.tensor(rgb), torch.tensor(rgb * 0.9)),
          jcomp.psnr(jnp.asarray(rgb), jnp.asarray(rgb * 0.9)), atol=1e-4)


def test_occupancy_lookup_match():
    rng = np.random.default_rng(3)
    mask = _occ_grid(rng)
    jg, tg = _occ_pair(mask)
    # points inside and well outside the box: negative cells truncate
    # toward zero before the clip
    pts = rng.uniform(-4, 4, (500, 3)).astype(np.float32)
    port = occupancy.lookup(tg, torch.tensor(pts), torch.tensor(MU),
                            torch.tensor(SIGMA))
    ref = jocc.lookup(jg, jnp.asarray(pts), jnp.asarray(MU), SIGMA)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    g0 = occupancy.init_grid(8, 0.02)
    assert g0.mask.shape == (8, 8, 8) and bool(torch.isinf(g0.density).all())


@pytest.mark.parametrize("log_sampling", [False, True])
def test_stratified_ts_match(log_sampling):
    port = sampling.stratified_ts((5,), 2.0, 6.0, 64,
                                  log_sampling=log_sampling)
    ref = jsampling.stratified_ts(None, (5,), 2.0, 6.0, 64, jitter=False,
                                  log_sampling=log_sampling)
    assert tuple(port.shape) == ref.shape
    close(port, ref)


def test_sample_pdf_match():
    rng = np.random.default_rng(4)
    bins = np.sort(rng.uniform(2, 6, (30, 17)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 1, (30, 16)).astype(np.float32)
    w[:, 3:7] = 0.0
    port = sampling.sample_pdf(torch.tensor(bins), torch.tensor(w), 12)
    ref = jsampling.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 12,
                               deterministic=True)
    close(port, ref)
    # the quantile ladder itself, and an injected u reaching past cdf[-1]
    close(sampling.linspace(0.0, 1.0 - 1e-6, 12),
          jnp.linspace(0.0, 1.0 - 1e-6, 12), atol=1e-7)
    u = rng.uniform(0, 1, (30, 12)).astype(np.float32)
    u[:, -1] = 1.0
    close(sampling.sample_pdf(torch.tensor(bins), torch.tensor(w), 12,
                              u=torch.tensor(u)),
          jsampling.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 12,
                               u=jnp.asarray(u)))


class _JnpWithTorchSums:
    """jax.numpy, except that the sums, the cumsum and the quantile ladder
    come from torch: handed to the JAX sampling module, it makes both
    sides build the same pdf, cdf and u."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def cumsum(x, axis):
        return jnp.asarray(torch.cumsum(torch.tensor(np.asarray(x)),
                                        dim=axis).numpy())

    @staticmethod
    def sum(x, axis, keepdims=False):
        return jnp.asarray(torch.sum(torch.tensor(np.asarray(x)), dim=axis,
                                     keepdim=keepdims).numpy())

    @staticmethod
    def linspace(start, stop, num):
        return jnp.asarray(sampling.linspace(start, stop, num).numpy())


@pytest.mark.parametrize("dt_mode", ["mass", "clip"])
def test_occupancy_guided_ts_match(dt_mode, monkeypatch):
    """The eps-floored empty tail of a ray's CDF makes t sensitive to the
    last ulps of the pdf sums (XLA on the CPU sums in other orders than
    torch), so the JAX side gets torch's sums: the same cdf on both sides,
    and the placement logic held to atol 1e-5."""
    monkeypatch.setattr(jsampling, "jnp", _JnpWithTorchSums())
    rng = np.random.default_rng(5)
    mask = _occ_grid(rng)
    mask[:, :, :] = 0.0
    mask[4:12, 4:12, 4:12] = 1.0          # a solid block, some rays miss
    jg, tg = _occ_pair(mask)
    o, d = _rays(rng, 96)
    t_p, dt_p = sampling.occupancy_guided_ts(
        torch.tensor(o), torch.tensor(d), tg, torch.tensor(MU),
        torch.tensor(SIGMA), 2.0, 6.0, 16, num_probe=24, dt_mode=dt_mode)
    t_j, dt_j = jsampling.occupancy_guided_ts(
        None, jnp.asarray(o), jnp.asarray(d), jg, jnp.asarray(MU), SIGMA,
        2.0, 6.0, 16, num_probe=24, jitter=False, explore_frac=0.0,
        dt_mode=dt_mode)
    close(t_p, t_j)
    close(dt_p, dt_j)


def test_level_geometry_full_width():
    """level_scales / cp_line_sizes / auto_dense_levels and the whole zero-
    flag preset config agree with the JAX package at full width (finest CP
    line 1449: the float64 scale is 1447.99999...)."""
    from human_body_reconstruction_tpu.cli import train_hash

    jcfg = train_hash.make_config(train_hash.build_parser().parse_args([]))
    cfg = C.flagship_config()
    assert cfg == jcfg
    h = cfg.hash
    np.testing.assert_array_equal(C.level_scales(h), jhe.level_scales(h))
    assert lowrank.cp_line_sizes(h) == jlowrank.cp_line_sizes(h)
    assert lowrank.cp_line_sizes(h) == [73, 154, 324, 685, 1449]
    base = dataclasses.replace(h, dense_levels=0)
    assert dense_grid.auto_dense_levels(base) == jdense.auto_dense_levels(base) == 2
    assert dense_grid.dense_grid_sizes(h) == jdense.dense_grid_sizes(h) == [18, 35]
    assert h.out_dim == 2 * 2 + 5 * 25 == 129
