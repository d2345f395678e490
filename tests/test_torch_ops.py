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

import port_config

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
    def linspace(start, stop, num, dtype=None):
        return jnp.asarray(sampling.linspace(float(start), float(stop),
                                             num).numpy())


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
    assert port_config.jax_view(cfg) == dataclasses.asdict(jcfg)
    h = cfg.hash
    np.testing.assert_array_equal(C.level_scales(h), jhe.level_scales(h))
    assert lowrank.cp_line_sizes(h) == jlowrank.cp_line_sizes(h)
    assert lowrank.cp_line_sizes(h) == [73, 154, 324, 685, 1449]
    base = dataclasses.replace(h, dense_levels=0)
    assert dense_grid.auto_dense_levels(base) == jdense.auto_dense_levels(base) == 2
    assert dense_grid.dense_grid_sizes(h) == jdense.dense_grid_sizes(h) == [18, 35]
    assert h.out_dim == 2 * 2 + 5 * 25 == 129


# ------------------------------------------------- training-time variants
#
# The JAX side draws its randomness from keys; each test draws the same
# numbers with jax.random from the same keys and hands them to the port.

@pytest.mark.parametrize("log_sampling", [False, True])
@pytest.mark.parametrize("per_ray", [True, False])
def test_stratified_ts_jitter_match(log_sampling, per_ray):
    key = jax.random.PRNGKey(11)
    u = np.asarray(jax.random.uniform(key, (5, 32) if per_ray else (32,)))
    port = sampling.stratified_ts((5,), 2.0, 6.0, 32,
                                  log_sampling=log_sampling, jitter=True,
                                  per_ray_jitter=per_ray, u=torch.tensor(u))
    ref = jsampling.stratified_ts(key, (5,), 2.0, 6.0, 32,
                                  per_ray_jitter=per_ray,
                                  log_sampling=log_sampling, jitter=True)
    assert tuple(port.shape) == ref.shape
    close(port, ref)
    # drawn from a generator: inside each jittered stratum
    t = sampling.stratified_ts((5,), 2.0, 6.0, 32, jitter=True,
                               generator=torch.Generator().manual_seed(0))
    base = sampling.stratified_ts((5,), 2.0, 6.0, 32)
    assert bool(((t >= base) & (t < base + 4.0 / 32)).all())


@pytest.mark.parametrize("stratified", [False, True])
def test_sample_pdf_jitter_match(stratified):
    """iid u, or stratified (i + xi) / K: the JAX draw, injected."""
    rng = np.random.default_rng(12)
    bins = np.sort(rng.uniform(2, 6, (30, 17)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 1, (30, 16)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    draw = np.asarray(jax.random.uniform(key, (30, 12), maxval=1.0 - 1e-6))
    port = sampling.sample_pdf(
        torch.tensor(bins), torch.tensor(w), 12, jitter=True,
        stratified=stratified,
        **({"xi": torch.tensor(draw)} if stratified
           else {"u": torch.tensor(draw)}))
    ref = jsampling.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 12,
                               stratified=stratified)
    close(port, ref)
    if stratified:
        assert bool((port[:, 1:] >= port[:, :-1]).all())


@pytest.mark.parametrize("stratified,probe_jitter",
                         [(True, False), (False, True), (True, True)])
def test_occupancy_guided_ts_training_match(stratified, probe_jitter,
                                            monkeypatch):
    """Training placement: 5% exploration floor, stratified or iid (then
    sorted) quantiles, optional probe jitter, mass dt.  The JAX side gets
    torch's sums (see test_occupancy_guided_ts_match): atol 1e-5."""
    monkeypatch.setattr(jsampling, "jnp", _JnpWithTorchSums())
    rng = np.random.default_rng(13)
    mask = np.zeros((16, 16, 16), np.float32)
    mask[4:12, 4:12, 4:12] = 1.0
    jg, tg = _occ_pair(mask)
    o, d = _rays(rng, 64)
    K, M = 12, 20
    key = jax.random.PRNGKey(5)
    draws = {}
    k_pdf = key
    if probe_jitter:
        kp, k_pdf = jax.random.split(key)
        draws["probe_u"] = torch.tensor(np.asarray(
            jax.random.uniform(kp, (64, M))))
    draw = torch.tensor(np.asarray(jax.random.uniform(
        k_pdf, (64, K), maxval=1.0 - 1e-6)))
    draws["xi" if stratified else "u"] = draw
    t_p, dt_p = sampling.occupancy_guided_ts(
        torch.tensor(o), torch.tensor(d), tg, torch.tensor(MU),
        torch.tensor(SIGMA), 2.0, 6.0, K, num_probe=M, dt_mode="mass",
        jitter=True, explore_frac=0.05, probe_jitter=probe_jitter,
        stratified=stratified, **draws)
    t_j, dt_j = jsampling.occupancy_guided_ts(
        key, jnp.asarray(o), jnp.asarray(d), jg, jnp.asarray(MU), SIGMA,
        2.0, 6.0, K, num_probe=M, jitter=True, explore_frac=0.05,
        probe_jitter=probe_jitter, dt_mode="mass", stratified=stratified)
    close(t_p, t_j)
    close(dt_p, dt_j)
    assert bool((t_p[:, 1:] >= t_p[:, :-1]).all())


class _InjectedRandom:
    """Stands in for jax.random inside the JAX occupancy module: the cells
    and jitter of an update round are the test's."""

    def __init__(self, cells, jitter):
        self.cells, self.jitter = cells, jitter

    @staticmethod
    def split(key):
        return key, key

    def randint(self, key, shape, lo, hi):
        return jnp.asarray(self.cells)

    def uniform(self, key, shape):
        return jnp.asarray(self.jitter)


def test_occupancy_update_match(monkeypatch):
    """One culling round from the same grid, with distinct injected cells
    and jitter: decay, inf for never-visited cells, max with the fresh
    density, the threshold mask (density atol 1e-5, mask exact)."""
    rng = np.random.default_rng(14)
    g = 16
    dens = rng.uniform(0.0, 0.05, (g, g, g)).astype(np.float32)
    dens[rng.random((g, g, g)) < 0.3] = np.inf
    cells = rng.choice(g ** 3, 700, replace=False).astype(np.int32)
    jit = rng.uniform(size=(700, 3)).astype(np.float32)

    def field(p, lib):
        return 3.0 * lib.exp(-lib.sum(p ** 2, axis=-1) * 4.0) - 0.5

    monkeypatch.setattr(jocc, "jax", type("J", (), {
        "random": _InjectedRandom(cells, jit)}))
    jgrid = jocc.OccupancyGrid(density=jnp.asarray(dens),
                               mask=jnp.ones((g, g, g)),
                               threshold=jnp.float32(0.01))
    ref = jocc.update(jgrid, lambda p: field(p, jnp), None, jnp.asarray(MU),
                      SIGMA, num_cells=700, decay=0.9)
    tgrid = occupancy.OccupancyGrid(torch.tensor(dens), torch.ones(g, g, g),
                                    torch.tensor(0.01))
    port = occupancy.update(
        tgrid, lambda p: 3.0 * torch.exp(-torch.sum(p ** 2, dim=-1) * 4.0)
        - 0.5, torch.tensor(MU), torch.tensor(SIGMA), decay=0.9,
        flat_idx=torch.tensor(cells, dtype=torch.long),
        jitter=torch.tensor(jit))
    fin = np.isfinite(np.asarray(ref.density))
    np.testing.assert_array_equal(np.isfinite(port.density.numpy()), fin)
    close(port.density.numpy()[fin], np.asarray(ref.density)[fin])
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    assert float(occupancy.occupied_fraction(port)) == pytest.approx(
        float(jocc.occupied_fraction(ref)))
    assert torch.equal(tgrid.density, torch.tensor(dens))   # not modified


def test_occupancy_update_duplicate_cells_keep_largest():
    """A cell drawn three times keeps the candidate of its last draw (as
    the JAX ``.at[].set`` keeps the last write on the CPU), not the largest
    of its candidates: 0.3 of (0.1, 0.7, 0.3), under the threshold 0.5."""
    grid = occupancy.OccupancyGrid(torch.full((4, 4, 4), float("inf")),
                                   torch.ones(4, 4, 4), torch.tensor(0.5))
    cells = torch.tensor([5, 5, 5, 9])
    vals = iter([torch.tensor([0.1, 0.7, 0.3, 0.2])])
    out = occupancy.update(grid, lambda p: next(vals), torch.zeros(3),
                           torch.tensor(1.0), flat_idx=cells,
                           jitter=torch.zeros(4, 3))
    flat = out.density.reshape(-1)
    assert float(flat[5]) == pytest.approx(0.3) and float(flat[9]) == pytest.approx(0.2)
    assert float(out.mask.reshape(-1)[5]) == 0.0
    assert float(out.mask.reshape(-1)[9]) == 0.0
    assert int(torch.isinf(flat).sum()) == 62
