"""PyTorch port vs the JAX package: the hash-grid ("corner") slice.

The hashed levels (L 4, T 2^10, F 2; tables lifted to U(-1, 1) so that the
tolerances mean something) encode points drawn with numpy, a quarter of
them outside the unit box of normalised coordinates, exactly (8 corners)
and with the single-corner estimator on the same uniforms u (JAX draws them
from its key; the port is handed them).  Then the stochastic corner bits that
the encoder keeps in place of u, the table gradients, the full encoder with
a dense level before the table, one training step against the JAX
``loss_fn`` (the ladder jitter and the encoder's uniforms drawn from the
JAX keys as its ``render_rays`` draws them), an occupancy refresh from the
trained field at a scaled count and decay, the plain Philox generator, and
run directories written by one package restored and rendered by the other.
Test names avoid the words that tests/conftest.py marks slow.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu.ops import hash_encoding as jhe
from human_body_reconstruction_tpu.ops import occupancy as jocc
from human_body_reconstruction_tpu.pipeline import restore as jrestore
from human_body_reconstruction_tpu.train import checkpoint as jckpt
from human_body_reconstruction_tpu.train import step as jstep
from human_body_reconstruction_tpu.train import trainer as jtrainer
from human_body_reconstruction_tpu_torch.cli import serve, train_hash
from human_body_reconstruction_tpu_torch.data.synthetic import orbit_poses
from human_body_reconstruction_tpu_torch.ops import (
    hash_encoding, hash_kernel, occupancy, rng_kernel)
from human_body_reconstruction_tpu_torch.pipeline import restore
from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
from human_body_reconstruction_tpu_torch.train import step
from human_body_reconstruction_tpu_torch.utils import config as C

N = 600
MU = np.array([-1.0, -2.0, -0.5], np.float32)
LO = np.array([-1.5, -1.5, -1.5], np.float32)
HI = np.array([1.5, 1.5, 1.5], np.float32)
B = 48


def hash_cfg(**kw) -> C.HashConfig:
    return C.HashConfig(num_levels=4, log2_table_size=10, n_max=128,
                        features_per_level=2, variant="corner", **kw)


def points(seed=0, n=N):
    """World points whose normalised coordinates lie in [0, 1]^3 for three
    quarters of them and leave the box on one axis (by up to 0.5) for the
    rest."""
    rng = np.random.default_rng(seed)
    xn = rng.uniform(0.0, 1.0, (n, 3))
    out = rng.permutation(n)[:n // 4]
    axis = rng.integers(0, 3, n // 4)
    xn[out, axis] = np.where(rng.uniform(size=n // 4) < 0.5,
                             rng.uniform(-0.5, 0.0, n // 4),
                             rng.uniform(1.0, 1.5, n // 4))
    return xn.astype(np.float32)


def inputs(cfg, sigma_vec: bool = False, seed=0):
    """(table, world points, mu, sigma) as numpy."""
    rng = np.random.default_rng(seed + 100)
    table = rng.uniform(-1, 1, (cfg.num_hashed_levels, cfg.table_size,
                                cfg.features_per_level)).astype(np.float32)
    sigma = (np.array([3.0, 2.5, 4.0], np.float32) if sigma_vec
             else np.float32(3.0))
    xn = points(seed)
    assert ((xn < 0) | (xn > 1)).any(-1).mean() == pytest.approx(0.25, abs=0.01)
    return table, (MU + xn * sigma).astype(np.float32), MU, sigma


def jax_u(cfg, key, n=N):
    """The uniforms JAX's stochastic encoder draws from ``key`` on the CPU."""
    return np.asarray(jax.random.uniform(key, (3, cfg.num_hashed_levels, n)))


def t(a):
    return torch.tensor(np.asarray(a))


def encode(table, x, mu, sigma, cfg, **kw):
    """The port's encoder over the hashed levels alone."""
    return hash_encoding.encode_params({"table": table}, x, mu, sigma, cfg,
                                       **kw)


@pytest.mark.parametrize("sigma_vec", [False, True], ids=["diag", "box"])
def test_hash_encode_exact_matches_jax(sigma_vec):
    cfg = hash_cfg()
    table, x, mu, sigma = inputs(cfg, sigma_vec)
    ref = np.asarray(jhe.hash_encode(jnp.asarray(table), jnp.asarray(x),
                                     jnp.asarray(mu), jnp.asarray(sigma), cfg))
    port = encode(t(table), t(x), t(mu), t(sigma), cfg).numpy()
    assert port.shape == ref.shape == (N, 8)
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-6)
    plain = hash_kernel.hash_encode_kernel(t(table), t(x), t(mu), t(sigma), cfg)
    np.testing.assert_array_equal(plain.numpy(), port)


def test_hash_encode_stochastic_matches_jax():
    """The same uniforms pick the same corners: the features are table
    entries, equal to the bit."""
    cfg = hash_cfg(stochastic_train=True)
    table, x, mu, sigma = inputs(cfg, seed=1)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jhe.hash_encode_stochastic(
        jnp.asarray(table), jnp.asarray(x), jnp.asarray(mu),
        jnp.asarray(sigma), cfg, key))
    port = encode(t(table), t(x), t(mu), t(sigma), cfg,
                  stochastic=True, u=t(jax_u(cfg, key)))
    np.testing.assert_array_equal(port.numpy(), ref)
    exact = encode(t(table), t(x), t(mu), t(sigma), cfg)
    assert not torch.equal(port, exact)


def test_stochastic_corner_bits_match_jax():
    """The picked corners' offset bits that the plain forward returns (and
    the CPU wrapper with it) are (u < frac) of JAX ``_level_coords`` on the
    same u, bit d of bits[l, n]; the plain backward from those bits equals
    the one from u bit for bit, and the features are the stochastic
    encoder's."""
    cfg = hash_cfg(stochastic_train=True)
    table, x, mu, sigma = inputs(cfg, sigma_vec=True, seed=5)
    u = jax_u(cfg, jax.random.PRNGKey(9))
    _, frac = jhe._level_coords(jnp.asarray(x), jnp.asarray(mu),
                                jnp.asarray(sigma), cfg)
    up = np.asarray(jnp.asarray(u) < frac).astype(np.uint8)      # (3, L, N)
    want = up[0] | (up[1] << 1) | (up[2] << 2)
    assert set(np.unique(want)) == set(range(8))
    feats, bits = hash_kernel.hash_encode_plain(
        t(table), t(x), t(mu), t(sigma), cfg, t(u))
    assert bits.dtype == torch.uint8 and tuple(bits.shape) == (4, N)
    np.testing.assert_array_equal(bits.numpy(), want)
    wf, wb = hash_kernel.hash_encode_kernel(t(table), t(x), t(mu), t(sigma),
                                            cfg, u=t(u))
    assert torch.equal(wf, feats) and torch.equal(wb, bits)
    port = encode(t(table), t(x), t(mu), t(sigma), cfg, stochastic=True,
                  u=t(u))
    assert torch.equal(port, feats)
    g = t(np.random.default_rng(8).normal(size=(N, 8)).astype(np.float32))
    from_u = hash_kernel.hash_encode_plain_backward(
        t(table), t(x), t(mu), t(sigma), cfg, g, u=t(u))
    from_bits = hash_kernel.hash_encode_plain_backward(
        t(table), t(x), t(mu), t(sigma), cfg, g, bits=bits)
    assert torch.equal(from_u, from_bits) and float(from_u.abs().max()) > 0.1


def test_hash_x_neighbours_share_an_aligned_pair():
    """``hash_rows`` equals JAX ``_hash_levels`` on uint32 corners
    (negative cells wrap), and for even x0 the corner x0 + 1 hashes to the
    row's neighbour, h ^ 1: the two rows share one 16-byte slot of an
    (L, T, 2) f32 table, which the kernels read and add as one float4.  For
    odd x0 that does not hold in general."""
    rng = np.random.default_rng(12)
    c = rng.integers(-2 ** 31, 2 ** 31, (4000, 3), dtype=np.int64)
    c[:1000] = rng.integers(-40, 2100, (1000, 3))
    step = np.array([1, 0, 0], np.int64)
    for log2_t in (10, 16, 19):
        T = 2 ** log2_t
        cfg = dataclasses.replace(hash_cfg(), log2_table_size=log2_t)
        ref = np.asarray(jhe._hash_levels(
            jnp.asarray((c & 0xFFFFFFFF).astype(np.uint32).T[:, None, :]),
            cfg))[0]
        rows = hash_kernel.hash_rows(torch.tensor(c), T).numpy()
        np.testing.assert_array_equal(rows, ref.astype(np.int64))
        even = c.copy()
        even[:, 0] &= ~1
        h0 = hash_kernel.hash_rows(torch.tensor(even), T)
        h1 = hash_kernel.hash_rows(torch.tensor(even + step), T)
        assert torch.equal(h1, h0 ^ 1)
        odd = even + step
        h2 = hash_kernel.hash_rows(torch.tensor(odd + step), T)
        assert bool(((hash_kernel.hash_rows(torch.tensor(odd), T) ^ h2)
                     > 1).any())


def test_occupancy_refresh_count_and_decay_match_jax():
    """One refresh of a grid with finite densities at a count and decay
    other than the defaults.  JAX ``update_from_field`` draws its cells and
    jitter from one key; the port gets the same draws, made as JAX
    ``update`` makes them (split, randint, uniform).  Densities within atol
    1e-5 (the same f32 field, sums in other orders) except at cells drawn
    twice (JAX keeps an unspecified candidate there, the port the largest);
    cells not drawn hold density * decay; a flat_idx of another length than
    num_cells is refused."""
    cfg = step_cfg(False)
    params = jax.tree.map(np.array, jtrainer.init_params(
        jax.random.PRNGKey(0), cfg))
    params["mlp"]["sig"][-1]["b"][0] += 1.0
    field = ckpt.from_jax_params(params, cfg)
    g, k, decay = 16, 300, 0.8
    rng = np.random.default_rng(8)
    dens = rng.uniform(0.0, 0.05, (g, g, g)).astype(np.float32)
    dens[rng.random((g, g, g)) < 0.5] = 100.0    # kept over the fresh value
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    cells = np.asarray(jax.random.randint(k1, (k,), 0, g ** 3))
    jit = np.asarray(jax.random.uniform(k2, (k, 3)))
    ref = jocc.update_from_field(
        jocc.OccupancyGrid(density=jnp.asarray(dens),
                           mask=jnp.ones((g, g, g)),
                           threshold=jnp.float32(0.01)),
        jax.tree.map(jnp.asarray, params), jrestore.scene_from_bounds(LO, HI),
        key, cfg, num_cells=k, decay=decay)
    grid = occupancy.OccupancyGrid(torch.tensor(dens), torch.ones(g, g, g),
                                   torch.tensor(0.01))
    scene = restore.scene_from_bounds(LO, HI)
    port = occupancy.update_from_field(
        grid, field, scene, cfg, num_cells=k, decay=decay,
        flat_idx=torch.tensor(cells, dtype=torch.long),
        jitter=torch.tensor(jit))
    idx, counts = np.unique(cells, return_counts=True)
    keep = np.ones(g ** 3, bool)
    keep[idx[counts > 1]] = False
    assert (counts > 1).sum() < k // 10
    got = port.density.numpy().reshape(-1)
    want = np.asarray(ref.density).reshape(-1)
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(port.mask.numpy().reshape(-1)[keep],
                                  np.asarray(ref.mask).reshape(-1)[keep])
    untouched = np.setdiff1d(np.arange(g ** 3), cells)
    np.testing.assert_allclose(got[untouched],
                               dens.reshape(-1)[untouched] * decay, rtol=1e-6)
    fresh = got[idx[counts == 1]] > dens.reshape(-1)[idx[counts == 1]] * decay
    assert fresh.any() and not fresh.all()
    with pytest.raises(ValueError, match="num_cells"):
        occupancy.update_from_field(
            grid, field, scene, cfg, num_cells=k,
            flat_idx=torch.tensor(cells[:-1], dtype=torch.long),
            jitter=torch.tensor(jit[:-1]))


# Table gradients: the same terms (w * g, or g) summed in other orders
# (XLA's scatter, index_add_); measured below 5e-7: rtol 1e-6, atol 1e-6.
@pytest.mark.parametrize("mode", ["exact", "stochastic"])
def test_table_gradients_match_jax(mode):
    cfg = hash_cfg(stochastic_train=mode == "stochastic")
    table, x, mu, sigma = inputs(cfg, seed=2)
    key = jax.random.PRNGKey(7)
    g = np.random.default_rng(3).normal(size=(N, 8)).astype(np.float32)
    if mode == "exact":
        fn = lambda tb: jhe.hash_encode(tb, jnp.asarray(x), jnp.asarray(mu),
                                        jnp.asarray(sigma), cfg)
    else:
        fn = lambda tb: jhe.hash_encode_stochastic(
            tb, jnp.asarray(x), jnp.asarray(mu), jnp.asarray(sigma), cfg, key)
    _, vjp = jax.vjp(fn, jnp.asarray(table))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    tp = t(table).requires_grad_(True)
    out = encode(tp, t(x), t(mu), t(sigma), cfg,
                 stochastic=mode == "stochastic", u=t(jax_u(cfg, key)))
    (out * t(g)).sum().backward()
    assert tp.grad.shape == ref.shape
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(tp.grad.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_encode_params_dense_plus_table():
    """One dense level (f32) before three hashed levels: the feature order
    and both gradients match JAX ``encode_params`` (atol 1e-5: the dense
    trilerp sums its corners in another order)."""
    cfg = hash_cfg(dense_levels=1, dense_bf16=False, dense_impl="xla")
    table, x, mu, sigma = inputs(cfg, seed=4)
    g0 = 18                           # floor(16) + 2
    grid = np.random.default_rng(5).uniform(
        -1, 1, (g0, g0, g0, 2)).astype(np.float32)
    assert jhe.level_scales(cfg)[0] == 16.0
    g = np.random.default_rng(6).normal(size=(N, 8)).astype(np.float32)

    def jfn(tb, gr):
        return jhe.encode_params({"table": tb, "dense": (gr,)}, jnp.asarray(x),
                                 jnp.asarray(mu), jnp.asarray(sigma), cfg)

    ref, vjp = jax.vjp(jfn, jnp.asarray(table), jnp.asarray(grid))
    d_table, d_grid = vjp(jnp.asarray(g))
    tp, gp = t(table).requires_grad_(True), t(grid).requires_grad_(True)
    out = hash_encoding.encode_params({"table": tp, "dense": [gp]}, t(x),
                                      t(mu), t(sigma), cfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)
    (out * t(g)).sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(d_table),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(gp.grad.numpy(), np.asarray(d_grid),
                               rtol=0, atol=1e-5)


def test_unported_hash_options_raise():
    cfg = hash_cfg()
    table, x, mu, sigma = inputs(cfg)
    for bad in (dict(variant="cell"), dict(packed=True, stochastic_train=True),
                dict(packed=True, packed_exact_train=True),
                dict(packed=True, grad_subsample=True),
                dict(scatter_strategy="sorted")):
        with pytest.raises(NotImplementedError, match="not ported"):
            hash_encoding.encode_params(
                {"table": t(table)}, t(x), t(mu), t(sigma),
                dataclasses.replace(cfg, **bad))
    with pytest.raises(ValueError):          # u of the wrong shape
        hash_kernel.hash_encode_kernel(t(table), t(x), t(mu), t(sigma), cfg,
                                       u=torch.zeros((3, 4, N - 1)))


def test_philox_known_answers_and_stream():
    """Random123's known-answer vectors for Philox4x32-10, and the stream
    layout: counter (i // 4, 0, 0, 0) under key (seed, 0) gives elements
    4i .. 4i+3."""
    m = 0xFFFFFFFF
    for ctr, key, want in (
            ((0, 0, 0, 0), (0, 0),
             (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
            ((m, m, m, m), (m, m),
             (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
            ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
             (0xa4093822, 0x299f31d0),
             (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))):
        got = rng_kernel.philox4x32_10(
            tuple(torch.tensor([c], dtype=torch.int64) for c in ctr),
            tuple(torch.tensor(k, dtype=torch.int64) for k in key))
        assert tuple(int(v) for v in got) == want
    seed = torch.tensor([12345], dtype=torch.int32)
    bits = rng_kernel.uniform_bits(seed, (3, 7))
    assert bits.dtype == torch.int32 and bits.shape == (3, 7)
    words = rng_kernel.philox4x32_10(
        (torch.tensor([5]), torch.tensor([0]), torch.tensor([0]),
         torch.tensor([0])), (12345, 0))
    flat = bits.reshape(-1).to(torch.int64) & m
    assert [int(flat[20])] == [int(words[0])]
    u = rng_kernel.uniform(seed, (3, 7))
    np.testing.assert_array_equal(
        u.numpy(), ((flat >> 8).to(torch.float32) * 2.0 ** -24).reshape(3, 7))


def test_philox_shapes_match_jax_interpret():
    """Shape and dtype of ``uniform_bits``/``uniform`` match the Pallas
    kernel's run in interpret mode (whose bits the interpreter stubs to
    zeros); the port's bits are int32 bit patterns of the uint32 words."""
    from human_body_reconstruction_tpu.ops import pallas_rng

    seed = torch.tensor([3], dtype=torch.int32)
    for shape in ((5, 300), (2, 3, 129)):
        jb = pallas_rng.uniform_bits(jnp.int32(3), shape, interpret=True)
        ju = pallas_rng.uniform(jnp.int32(3), shape, interpret=True)
        pb = rng_kernel.uniform_bits(seed, shape)
        pu = rng_kernel.uniform(seed, shape)
        assert tuple(pb.shape) == tuple(jb.shape) == shape
        assert tuple(pu.shape) == tuple(ju.shape) == shape
        assert jb.dtype == jnp.uint32 and pb.dtype == torch.int32
        assert ju.dtype == jnp.float32 and pu.dtype == torch.float32
        assert 0.0 <= float(pu.min()) and float(pu.max()) < 1.0


# Distribution of 2^20 draws.  Mean of U[0, 1): sd 1/sqrt(12 n) = 2.8e-4,
# bound 6 sd.  256-bin chi^2 (255 degrees of freedom): mean 255, sd 22.6,
# bound 255 + 6 sd = 390.  Lag-1 correlation: sd 1/sqrt(n) = 9.8e-4, bound
# 6 sd.  Two seeds: their streams share no more than 2^-32 * n expected
# equal words; bound 4.
def test_philox_distribution():
    n = 1 << 20
    u = rng_kernel.uniform(torch.tensor([2024], dtype=torch.int32),
                           (n,)).double()
    assert abs(float(u.mean()) - 0.5) < 6 / np.sqrt(12 * n)
    counts = torch.bincount((u * 256).long(), minlength=256).double()
    chi2 = float(((counts - n / 256) ** 2 / (n / 256)).sum())
    assert chi2 < 255 + 6 * np.sqrt(2 * 255)
    c = u - u.mean()
    lag1 = float((c[1:] * c[:-1]).mean() / (c * c).mean())
    assert abs(lag1) < 6 / np.sqrt(n)
    a = rng_kernel.uniform_bits(torch.tensor([1], dtype=torch.int32), (n,))
    b = rng_kernel.uniform_bits(torch.tensor([2], dtype=torch.int32), (n,))
    assert int((a == b).sum()) <= 4


def test_stoch_uniform_draws_from_the_generator():
    """With hw_rng the seed is drawn from the caller's generator (randint
    below 2^31 - 1) and the Philox stream follows from it; without, the
    uniforms are torch.rand from the same generator."""
    cfg = hash_cfg(stochastic_train=True, hw_rng=True)
    shape = (3, 4, 50)
    got = hash_encoding.stoch_uniform(shape, cfg, "cpu",
                                      torch.Generator().manual_seed(9))
    seed = torch.randint(0, 2 ** 31 - 1, (1,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(9))
    assert torch.equal(got, rng_kernel.uniform(seed, shape))
    plain = hash_encoding.stoch_uniform(
        shape, dataclasses.replace(cfg, hw_rng=False), "cpu",
        torch.Generator().manual_seed(9))
    assert torch.equal(plain,
                       torch.rand(shape, generator=torch.Generator().manual_seed(9)))


# ---------------------------------------------------------------- one step

def step_cfg(stochastic: bool) -> C.PipelineConfig:
    return C.PipelineConfig(
        hash=hash_cfg(stochastic_train=stochastic, init_scale=1.0),
        mlp=C.MLPConfig(width=16), render=C.RenderConfig(num_samples=16),
        train=C.TrainConfig(ray_batch=B, compute_dtype="float32"))


def small_dataset(n=3, hw=8):
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(n, hw, hw, 3)).astype(np.float32)
    c2ws = orbit_poses(n, radius=4.0, elevation=0.35)
    K = np.array([[10.0, 0, hw / 2], [0, 10.0, hw / 2], [0, 0, 1]], np.float32)
    return images, c2ws, K


# One f32 step (f32 MLP): the same function, sums in other orders:
# loss rtol 1e-5, gradients per group ||port - jax|| / ||jax|| <= 1e-5.
@pytest.mark.parametrize("stochastic", [False, True], ids=["exact", "stoch"])
def test_step_loss_and_grads_match_jax(stochastic):
    cfg = step_cfg(stochastic)
    params = jax.tree.map(np.array, jtrainer.init_params(
        jax.random.PRNGKey(0), cfg))
    assert np.abs(params["table"]).max() > 0.9        # lifted to U(-1, 1)
    params["mlp"]["sig"][-1]["b"][0] += 1.0
    field = ckpt.from_jax_params(params, cfg)
    images, c2ws, K = small_dataset()
    bkey = jax.random.PRNGKey(2)
    k1, k2 = jax.random.split(bkey)
    img = np.asarray(jax.random.randint(k1, (B,), 0, images.shape[0]))
    pix = np.asarray(jax.random.randint(k2, (B,), 0, 64))
    batch = jstep.sample_ray_batch(bkey, jnp.asarray(images),
                                   jnp.asarray(c2ws), jnp.asarray(K), B)
    key = jax.random.PRNGKey(3)
    k_strat, _, k_enc, _ = jax.random.split(key, 4)
    S, L = cfg.render.num_samples, cfg.hash.num_hashed_levels
    draws = {"u": t(jax.random.uniform(k_strat, (B, S))),
             "enc_u": t(jax.random.uniform(k_enc, (3, L, B * S)))}
    (loss_j, _), grads_j = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), jrestore.scene_from_bounds(LO, HI),
        batch, key, cfg, None, None, step=0)
    tbatch = step.sample_ray_batch(t(images), t(c2ws), t(K), B,
                                   img_idx=t(img), pix_idx=t(pix))
    loss_p, _ = step.loss_fn(field, restore.scene_from_bounds(LO, HI), tbatch,
                             cfg, None, None, step=0, draws=draws)
    loss_p.backward()
    assert float(loss_p.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    gj = {"table": np.asarray(grads_j["table"]).reshape(-1),
          "mlp": np.concatenate([np.asarray(g).reshape(-1)
                                 for branch in ("sig", "col")
                                 for layer in grads_j["mlp"][branch]
                                 for g in (np.asarray(layer["w"]).T,
                                           layer["b"])])}
    gp = {"table": field.table.grad.numpy().reshape(-1),
          "mlp": np.concatenate([p.grad.numpy().reshape(-1)
                                 for p in field.mlp.parameters()])}
    for k in gj:
        rel = np.linalg.norm(gp[k] - gj[k]) / np.linalg.norm(gj[k])
        assert rel <= 1e-5, (k, rel)


# --------------------------------------------------------- run directories

def camera(hw=12):
    f = hw / (2.0 * np.tan(0.6911112 / 2.0))
    return (np.array([[f, 0, hw / 2.0], [0, f, hw / 2.0], [0, 0, 1]],
                     np.float32), orbit_poses(4)[1])


def jax_render(jres, K, c2w, hw=12):
    return np.asarray(jstep.render_image_fused(
        jres.params, jres.scene, hw, hw, jnp.asarray(K), jnp.asarray(c2w),
        jres.cfg, num_samples=16, chunk=48))


# A port CLI run (20 steps, --stochastic --hw_rng, plain Philox on the CPU)
# restored and rendered exact by both packages, in f32: the same function,
# sums in other orders: atol 1e-4 on pixel values.
def test_cli_stochastic_run_restores_in_jax(tmp_path):
    d = str(tmp_path)
    tr = train_hash.main([
        "--synthetic", "--stochastic", "--hw_rng", "--num_levels", "4",
        "--hash_size", "10", "--max_res", "64", "--num_batch", "128",
        "--num_samples", "16", "--steps", "20", "--log_every", "10",
        "--device", "cpu", "--out_dir", d, "--model_name", "h"])
    cfg = tr.cfg
    assert (cfg.hash.variant, cfg.hash.stochastic_train, cfg.hash.hw_rng,
            cfg.render.occupancy) == ("corner", True, True, False)
    assert tr.state.step == 20 and len(tr.history) == 2
    assert all(np.isfinite(r["loss"]) for r in tr.history)
    jres = jrestore.restore(d, "h", log_fn=lambda s: None)
    pres = restore.restore(d, "h", device="cpu", log_fn=lambda s: None)
    assert dataclasses.asdict(jres.cfg) == dataclasses.asdict(pres.cfg)
    for a, b in zip(jax.tree_util.tree_leaves(jres.params),
                    ckpt.jax_leaves(pres.field)):
        np.testing.assert_array_equal(np.asarray(a), b)
    K, c2w = camera()
    img = step.render_image(pres.field, pres.scene, 12, 12, t(K), t(c2w),
                            pres.cfg, num_samples=16).numpy()
    ref = jax_render(jres, K, c2w)
    assert np.isfinite(img).all() and np.abs(img).max() > 1e-3
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-4)


def test_jax_corner_run_serves_in_port(tmp_path):
    """A run directory written by the JAX package (corner table, dense
    level, stochastic training config) restores in the port's server and
    serves a frame on the exact path that JAX renders alike (f32, atol
    1e-4)."""
    d = str(tmp_path)
    cfg = C.PipelineConfig(
        hash=hash_cfg(stochastic_train=True, hw_rng=True, dense_levels=1,
                      dense_bf16=False, dense_impl="xla", init_scale=0.5),
        mlp=C.MLPConfig(width=16))
    params = jax.tree.map(np.array, jtrainer.init_params(
        jax.random.PRNGKey(1), cfg))
    params["mlp"]["sig"][-1]["b"][0] += 2.0
    jckpt.save_pytree(os.path.join(d, "j_ckpt.npz"), params)
    C.to_json(cfg, os.path.join(d, "j_config.json"))
    jckpt.save_bounds(os.path.join(d, "bounds_model.npy"), LO, HI)
    server = serve.RenderServer(serve.build_parser().parse_args([
        "--ckpt_dir", d, "--model_name", "j", "--height", "12", "--width",
        "12", "--num_samples", "16", "--fp32", "--device", "cpu"]))
    assert server.field.table is not None and len(server.field.dense) == 1
    resp = server.handle({"orbit": {"index": 1, "count": 4},
                          "no_image": True})
    assert resp["ok"], resp
    K, c2w = camera()
    img = step.render_image(server.field, server.scene, 12, 12, t(K), t(c2w),
                            server.base_cfg, num_samples=16).numpy()
    jres = jrestore.restore(d, "j", log_fn=lambda s: None)
    np.testing.assert_allclose(img, jax_render(jres, K, c2w), rtol=0,
                               atol=1e-4)
