"""The held-back tangle scene of the port (``data/synthetic.tangle_field``
and ``utils/jax_prng.normal``) against the JAX package on the CPU.

Tolerances: ``jax_prng.normal`` takes XLA's f32 erfinv polynomial with
numpy's log1p, measured at most 3 f32 ulps from ``jax.random.normal`` over
50,000 draws for seeds 0 and 101: 4 ulps.  The tangle's parameters drawn
by ``uniform`` alone (start points, lengths, radii, frequencies, phases,
stretches) are bit for bit; the directions come through ``normal``, so the
end points are held to 1e-6.  The field's density is a sum of sigmoids of
sharpness 200 over 14 capsules, which turns the distance's f32 sum-order
differences into density differences of up to 1.5e-4 at densities near 90
(1.7e-5 relative; measured on 20,000 points for each seed): rtol and atol
1e-4 on sigma; rgb (sines of the same f32 products) measured 1.2e-7:
1e-5.  A ground-truth render composites 32 of them a
ray: atol 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu.data import synthetic as jsyn
from human_body_reconstruction_tpu_torch.data import synthetic
from human_body_reconstruction_tpu_torch.utils import jax_prng
from torch_threads import one_torch_thread  # noqa: F401

SEEDS = (0, 101)


@pytest.mark.parametrize("seed", SEEDS)
def test_jax_prng_normal_matches_jax(seed):
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (50000,)))
    got = jax_prng.normal(jax_prng.prng_key(seed), (50000,))
    assert got.dtype == np.float32 and got.shape == ref.shape
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - ref.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4 and np.mean(ulps == 0) > 0.95
    key = jax.random.split(jax.random.PRNGKey(seed), 5)[1]
    np.testing.assert_array_equal(
        jax_prng.split(jax_prng.prng_key(seed), 5)[1], np.asarray(key))


def test_jax_prng_erfinv_edges():
    """+-1 give +-inf, 0 gives 0, and the polynomial is odd."""
    x = np.array([-1.0, 0.0, 1.0, 0.3, -0.3], np.float32)
    got = jax_prng.erfinv(x)
    assert np.isneginf(got[0]) and got[1] == 0.0 and np.isposinf(got[2])
    assert got[3] == -got[4] and got[3] == pytest.approx(0.27246271, rel=1e-6)


def jax_tangle_draws(seed, monkeypatch):
    """The JAX ``tangle_field``'s random draws, in its order: a, the
    directions, the lengths, radii, raw frequencies, phases, stretches."""
    draws = []
    uniform, normal = jax.random.uniform, jax.random.normal

    def rec(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            draws.append(np.asarray(out))
            return out
        return wrapped

    monkeypatch.setattr(jax.random, "uniform", rec(uniform))
    monkeypatch.setattr(jax.random, "normal", rec(normal))
    jsyn.tangle_field(jnp.zeros((4, 3), jnp.float32), seed=seed)
    monkeypatch.undo()
    return draws


@pytest.mark.parametrize("seed", SEEDS)
def test_tangle_params_match_jax(seed, monkeypatch):
    a, step, ln, radii, f_raw, ph, sx = jax_tangle_draws(seed, monkeypatch)
    p = synthetic.tangle_params(seed)
    for got, ref in ((p["a"], a), (p["radii"], radii), (p["ph"], ph),
                     (p["sx"], sx)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    f = np.asarray(jnp.asarray(f_raw) * 24.0 * jnp.asarray(
        [[1.0, 2.3], [1.7, 3.1], [1.3, 2.7]]))
    np.testing.assert_array_equal(p["f"], f)
    step = step / (np.linalg.norm(step, axis=-1, keepdims=True) + 1e-9)
    b = np.clip(a + step * ln, -0.8, 0.8)
    np.testing.assert_allclose(p["b"], b, rtol=0, atol=1e-6)
    # the capsules sit in the ~0.85 ball, thin, and differ by seed
    assert np.abs(p["b"]).max() <= 0.8 and 0.03 <= radii.min() < 0.07
    assert not np.array_equal(p["a"], synthetic.tangle_params(seed + 1)["a"])


@pytest.mark.parametrize("seed", SEEDS)
def test_tangle_field_matches_jax(seed):
    pts = np.random.default_rng(seed).uniform(-1.0, 1.0, (20000, 3)).astype(
        np.float32)
    rgb, sigma = synthetic.tangle_field(torch.tensor(pts), seed=seed)
    jrgb, jsigma = jsyn.tangle_field(jnp.asarray(pts), seed=seed)
    assert float(sigma.max()) > 10.0 and float(rgb.std()) > 0.05
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=1e-4,
                               atol=1e-4)


def test_tangle_ground_truth_view_matches_jax():
    """One 16x16 view of seed 101 at 32 samples a ray, through each
    package's ``render_gt_image``."""
    K = np.array([[17.6, 0, 8], [0, 17.6, 8], [0, 0, 1]], np.float32)
    pose = synthetic.orbit_poses(21, radius=4.0, elevation=0.35)[3]
    ref = jsyn.render_gt_image(16, 16, jnp.asarray(K), pose,
                               field=functools.partial(jsyn.tangle_field,
                                                       seed=101),
                               num_samples=32)
    got = synthetic.render_gt_image(
        16, 16, torch.tensor(K), torch.tensor(pose),
        field=functools.partial(synthetic.tangle_field, seed=101),
        num_samples=32)
    assert got.shape == (16, 16, 3) and float(got.std()) > 0.01
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
