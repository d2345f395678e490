"""The JAX package's random draws, in numpy: ``jax.random.PRNGKey``,
``split``, ``uniform`` and ``normal`` (float32) under the threefry2x32
generator in its partitionable form (``jax_threefry_partitionable``, JAX's
default), so that an entry point of the port can start from the very
parameters the JAX CLI starts from (``models/mlp.init_classic_nerf``,
``init_mlp2d``) and draw what JAX draws (``data/synthetic.tangle_params``).

A key is a uint32 (2,) array.  ``split(key, n)[i]`` and the i-th 32 random
bits of a draw of n values are both the threefry2x32 hash of the counter (0,
i) under the key, the bits being the two output words xor-ed.  ``uniform``
puts the top 23 bits in the mantissa of a float in [1, 2), subtracts 1,
scales to [minval, maxval) and clamps below at minval, in float32, as
``jax.random.uniform`` does on the CPU (bit for bit there).  ``normal`` is
JAX's ``_normal_real``: sqrt(2) * erfinv(u) for u uniform on
[nextafter(-1, 0), 1), with erfinv the f32 polynomial that XLA lowers
``erf_inv`` to (Giles' two branches, evaluated with fused multiply-adds);
its log1p is numpy's, so a value may differ from JAX's on the CPU by a few
f32 ulps (at most 3 measured for seeds 0 and 101).
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^32)."""
    return np.array([0, seed], np.uint32)


def _rotl(v, r: int):
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The threefry2x32 hash (20 rounds) of the counters (x0, x1) under
    ``key``; uint32 arrays of x0's shape."""
    with np.errstate(over="ignore"):
        ks = [np.uint32(key[0]), np.uint32(key[1])]
        ks.append(ks[0] ^ ks[1] ^ np.uint32(0x1BD11BDA))
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    b0, b1 = threefry2x32(key, np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([b0, b1], axis=-1)


def random_bits(key, shape) -> np.ndarray:
    """32 random bits for each element of ``shape``."""
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2 ** 32:
        raise ValueError(f"{n} values exceed the 32-bit counter")
    b0, b1 = threefry2x32(key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    # floats * (hi - lo) + lo rounded once, as XLA's fused multiply-add on
    # the CPU does it: the f32 product is exact in float64
    scaled = (floats.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


# XLA's f32 ErfInv: Giles' polynomials in w = -log1p(-x^2), one for w < 5
# (in w - 2.5) and one beyond (in sqrt(w) - 3)
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erfinv(x) -> np.ndarray:
    """The inverse error function of float32 ``x`` in (-1, 1), as XLA
    computes it in f32; +-inf at +-1."""
    f32 = np.float32
    x = np.asarray(x, f32)
    with np.errstate(divide="ignore"):
        w = -np.log1p(x * -x)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0))
    p = np.where(lt, f32(_ERFINV_W_LT_5[0]), f32(_ERFINV_W_GE_5[0]))
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        c = np.where(lt, f32(a), f32(b))
        # p * w + c as a fused multiply-add: the f32 product is exact in
        # float64, the sum rounds once there and again to f32
        p = (p.astype(np.float64) * w.astype(np.float64)
             + c.astype(np.float64)).astype(f32)
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == f32(1.0), x * f32(np.inf), p * x)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, jnp.float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2.0)) * erfinv(u)).astype(np.float32)
