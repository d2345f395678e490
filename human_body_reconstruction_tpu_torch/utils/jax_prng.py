"""The JAX package's random draws, in numpy: ``jax.random.PRNGKey``,
``split`` and ``uniform`` (float32) under the threefry2x32 generator in its
partitionable form (``jax_threefry_partitionable``, JAX's default), so that
an entry point of the port can start from the very parameters the JAX CLI
starts from (``models/mlp.init_classic_nerf``, ``init_mlp2d``).

A key is a uint32 (2,) array.  ``split(key, n)[i]`` and the i-th 32 random
bits of a draw of n values are both the threefry2x32 hash of the counter (0,
i) under the key, the bits being the two output words xor-ed.  ``uniform``
puts the top 23 bits in the mantissa of a float in [1, 2), subtracts 1,
scales to [minval, maxval) and clamps below at minval, in float32, as
``jax.random.uniform`` does on the CPU (bit for bit there).
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
