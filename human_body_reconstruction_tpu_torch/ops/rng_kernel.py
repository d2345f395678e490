"""Uniform random numbers for the stochastic hash encoder: the CUDA kernel
and its plain version (counterpart of the JAX ops/pallas_rng.py).

The Pallas ``_rng_kernel`` draws uint32 bits from the TPU's hardware
generator, seeded per (seed, block).  Its counterpart ``hbr_uniform_bits``
(csrc/rng.cu, whose note says what bounds it) computes Philox4x32-10 keyed by
(seed, 0), with the 128-bit counter (i // 4, 0, 0) giving output elements
4i .. 4i+3 in order: the stream depends on the seed and the number of
elements only.  ``philox4x32_10`` is the same generator in plain PyTorch:
int64 tensors holding uint32 values, each 32 x 32-bit product taken in 16-bit
halves so that nothing overflows int64, masked to 32 bits.

``uniform_bits(seed, shape)`` gives the bits as ``torch.int32`` bit
patterns (torch's ``uint32`` lacks most operators); ``uniform(seed, shape)``
gives f32 in [0, 1) as ``(bits >> 8) * 2^-24`` (pallas_rng.py:66-70), exact in
f32.  ``seed`` is a one-element int32 tensor on the tensors' device: the
kernel reads it through a pointer, as the Pallas kernel reads ``seed_ref``
from SMEM, so a seed drawn on the device each step costs no host
synchronisation.  Both go through ``uniform_kernel``, the wrapper: for a seed
on the CPU it runs the plain version; for a seed on a CUDA device it
launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from human_body_reconstruction_tpu_torch.ops import cuda_lib

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit halves of a * m for int64 tensors a in [0, 2^32) and a
    32-bit constant m, from 16-bit partial products (each below 2^32)."""
    a0, a1 = a & 0xFFFF, a >> 16
    m0, m1 = m & 0xFFFF, m >> 16
    p00 = a0 * m0
    mid = a0 * m1 + a1 * m0 + (p00 >> 16)
    lo = ((mid & 0xFFFF) << 16) | (p00 & 0xFFFF)
    return a1 * m1 + (mid >> 16), lo


def philox4x32_10(ctr, key):
    """Philox4x32-10 of counters ``ctr`` (four int64 tensors or ints holding
    uint32 words) under ``key`` (two of them).  Returns the four output
    words, int64 in [0, 2^32)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _stream64(seed, n: int):
    """The first n words of the stream of ``seed``, int64 on its device."""
    idx = torch.arange((n + 3) // 4, dtype=torch.int64, device=seed.device)
    zero = torch.zeros_like(idx)
    key = (seed.reshape(()).to(torch.int64) & MASK32, 0)
    words = philox4x32_10((idx & MASK32, idx >> 32, zero, zero), key)
    return torch.stack(words, dim=-1).reshape(-1)[:n]


def uniform_plain(seed, shape, as_float: bool = True):
    """The kernel's output in plain PyTorch: f32 in [0, 1), or (``as_float``
    False) the uint32 bits as int32 bit patterns."""
    shape = tuple(int(d) for d in shape)
    bits = _stream64(seed, math.prod(shape))
    if as_float:
        return ((bits >> 8).to(torch.float32) * 2.0 ** -24).reshape(shape)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(
        torch.int32).reshape(shape)


def uniform_kernel(seed, shape, as_float: bool = True):
    """Wrapper: a CPU seed -> ``uniform_plain``; a CUDA seed ->
    ``hbr_uniform_bits``.  The seed is checked before either runs."""
    if seed.dtype != torch.int32 or seed.numel() != 1:
        raise ValueError(f"seed must be one int32 element, got {seed.dtype} "
                         f"of shape {tuple(seed.shape)}")
    if seed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"Philox kernel: unsupported device {seed.device}")
    if seed.device.type == "cpu":
        return uniform_plain(seed, shape, as_float)
    out = torch.empty(tuple(int(d) for d in shape),
                      dtype=torch.float32 if as_float else torch.int32,
                      device=seed.device)
    if out.numel() == 0:
        return out
    code = cuda_lib.library().hbr_uniform_bits(
        seed.contiguous().data_ptr(), out.numel(), int(as_float),
        out.data_ptr(), cuda_lib.stream_handle(seed.device))
    uniform_kernel.launches += 1
    cuda_lib.check(code, "hbr_uniform_bits")
    return out


uniform_kernel.launches = 0


def uniform_bits(seed, shape):
    """uint32 random bits of ``shape``, as int32 bit patterns."""
    return uniform_kernel(seed, shape, as_float=False)


def uniform(seed, shape):
    """f32 uniforms in [0, 1) of ``shape``."""
    return uniform_kernel(seed, shape, as_float=True)
