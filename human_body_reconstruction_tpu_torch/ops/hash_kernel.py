"""Hash-grid encoder (the reference's "corner" variant): the CUDA kernels and
their plain versions.

Counterpart of the JAX ops/hash_encoding.py ``_level_coords``,
``_hash_levels``, ``hash_encode`` (exact, 8 corners) and
``hash_encode_stochastic`` (one corner picked by uniforms u), with their
autodiff scatters as the backward.  The kernels are ``hbr_hash_forward`` and
``hbr_hash_backward`` in csrc/hash.cu, a port's own: the JAX package gathers
in plain jnp, and the note there says what bounds them on Hopper.  Both
versions compute hash_encode's numerics step for step:

  xn    = (x - mu) / sigma,  xl = xn * f32(scale_l),  x0 = floor(xl),
  frac  = xl - x0                                    (no clipping)
  row   = ((c0 * 1) ^ (c1 * 2654435761) ^ (c2 * 805459861)) mod 2^32 & (T-1)
          for the corner's coordinates c_d = x0_d + bit_d as uint32 (a
          negative cell wraps, as the JAX uint32 cast does)
  exact: out = sum over c = 0..7 of table[l, row_c, f] * ((w_0 * w_1) * w_2),
         bit d of corner c is (c >> d) & 1, w_d = frac_d or 1 - frac_d
  stochastic: bit_d = u[d, l, n] < frac_d; out = table[l, row, f]

and the table gradient adds w * g (exact) or g (stochastic) at each row.
In the plain version the coordinates are int64 holding uint32 values, and a
product by a prime is taken as two 16-bit halves so that it never overflows
int64; only its low 32 bits matter.  Positions get no gradient.
``hash_encode_kernel`` and ``hash_encode_backward_kernel`` are the wrappers:
for tensors on the CPU they run ``hash_encode_plain`` and
``hash_encode_plain_backward``; for tensors on a CUDA device they launch the
kernel or raise.  The stochastic forward also returns the picked corners'
offset bits, a uint8 (L, N) array with bit d of ``bits[l, n]`` set when
``u[d, l, n] < frac_d``; the stochastic backward reads those bits (16 MB at
the hash path's 1,024,000 points) instead of u (197 MB), so the autograd
Function keeps the bits and lets u go after the forward.
"""

from __future__ import annotations

import torch

from human_body_reconstruction_tpu_torch.ops import cuda_lib
from human_body_reconstruction_tpu_torch.ops.dense_grid import normalise
from human_body_reconstruction_tpu_torch.utils.config import HashConfig, fine_scales

# Instant-NGP spatial-hash primes (JAX ops/hash_encoding.py PRIMES).
PRIMES = (1, 2654435761, 805459861)
MASK32 = 0xFFFFFFFF
# The kernels are built for 1 to 8 features a level (csrc/levels.cuh
# with_features); a forward block stages 128 points x (L*F + 1) f32 rows,
# at most 66 KB at 16 levels of 8.
MAX_FEATURES = 8


def _mul_u32(c, p: int):
    """(c * p) mod 2^32 for int64 c in [0, 2^32) and a 32-bit prime p."""
    return ((c & 0xFFFF) * p + ((((c >> 16) * p) & 0xFFFF) << 16)) & MASK32


def hash_rows(coords, table_size: int):
    """(..., 3) int64 corner coordinates -> (...,) int64 row in [0, T)."""
    c = coords & MASK32
    h = _mul_u32(c[..., 0], PRIMES[0])
    for d in (1, 2):
        h = h ^ _mul_u32(c[..., d], PRIMES[d])
    return h & (table_size - 1)


def level_coords(xn, scale: float):
    """Normalised points (N, 3) -> (cell x0 (N, 3) int64, frac (N, 3) f32)
    of one level."""
    xl = xn * scale
    x0f = torch.floor(xl)
    return x0f.long(), xl - x0f


def _corner_weight(frac, off):
    """((w_0 * w_1) * w_2) of the corner with offset bits ``off``."""
    w = [frac[:, d] if off[d] else 1.0 - frac[:, d] for d in range(3)]
    return (w[0] * w[1]) * w[2]


_OFFSETS = [tuple((c >> d) & 1 for d in range(3)) for c in range(8)]


def _level_terms(xn, cfg: HashConfig, u=None, bits=None):
    """Per level: ([(flat row index into (L*T) (N,), weight (N,) or None)],
    picked offset bits (N,) int64 or None): one term per corner (exact) or
    the picked corner's (stochastic: from ``bits`` (L, N) when given, else
    from u (3, L, N))."""
    T = cfg.table_size
    out = []
    for l, scale in enumerate(fine_scales(cfg)):
        x0, frac = level_coords(xn, float(scale))
        if u is None and bits is None:
            terms = []
            for off in _OFFSETS:
                rows = hash_rows(x0 + torch.tensor(off, device=xn.device), T)
                terms.append((rows + l * T, _corner_weight(frac, off)))
            out.append((terms, None))
            continue
        if bits is None:
            up = (u[:, l, :].t() < frac).long()                 # (N, 3)
            picked = up[:, 0] | (up[:, 1] << 1) | (up[:, 2] << 2)
        else:
            picked = bits[l].long()
            up = torch.stack([(picked >> d) & 1 for d in range(3)], dim=-1)
        out.append(([(hash_rows(x0 + up, T) + l * T, None)], picked))
    return out


def hash_encode_plain(table, x, mu, sigma, cfg: HashConfig, u=None):
    """(N, 3) world points -> (N, L*F) f32 features of the hashed levels
    (exact), or, given u (3, L, N), (features, the picked corners' offset
    bits, uint8 (L, N)) (stochastic)."""
    L, T, F = table.shape
    flat = table.reshape(L * T, F).to(torch.float32)
    cols, picked = [], []
    for terms, bits in _level_terms(normalise(x, mu, sigma), cfg, u):
        if u is not None:
            cols.append(flat[terms[0][0]])
            picked.append(bits)
            continue
        acc = torch.zeros((x.shape[0], F), dtype=torch.float32,
                          device=x.device)
        for rows, w in terms:
            acc = acc + flat[rows] * w[:, None]
        cols.append(acc)
    feats = torch.cat(cols, dim=-1)
    if u is None:
        return feats
    return feats, torch.stack(picked).to(torch.uint8)


def hash_encode_plain_backward(table, x, mu, sigma, cfg: HashConfig, grad,
                               u=None, bits=None):
    """Gradient of ``hash_encode_plain`` w.r.t. the table, given the
    gradient ``grad`` (N, L*F) of its output; stochastic given the picked
    corners' ``bits`` (L, N) or the uniforms u they came from.  Returns an
    f32 (L, T, F) tensor.  The table's values are not read (the encoding is
    linear in them); only its shape is."""
    L, T, F = table.shape
    dflat = torch.zeros((L * T, F), dtype=torch.float32, device=x.device)
    for l, (terms, _) in enumerate(_level_terms(normalise(x, mu, sigma), cfg,
                                                u, bits)):
        gl = grad[:, l * F:(l + 1) * F]
        for rows, w in terms:
            dflat.index_add_(0, rows, gl if w is None else gl * w[:, None])
    return dflat.reshape(L, T, F)


def _check_args(table, x, cfg: HashConfig, u=None, bits=None):
    """Shapes and devices the kernels rely on; returns (n, L*F)."""
    want = (cfg.num_hashed_levels, cfg.table_size, cfg.features_per_level)
    if cfg.dim != 3 or tuple(table.shape) != want:
        raise ValueError(f"the table must be {want} (3-D points), got "
                         f"{tuple(table.shape)}")
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {tuple(x.shape)}")
    if table.device != x.device or table.dtype != torch.float32:
        raise ValueError(f"the table must be float32 on the points' device, "
                         f"got {table.dtype} on {table.device}")
    n, c = x.shape[0], want[0] * want[2]
    for name, v, dtype, shape in (("u", u, torch.float32, (3, want[0], n)),
                                  ("bits", bits, torch.uint8, (want[0], n))):
        if v is not None and (tuple(v.shape) != shape or v.device != x.device
                              or v.dtype != dtype):
            raise ValueError(f"{name} must be {dtype} {shape} on the points' "
                             f"device, got {v.dtype} {tuple(v.shape)} on "
                             f"{v.device}")
    if want[0] > cuda_lib.MAX_LEVELS or want[2] > MAX_FEATURES:
        raise ValueError(f"{want[0]} hashed levels of {want[2]} features; the "
                         f"kernels take at most {cuda_lib.MAX_LEVELS} levels "
                         f"and {MAX_FEATURES} features")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hash encoder kernels: unsupported device {x.device}")
    return n, c


def _launch_args(table, x, mu, sigma, cfg: HashConfig):
    """(table from a 16-byte aligned address, points, mu (3,), sigma (3,),
    level struct) for a launch: f32, contiguous, on the points' device (no
    host synchronisation)."""
    def vec3(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=x.device).expand(3).contiguous()

    T = cfg.table_size
    L = cfg.num_hashed_levels
    lv = cuda_lib.make_levels([T] * L, [l * T for l in range(L)],
                              fine_scales(cfg))
    tc = table.detach().contiguous()
    if tc.data_ptr() % 16:
        tc = tc.clone()
    return tc, x.to(torch.float32).contiguous(), vec3(mu), vec3(sigma), lv


def hash_encode_kernel(table, x, mu, sigma, cfg: HashConfig, u=None,
                       out=None):
    """Forward wrapper: CPU tensors -> ``hash_encode_plain``; CUDA tensors ->
    ``hbr_hash_forward``.  ``out`` (optional) is an (N, L*F) f32 view with
    unit column stride to write into (a column block of the encoder's
    feature matrix).  Returns the features (exact), or, given u (3, L, N),
    (features, the picked corners' offset bits, uint8 (L, N))
    (stochastic)."""
    n, c = _check_args(table, x, cfg, u=u)
    if out is not None:
        cuda_lib.check_out(out, n, c, x.device)
    if x.device.type == "cpu":
        res = hash_encode_plain(table, x, mu, sigma, cfg, u)
        feats, bits = (res, None) if u is None else res
        if out is not None:
            feats = out.copy_(feats)
        return feats if u is None else (feats, bits)
    if out is None:
        out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    bits = (None if u is None else
            torch.empty((cfg.num_hashed_levels, n), dtype=torch.uint8,
                        device=x.device))
    if n > 0:
        tc, xc, mu3, sigma3, lv = _launch_args(table, x, mu, sigma, cfg)
        uc = None if u is None else u.contiguous()
        code = cuda_lib.library().hbr_hash_forward(
            xc.data_ptr(), mu3.data_ptr(), sigma3.data_ptr(), tc.data_ptr(),
            None if uc is None else uc.data_ptr(), n, cfg.table_size,
            cfg.features_per_level, lv, out.data_ptr(), out.stride(0),
            None if bits is None else bits.data_ptr(),
            cuda_lib.stream_handle(x.device))
        hash_encode_kernel.launches += 1
        cuda_lib.check(code, "hbr_hash_forward")
    return out if u is None else (out, bits)


def hash_encode_backward_kernel(table, x, mu, sigma, cfg: HashConfig, grad,
                                bits=None):
    """Backward wrapper: the table gradient given ``grad``, the (N, L*F) f32
    gradient of the features (any row stride, unit column stride: a column
    block of the encoder's gradient), exact, or stochastic given the picked
    corners' ``bits`` (L, N) from the forward.  CPU tensors ->
    ``hash_encode_plain_backward``; CUDA tensors -> ``hbr_hash_backward``.
    Returns an f32 (L, T, F) tensor."""
    n, c = _check_args(table, x, cfg, bits=bits)
    cuda_lib.check_out(grad, n, c, x.device, name="grad")
    if x.device.type == "cpu":
        return hash_encode_plain_backward(table, x, mu, sigma, cfg, grad,
                                          bits=bits)
    dtable = torch.zeros(tuple(table.shape), dtype=torch.float32,
                         device=x.device)
    if n > 0:
        _, xc, mu3, sigma3, lv = _launch_args(table, x, mu, sigma, cfg)
        bc = None if bits is None else bits.contiguous()
        code = cuda_lib.library().hbr_hash_backward(
            xc.data_ptr(), mu3.data_ptr(), sigma3.data_ptr(),
            None if bc is None else bc.data_ptr(), grad.data_ptr(),
            grad.stride(0), n, cfg.table_size, cfg.features_per_level, lv,
            dtable.data_ptr(),
            cuda_lib.stream_handle(x.device))
        hash_encode_backward_kernel.launches += 1
        cuda_lib.check(code, "hbr_hash_backward")
    return dtable


hash_encode_kernel.launches = 0
hash_encode_backward_kernel.launches = 0
