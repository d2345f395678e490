"""Hash-grid encoder (the reference's "corner" variant): the CUDA kernels and
their plain versions.

Counterpart of the JAX ops/hash_encoding.py ``_level_coords``,
``_hash_levels``, ``hash_encode`` (exact, 8 corners) and
``hash_encode_stochastic`` (one corner picked by uniforms u), with their
autodiff scatters as the backward, for 3-D points, and exact for the 2-D
points of the image fit (``cfg.dim`` 2: 4 corners, ``PRIMES[:2]``).  The
kernels are ``hbr_hash_forward`` and ``hbr_hash_backward`` in
csrc/hash.cu, a port's own: the JAX package gathers in plain jnp, and the
note there says what bounds them on Hopper.  Both
versions compute hash_encode's numerics step for step:

  xn    = (x - mu) / sigma,  xl = xn * f32(scale_l),  x0 = floor(xl),
  frac  = xl - x0                                    (no clipping)
  row   = ((c0 * 1) ^ (c1 * 2654435761) ^ (c2 * 805459861)) mod 2^32 & (T-1)
          for the corner's coordinates c_d = x0_d + bit_d as uint32 (a
          negative cell wraps, as the JAX uint32 cast does); in 2-D the
          c2 term is absent
  exact: out = sum over c = 0..7 of table[l, row_c, f] * ((w_0 * w_1) * w_2),
         bit d of corner c is (c >> d) & 1, w_d = frac_d or 1 - frac_d
         (2-D: c = 0..3, weight w_0 * w_1)
  stochastic: bit_d = u[d, l, n] < frac_d; out = table[l, row, f]

and the table gradient adds w * g (exact) or g (stochastic) at each row;
the subsampled stochastic backwards (JAX ``grad_subsample``,
``grad_level_subsample``, ``grad_level_pair``) add, given the draws pick
(L, N), lsel (N,) or psel (L / 2, N), uint8, the routed gradient
``routed_grad``: (g[pick] * F) * s in feature pick alone, on the drawn
levels alone (s = L under lsel, 2 under psel, else 1).
In the plain version the coordinates are int64 holding uint32 values, and a
product by a prime is taken as two 16-bit halves so that it never overflows
int64; only its low 32 bits matter.  Positions get no gradient.
Every function takes ``scales``, the f32 resolutions of the table's levels,
for a table that holds a contiguous slice of the ladder (a level shard of
parallel/level_parallel.py, JAX ``level_scales_array``); by default the
table holds every hashed level at ``fine_scales(cfg)``.
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
    """(..., dim) int64 corner coordinates -> (...,) int64 row in [0, T)."""
    c = coords & MASK32
    h = _mul_u32(c[..., 0], PRIMES[0])
    for d in range(1, coords.shape[-1]):
        h = h ^ _mul_u32(c[..., d], PRIMES[d])
    return h & (table_size - 1)


def level_coords(xn, scale: float):
    """Normalised points (N, dim) -> (cell x0 (N, dim) int64, frac (N, dim)
    f32) of one level."""
    xl = xn * scale
    x0f = torch.floor(xl)
    return x0f.long(), xl - x0f


def _corner_weight(frac, off):
    """The product of the corner's axis weights, in axis order
    (((w_0 * w_1) * w_2) in 3-D), for offset bits ``off``."""
    w = frac[:, 0] if off[0] else 1.0 - frac[:, 0]
    for d in range(1, len(off)):
        w = w * (frac[:, d] if off[d] else 1.0 - frac[:, d])
    return w


def _corner_offsets(dim: int):
    """The 2^dim corners' offset bits, bit d of corner c being (c >> d) & 1."""
    return [tuple((c >> d) & 1 for d in range(dim)) for c in range(2 ** dim)]


def _scales(cfg: HashConfig, scales=None):
    return fine_scales(cfg) if scales is None else scales


def _level_terms(xn, cfg: HashConfig, u=None, bits=None, scales=None):
    """Per level: ([(flat row index into (L*T) (N,), weight (N,) or None)],
    picked offset bits (N,) int64 or None): one term per corner (exact) or
    the picked corner's (stochastic: from ``bits`` (L, N) when given, else
    from u (3, L, N))."""
    T = cfg.table_size
    out = []
    for l, scale in enumerate(_scales(cfg, scales)):
        x0, frac = level_coords(xn, float(scale))
        if u is None and bits is None:
            terms = []
            for off in _corner_offsets(cfg.dim):
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


def hash_encode_plain(table, x, mu, sigma, cfg: HashConfig, u=None,
                      scales=None):
    """(N, cfg.dim) world points -> (N, L*F) f32 features of the hashed
    levels (exact), or, given u (3, L, N), (features, the picked corners'
    offset bits, uint8 (L, N)) (stochastic, 3-D)."""
    L, T, F = table.shape
    flat = table.reshape(L * T, F).to(torch.float32)
    cols, picked = [], []
    for terms, bits in _level_terms(normalise(x, mu, sigma), cfg, u,
                                    scales=scales):
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


def routed_grad(grad, F: int, pick, lsel=None, psel=None):
    """The (N, L*F) gradient that a subsampled backward scatters: at each
    (point, level) (g[pick] * F) * s in feature pick and 0 in the others,
    and 0 on the levels not drawn (s = L on level lsel[n], 2 on level
    2j + psel[j, n] of pair j, else 1)."""
    L, n = pick.shape
    g = grad.reshape(n, L, F)
    pk = pick.long().T[..., None]                                 # (N, L, 1)
    val = torch.gather(g, 2, pk) * float(F)
    level = torch.arange(L, device=grad.device)
    if lsel is not None:
        val = torch.where((lsel.long()[:, None] == level)[..., None],
                          val * float(L), 0.0)
    elif psel is not None:
        drawn = psel.long().T[:, level // 2] == level % 2         # (N, L)
        val = torch.where(drawn[..., None], val * 2.0, 0.0)
    return torch.zeros_like(g).scatter_(2, pk, val).reshape(n, L * F)


def hash_encode_plain_backward(table, x, mu, sigma, cfg: HashConfig, grad,
                               u=None, bits=None, scales=None, pick=None,
                               lsel=None, psel=None):
    """Gradient of ``hash_encode_plain`` w.r.t. the table, given the
    gradient ``grad`` (N, L*F) of its output; stochastic given the picked
    corners' ``bits`` (L, N) or the uniforms u they came from, and
    subsampled given ``pick`` (and ``lsel`` or ``psel``): ``routed_grad``.
    Returns an f32 (L, T, F) tensor.  The table's values are not read (the
    encoding is linear in them); only its shape is."""
    L, T, F = table.shape
    if pick is not None:
        grad = routed_grad(grad, F, pick, lsel, psel)
    dflat = torch.zeros((L * T, F), dtype=torch.float32, device=x.device)
    for l, (terms, _) in enumerate(_level_terms(normalise(x, mu, sigma), cfg,
                                                u, bits, scales)):
        gl = grad[:, l * F:(l + 1) * F]
        for rows, w in terms:
            dflat.index_add_(0, rows, gl if w is None else gl * w[:, None])
    return dflat.reshape(L, T, F)


def _check_args(table, x, cfg: HashConfig, u=None, bits=None, scales=None,
                pick=None, lsel=None, psel=None):
    """Shapes and devices the kernels rely on; returns (n, L*F)."""
    want = (len(_scales(cfg, scales)), cfg.table_size,
            cfg.features_per_level)
    if cfg.dim not in (2, 3) or tuple(table.shape) != want:
        raise ValueError(f"the table must be {want} (2-D or 3-D points), got "
                         f"{tuple(table.shape)} for dim {cfg.dim}")
    if x.dim() != 2 or x.shape[1] != cfg.dim:
        raise ValueError(f"points must be (N, {cfg.dim}), got "
                         f"{tuple(x.shape)}")
    if cfg.dim == 2 and (u is not None or bits is not None):
        raise ValueError("the stochastic hash grid takes 3-D points only")
    if table.device != x.device or table.dtype != torch.float32:
        raise ValueError(f"the table must be float32 on the points' device, "
                         f"got {table.dtype} on {table.device}")
    n, c = x.shape[0], want[0] * want[2]
    if pick is None and (lsel is not None or psel is not None) or (
            pick is not None and bits is None):
        raise ValueError("the level draws (lsel, psel) go with pick, and "
                         "pick with the picked corners' bits")
    if lsel is not None and psel is not None:
        raise ValueError("lsel and psel are exclusive")
    if psel is not None and want[0] % 2:
        raise ValueError(f"level pairs need an even level count, got "
                         f"{want[0]}")
    u8 = torch.uint8
    for name, v, dtype, shape in (("u", u, torch.float32, (3, want[0], n)),
                                  ("bits", bits, u8, (want[0], n)),
                                  ("pick", pick, u8, (want[0], n)),
                                  ("lsel", lsel, u8, (n,)),
                                  ("psel", psel, u8, (want[0] // 2, n))):
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


def launch_points(x, mu, sigma, cfg: HashConfig, scales=None):
    """(points, mu (dim,), sigma (dim,), level struct) for a launch: f32,
    contiguous, on the points' device (no host synchronisation)."""
    def vec(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=x.device).expand(cfg.dim).contiguous()

    T = cfg.table_size
    scales = _scales(cfg, scales)
    L = len(scales)
    lv = cuda_lib.make_levels([T] * L, [l * T for l in range(L)], scales)
    return x.to(torch.float32).contiguous(), vec(mu), vec(sigma), lv


def aligned(t):
    """``t`` detached and contiguous, from a 16-byte aligned address."""
    tc = t.detach().contiguous()
    return tc.clone() if tc.data_ptr() % 16 else tc


def _launch_args(table, x, mu, sigma, cfg: HashConfig, scales=None):
    """(table from a 16-byte aligned address, points, mu (dim,), sigma
    (dim,), level struct) for a launch."""
    return (aligned(table), *launch_points(x, mu, sigma, cfg, scales))


def hash_encode_kernel(table, x, mu, sigma, cfg: HashConfig, u=None,
                       out=None, scales=None):
    """Forward wrapper: CPU tensors -> ``hash_encode_plain``; CUDA tensors ->
    ``hbr_hash_forward``.  ``out`` (optional) is an (N, L*F) f32 view with
    unit column stride to write into (a column block of the encoder's
    feature matrix).  Returns the features (exact), or, given u (3, L, N),
    (features, the picked corners' offset bits, uint8 (L, N))
    (stochastic)."""
    n, c = _check_args(table, x, cfg, u=u, scales=scales)
    if out is not None:
        cuda_lib.check_out(out, n, c, x.device)
    if x.device.type == "cpu":
        res = hash_encode_plain(table, x, mu, sigma, cfg, u, scales)
        feats, bits = (res, None) if u is None else res
        if out is not None:
            feats = out.copy_(feats)
        return feats if u is None else (feats, bits)
    if out is None:
        out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    bits = (None if u is None else
            torch.empty((table.shape[0], n), dtype=torch.uint8,
                        device=x.device))
    if n > 0:
        tc, xc, muv, sigmav, lv = _launch_args(table, x, mu, sigma, cfg,
                                               scales)
        uc = None if u is None else u.contiguous()
        code = cuda_lib.library().hbr_hash_forward(
            xc.data_ptr(), muv.data_ptr(), sigmav.data_ptr(), tc.data_ptr(),
            None if uc is None else uc.data_ptr(), n, cfg.dim, cfg.table_size,
            cfg.features_per_level, lv, out.data_ptr(), out.stride(0),
            None if bits is None else bits.data_ptr(),
            cuda_lib.stream_handle(x.device))
        hash_encode_kernel.launches += 1
        cuda_lib.check(code, "hbr_hash_forward")
    return out if u is None else (out, bits)


def hash_encode_backward_kernel(table, x, mu, sigma, cfg: HashConfig, grad,
                                bits=None, scales=None, pick=None, lsel=None,
                                psel=None):
    """Backward wrapper: the table gradient given ``grad``, the (N, L*F) f32
    gradient of the features (any row stride, unit column stride: a column
    block of the encoder's gradient), exact, or stochastic given the picked
    corners' ``bits`` (L, N) from the forward, subsampled given the draws
    ``pick`` (and ``lsel`` or ``psel``).  CPU tensors ->
    ``hash_encode_plain_backward``; CUDA tensors -> ``hbr_hash_backward``.
    Returns an f32 (L, T, F) tensor."""
    draws = (pick, lsel, psel)
    n, c = _check_args(table, x, cfg, bits=bits, scales=scales, pick=pick,
                       lsel=lsel, psel=psel)
    cuda_lib.check_out(grad, n, c, x.device, name="grad")
    if x.device.type == "cpu":
        return hash_encode_plain_backward(table, x, mu, sigma, cfg, grad,
                                          bits=bits, scales=scales, pick=pick,
                                          lsel=lsel, psel=psel)
    dtable = torch.zeros(tuple(table.shape), dtype=torch.float32,
                         device=x.device)
    if n > 0:
        _, xc, muv, sigmav, lv = _launch_args(table, x, mu, sigma, cfg,
                                              scales)
        held = [None if v is None else v.contiguous()
                for v in (bits, *draws)]
        ptr = [None if v is None else v.data_ptr() for v in held]
        code = cuda_lib.library().hbr_hash_backward(
            xc.data_ptr(), muv.data_ptr(), sigmav.data_ptr(), *ptr,
            grad.data_ptr(), grad.stride(0), n, cfg.dim, cfg.table_size,
            cfg.features_per_level, float(cfg.features_per_level), lv,
            dtable.data_ptr(), cuda_lib.stream_handle(x.device))
        hash_encode_backward_kernel.launches += 1
        cuda_lib.check(code, "hbr_hash_backward")
    return dtable


hash_encode_kernel.launches = 0
hash_encode_backward_kernel.launches = 0
