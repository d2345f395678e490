"""Hash-grid variants: packed bf16 and int8 tables, the packed-exact read,
the ``cell`` variant, the pairs of the subsampled stochastic backwards and
the ``sorted`` and ``segsum`` scatter strategies: the CUDA kernels
(csrc/hash.cu, the port's own) and their plain versions.

Counterparts of the JAX ops/hash_encoding.py ``pack_table_bf16``,
``pack_table_int8``, ``hash_encode_stochastic_packed`` and
``hash_encode_stochastic_int8`` (with their custom VJPs),
``hash_encode_packed_exact``, ``hash_encode_cell`` and ``scatter_add_flat``,
all plain jnp there.  Numerics, step for step as JAX:

  bf16 word   bits 16f..16f+15 = bf16(t[f]) (round to nearest even)
  int8 word   s_l = max|table_l| + 1e-12;  byte f = clip(round_half_even(
              t[f] / s_l * 127), -127, 127);  unpacked b * (s_l / 127)
  stochastic  the corner bits of hash_kernel (u < frac), one word a (point,
              level), its F features unpacked
  packed-exact  sum over c = 0..7 of unpack(word_c) * ((w_0 * w_1) * w_2)
              from 0, f32
  cell        one hash of the cell's corner 0, row (8F,) with corner c's
              feature f at c * F + f; sum over c of row[c*F + f] * w_c
  subsampled  g_sel = F * g[pick] (bf16: 2 * g[pick]) into feature pick of
              the picked corner's row; grad_level_subsample: of those, level
              lsel[n] alone, times L; grad_level_pair: level 2j + psel[j, n]
              of each pair j, times 2

The packed forwards read the words; their backward is straight-through:
the gradient of the f32 master table, as JAX's VJPs give it (the
packed-exact one is hash_kernel's exact backward, term for term, and the
subsampled ones of the "random" strategy are hash_kernel's stochastic
backward given the draws).  The draws (pick (L, N), lsel (N,), psel
(L / 2, N), uint8) are the caller's (ops/hash_encoding.py
``draw_subsample``).
``scatter(size, idx, val, strategy)`` sums (flat index, value) pairs as JAX
``scatter_add_flat`` does: "random" adds them as they come, "sorted" after a
stable ``torch.sort`` by index, "segsum" sums each run of equal indices of the
sorted pairs and writes it once; ``pairs`` writes the pairs of a stochastic
backward in JAX's order.

Words are int32 tensors holding the uint32 bit patterns.  Every ``*_kernel``
function runs its plain version for tensors on the CPU and launches its
kernel, or raises, for tensors on a CUDA device; each counts its launches.
"""

from __future__ import annotations

import torch

from human_body_reconstruction_tpu_torch.ops import cuda_lib, hash_kernel
from human_body_reconstruction_tpu_torch.ops.dense_grid import normalise
from human_body_reconstruction_tpu_torch.ops.hash_kernel import (
    MASK32, _corner_offsets, _corner_weight, _level_terms, _scales, hash_rows,
    level_coords)
from human_body_reconstruction_tpu_torch.utils.config import HashConfig

FORMATS = {"bf16": 0, "int8": 1}
SORTED_STRATEGIES = {"sorted": 0, "segsum": 1}   # hbr_scatter_sorted's codes


def _i32(w):
    """int64 uint32 values -> int32 bit patterns."""
    return (w - ((w >> 31) & 1) * (1 << 32)).to(torch.int32)


def _u32(w):
    """int32 bit patterns -> int64 uint32 values."""
    return w.to(torch.int64) & MASK32


def _check_format(fmt: str, F: int):
    if fmt not in FORMATS:
        raise ValueError(f"unknown pack format {fmt!r}; expected bf16 or int8")
    if (fmt == "bf16" and F != 2) or F > 4:
        raise ValueError(f"a {fmt} word holds {'2' if fmt == 'bf16' else '1 to 4'}"
                         f" features, got {F}")


def _check_device(*ts):
    dev = ts[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"hash variant kernels: unsupported device {dev}")
    for t in ts[1:]:
        if t is not None and t.device != dev:
            raise ValueError(f"every tensor must be on {dev}, got {t.device}")


def _check_points(x, cfg: HashConfig):
    if cfg.dim != 3 or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"the hash variants take 3-D points (N, 3), got "
                         f"{tuple(x.shape)} for dim {cfg.dim}")


def _check_small(name, v, dtype, shape, device):
    if v is not None and (tuple(v.shape) != tuple(shape) or v.dtype != dtype
                          or v.device != device):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)} on {device}, "
                         f"got {v.dtype} {tuple(v.shape)} on {v.device}")


# ------------------------------------------------------------------ packing

def pack_plain(table, fmt: str):
    """(L, T, F) f32 table -> (words (L*T,) int32, scale (L,) f32 for int8
    else None)."""
    L, T, F = table.shape
    if fmt == "bf16":
        b = table.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
        return _i32(b[..., 0] | (b[..., 1] << 16)).reshape(L * T), None
    scale = table.abs().amax(dim=(1, 2)) + 1e-12
    q = torch.clamp(torch.round(table / scale[:, None, None] * 127.0),
                    -127.0, 127.0).to(torch.int64)
    w = torch.zeros((L, T), dtype=torch.int64, device=table.device)
    for f in range(F):
        w = w | ((q[..., f] & 0xFF) << (8 * f))
    return _i32(w).reshape(L * T), scale


def pack_kernel(table, fmt: str):
    """Pack wrapper: CPU tensors -> ``pack_plain``; CUDA tensors ->
    ``hbr_hash_pack``."""
    L, T, F = table.shape
    _check_format(fmt, F)
    _check_device(table)
    if table.dtype != torch.float32:
        raise ValueError(f"the table must be float32, got {table.dtype}")
    if table.device.type == "cpu":
        return pack_plain(table, fmt)
    tc = hash_kernel.aligned(table)
    words = torch.empty((L * T,), dtype=torch.int32, device=table.device)
    scale = (torch.empty((L,), dtype=torch.float32, device=table.device)
             if fmt == "int8" else None)
    code = cuda_lib.library().hbr_hash_pack(
        tc.data_ptr(), L, T, F, FORMATS[fmt], words.data_ptr(),
        None if scale is None else scale.data_ptr(),
        cuda_lib.stream_handle(table.device))
    pack_kernel.launches += 1
    cuda_lib.check(code, "hbr_hash_pack")
    return words, scale


def unpack_plain(words, scale, fmt: str, F: int, level: int):
    """Level ``level``'s words (any shape, int32) -> (..., F) f32 features."""
    w = _u32(words)
    if fmt == "bf16":
        return torch.stack([_i32(((w >> (16 * f)) & 0xFFFF) << 16).view(
            torch.float32) for f in range(F)], dim=-1)
    # a true division on every device (CUDA divides by a Python scalar as
    # a product with its reciprocal, which can differ by an ulp)
    mult = scale[level] / torch.full_like(scale[level], 127.0)
    cols = []
    for f in range(F):
        b = (w >> (8 * f)) & 0xFF
        cols.append((b - 256 * (b > 127).long()).to(torch.float32) * mult)
    return torch.stack(cols, dim=-1)


# ---------------------------------------------------------- packed forwards

def packed_encode_plain(words, scale, x, mu, sigma, cfg: HashConfig, u=None,
                        scales=None):
    """(N, 3) world points -> (N, L*F) f32 features read from the packed
    words (``cfg.pack_format``): packed-exact, or, given u (3, L, N),
    (features, the picked corners' offset bits, uint8 (L, N))."""
    F, fmt = cfg.features_per_level, cfg.pack_format
    cols, picked = [], []
    for l, (terms, bits) in enumerate(_level_terms(
            normalise(x, mu, sigma), cfg, u, scales=scales)):
        if u is not None:
            cols.append(unpack_plain(words[terms[0][0]], scale, fmt, F, l))
            picked.append(bits)
            continue
        acc = torch.zeros((x.shape[0], F), dtype=torch.float32,
                          device=x.device)
        for rows, w in terms:
            acc = acc + unpack_plain(words[rows], scale, fmt, F, l) * w[:, None]
        cols.append(acc)
    feats = torch.cat(cols, dim=-1)
    return feats if u is None else (feats, torch.stack(picked).to(torch.uint8))


def packed_encode_kernel(words, scale, x, mu, sigma, cfg: HashConfig, u=None,
                         out=None, scales=None):
    """Packed forward wrapper: CPU tensors -> ``packed_encode_plain``; CUDA
    tensors -> ``hbr_hash_packed_forward``.  ``out`` as for
    ``hash_kernel.hash_encode_kernel``.  Returns the packed-exact features,
    or, given u, (features, bits).  The packed-exact kernel reads the words
    in aligned pairs: on the card they must start 8-byte aligned (the call
    raises otherwise; ``pack_kernel``'s words do)."""
    F, fmt = cfg.features_per_level, cfg.pack_format
    L, T = len(_scales(cfg, scales)), cfg.table_size
    _check_format(fmt, F)
    _check_points(x, cfg)
    _check_device(x, words, scale, u)
    _check_small("words", words, torch.int32, (L * T,), x.device)
    if fmt == "int8":
        _check_small("scale", scale, torch.float32, (L,), x.device)
    n, c = x.shape[0], L * F
    _check_small("u", u, torch.float32, (3, L, n), x.device)
    if out is not None:
        cuda_lib.check_out(out, n, c, x.device)
    if x.device.type == "cpu":
        res = packed_encode_plain(words, scale, x, mu, sigma, cfg, u, scales)
        feats = res if u is None else res[0]
        if out is not None:
            feats = out.copy_(feats)
        return feats if u is None else (feats, res[1])
    if out is None:
        out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    bits = (None if u is None else
            torch.empty((L, n), dtype=torch.uint8, device=x.device))
    if n > 0:
        xc, muv, sigmav, lv = hash_kernel.launch_points(x, mu, sigma, cfg,
                                                        scales)
        uc = None if u is None else u.contiguous()
        code = cuda_lib.library().hbr_hash_packed_forward(
            xc.data_ptr(), muv.data_ptr(), sigmav.data_ptr(),
            words.contiguous().data_ptr(),
            None if scale is None else scale.contiguous().data_ptr(),
            None if uc is None else uc.data_ptr(), n, T, F, FORMATS[fmt], lv,
            out.data_ptr(), out.stride(0),
            None if bits is None else bits.data_ptr(),
            cuda_lib.stream_handle(x.device))
        cuda_lib.check(code, "hbr_hash_packed_forward")
        packed_encode_kernel.launches += 1
    return out if u is None else (out, bits)


# --------------------------------------------------------------------- cell

def _cell_rows(xn, cfg: HashConfig, scales=None):
    """Per level: (flat row into (L*T) (N,), [w_c (N,) for c = 0..7])."""
    T = cfg.table_size
    out = []
    for l, s in enumerate(_scales(cfg, scales)):
        x0, frac = level_coords(xn, float(s))
        out.append((hash_rows(x0, T) + l * T,
                    [_corner_weight(frac, off) for off in _corner_offsets(3)]))
    return out


def cell_encode_plain(table, x, mu, sigma, cfg: HashConfig, scales=None):
    """(N, 3) world points -> (N, L*F) f32 features of the cell variant
    (table (L, T, 8F))."""
    L, T, P = table.shape
    F = cfg.features_per_level
    flat = table.reshape(L * T, P).to(torch.float32)
    cols = []
    for rows, ws in _cell_rows(normalise(x, mu, sigma), cfg, scales):
        r = flat[rows]
        acc = torch.zeros((x.shape[0], F), dtype=torch.float32,
                          device=x.device)
        for c, w in enumerate(ws):
            acc = acc + r[:, c * F:(c + 1) * F] * w[:, None]
        cols.append(acc)
    return torch.cat(cols, dim=-1)


def cell_encode_plain_backward(table, x, mu, sigma, cfg: HashConfig, grad,
                               scales=None):
    """The table gradient of ``cell_encode_plain`` given ``grad`` (N, L*F):
    an f32 (L, T, 8F) tensor (the table's values are not read)."""
    L, T, P = table.shape
    F = cfg.features_per_level
    dflat = torch.zeros((L * T, P), dtype=torch.float32, device=x.device)
    for l, (rows, ws) in enumerate(_cell_rows(normalise(x, mu, sigma), cfg,
                                              scales)):
        gl = grad[:, l * F:(l + 1) * F]
        dflat.index_add_(0, rows, torch.cat([gl * w[:, None] for w in ws],
                                            dim=-1))
    return dflat.reshape(L, T, P)


def _check_cell(table, x, cfg: HashConfig, scales=None):
    want = (len(_scales(cfg, scales)), cfg.table_size,
            8 * cfg.features_per_level)
    _check_points(x, cfg)
    _check_device(x, table)
    if (cfg.variant != "cell" or tuple(table.shape) != want
            or table.dtype != torch.float32):
        raise ValueError(f"the cell table must be float32 {want}, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if want[0] > cuda_lib.MAX_LEVELS or want[2] > 8 * hash_kernel.MAX_FEATURES:
        raise ValueError(f"{want[0]} levels of {cfg.features_per_level} "
                         f"features; the kernels take at most "
                         f"{cuda_lib.MAX_LEVELS} and "
                         f"{hash_kernel.MAX_FEATURES}")
    return x.shape[0], want[0] * cfg.features_per_level


def cell_encode_kernel(table, x, mu, sigma, cfg: HashConfig, out=None,
                       scales=None):
    """Cell forward wrapper: CPU tensors -> ``cell_encode_plain``; CUDA
    tensors -> ``hbr_hash_cell_forward``."""
    n, c = _check_cell(table, x, cfg, scales)
    if out is not None:
        cuda_lib.check_out(out, n, c, x.device)
    if x.device.type == "cpu":
        feats = cell_encode_plain(table, x, mu, sigma, cfg, scales)
        return feats if out is None else out.copy_(feats)
    if out is None:
        out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    if n > 0:
        tc, xc, muv, sigmav, lv = hash_kernel._launch_args(table, x, mu, sigma,
                                                           cfg, scales)
        code = cuda_lib.library().hbr_hash_cell_forward(
            xc.data_ptr(), muv.data_ptr(), sigmav.data_ptr(), tc.data_ptr(), n,
            cfg.table_size, cfg.features_per_level, lv, out.data_ptr(),
            out.stride(0), cuda_lib.stream_handle(x.device))
        cell_encode_kernel.launches += 1
        cuda_lib.check(code, "hbr_hash_cell_forward")
    return out


def cell_encode_backward_kernel(table, x, mu, sigma, cfg: HashConfig, grad,
                                scales=None):
    """Cell backward wrapper: CPU tensors -> ``cell_encode_plain_backward``;
    CUDA tensors -> ``hbr_hash_cell_backward``.  ``grad`` (N, L*F) f32, any
    row stride, unit column stride."""
    n, c = _check_cell(table, x, cfg, scales)
    cuda_lib.check_out(grad, n, c, x.device, name="grad")
    if x.device.type == "cpu":
        return cell_encode_plain_backward(table, x, mu, sigma, cfg, grad,
                                          scales)
    dtable = torch.zeros(tuple(table.shape), dtype=torch.float32,
                         device=x.device)
    if n > 0:
        xc, muv, sigmav, lv = hash_kernel.launch_points(x, mu, sigma, cfg,
                                                        scales)
        code = cuda_lib.library().hbr_hash_cell_backward(
            xc.data_ptr(), muv.data_ptr(), sigmav.data_ptr(), grad.data_ptr(),
            grad.stride(0), n, cfg.table_size, cfg.features_per_level, lv,
            dtable.data_ptr(), cuda_lib.stream_handle(x.device))
        cell_encode_backward_kernel.launches += 1
        cuda_lib.check(code, "hbr_hash_cell_backward")
    return dtable


# ------------------------------------------- stochastic backwards, scatters

def pairs_plain(table, x, mu, sigma, cfg: HashConfig, grad, bits, pick=None,
                lsel=None, psel=None, scales=None):
    """The (flat index into (L*T*F) int64, value f32) pairs of a stochastic
    backward in JAX's order: without ``pick`` F a (point, level), [f][l][n];
    with it one a (point, level) ([l][n]), a point (``lsel``, [n]) or a
    (pair, point) (``psel``, [j][n])."""
    L, T, F = table.shape
    n = x.shape[0]
    terms = _level_terms(normalise(x, mu, sigma), cfg, bits=bits,
                         scales=scales)
    rows = torch.stack([t[0][0][0] for t in terms]) * F          # (L, N)
    g = grad.reshape(n, L, F).permute(2, 1, 0)                   # (F, L, N)
    if pick is None:
        idx = torch.stack([rows + f for f in range(F)])
        return idx.reshape(-1), g.reshape(-1)
    pk = pick.long()
    val = torch.gather(g.permute(1, 0, 2), 1, pk[:, None, :])[:, 0] * float(F)
    idx = rows + pk
    if lsel is not None:
        sel = lsel.long()[None]
        idx, val = idx.gather(0, sel)[0], val.gather(0, sel)[0] * float(L)
    elif psel is not None:
        sel = (2 * torch.arange(L // 2, device=x.device)[:, None]
               + psel.long())
        idx, val = idx.gather(0, sel), val.gather(0, sel) * 2.0
    return idx.reshape(-1), val.reshape(-1)


def scatter_plain(size: int, idx, val, strategy: str = "random"):
    """``zeros(size)`` with ``val`` summed in at ``idx`` (JAX
    ``scatter_add_flat``)."""
    out = torch.zeros((size,), dtype=torch.float32, device=val.device)
    idx = idx.long()
    if strategy == "random":
        return out.index_add_(0, idx, val)
    si, order = torch.sort(idx, stable=True)
    sv = val[order]
    if strategy == "sorted":
        return out.index_add_(0, si, sv)
    if strategy != "segsum":
        raise ValueError(f"unknown scatter strategy {strategy!r}")
    start = torch.ones_like(si, dtype=torch.bool)
    start[1:] = si[1:] != si[:-1]
    run = torch.cumsum(start.long(), 0) - 1
    totals = torch.zeros_like(sv).index_add_(0, run, sv)
    out[si[start]] = totals[:int(start.sum())]
    return out


def _check_draws(table, x, cfg, grad, bits, pick, lsel, psel, scales):
    """hash_kernel's checks of a routed stochastic backward, and a word's
    at most 4 features."""
    _check_points(x, cfg)
    if bits is None or table.shape[-1] > 4:
        raise ValueError(f"the pairs need the picked corners' bits and F <= "
                         f"4, got F {table.shape[-1]}")
    n, c = hash_kernel._check_args(table, x, cfg, bits=bits, scales=scales,
                                   pick=pick, lsel=lsel, psel=psel)
    cuda_lib.check_out(grad, n, c, x.device, name="grad")
    return n


def pairs_kernel(table, x, mu, sigma, cfg: HashConfig, grad, bits, pick=None,
                 lsel=None, psel=None, scales=None):
    """Pairs wrapper: CPU tensors -> ``pairs_plain``; CUDA tensors ->
    ``hbr_hash_pairs``.  Returns (idx int32 (CPU: int64), val f32)."""
    n = _check_draws(table, x, cfg, grad, bits, pick, lsel, psel, scales)
    if x.device.type == "cpu":
        return pairs_plain(table, x, mu, sigma, cfg, grad, bits, pick, lsel,
                           psel, scales)
    L, T, F = table.shape
    m = n * (F * L if pick is None else 1 if lsel is not None
             else L // 2 if psel is not None else L)
    idx = torch.empty((m,), dtype=torch.int32, device=x.device)
    val = torch.empty((m,), dtype=torch.float32, device=x.device)
    if n > 0:
        xc, muv, sigmav, lv = hash_kernel.launch_points(x, mu, sigma, cfg,
                                                        scales)
        held = [None if v is None else v.contiguous()
                for v in (bits, pick, lsel, psel)]
        code = cuda_lib.library().hbr_hash_pairs(
            xc.data_ptr(), muv.data_ptr(), sigmav.data_ptr(),
            *[None if v is None else v.data_ptr() for v in held],
            grad.data_ptr(), grad.stride(0), n, T, F, float(F), lv,
            idx.data_ptr(), val.data_ptr(), cuda_lib.stream_handle(x.device))
        pairs_kernel.launches += 1
        cuda_lib.check(code, "hbr_hash_pairs")
    return idx, val


def sort_pairs(idx, val):
    """(indices, values) sorted by index, stable (JAX ``lax.sort`` with
    one key), the indices int32."""
    si, order = torch.sort(idx.to(torch.int32), stable=True)
    return si, val[order]


def add_sorted_kernel(size: int, si, sv, strategy: str):
    """Add wrapper for pairs sorted by index: CPU tensors ->
    ``scatter_plain``; CUDA tensors -> ``hbr_scatter_sorted``, a pass over
    tiles of the pairs ("sorted": a run that crosses tiles added with one
    atomic a tile; "segsum": no atomics, each run's total stored once, the
    same bits every call, given a small workspace).  Returns (size,) f32."""
    if strategy not in SORTED_STRATEGIES:
        raise ValueError(f"the sorted scatter takes 'sorted' or 'segsum', "
                         f"got {strategy!r}")
    _check_device(sv, si)
    if si.shape != sv.shape or si.dim() != 1 or sv.dtype != torch.float32:
        raise ValueError("idx and val must be 1-D of one length, val f32")
    if sv.device.type == "cpu":
        return scatter_plain(size, si, sv, strategy)
    if size >= 2 ** 31 or si.dtype != torch.int32:
        raise ValueError(f"{size} entries, {si.dtype} indices; the scatter "
                         "indexes with int32")
    out = torch.zeros((size,), dtype=torch.float32, device=sv.device)
    if si.numel():
        lib, strat = cuda_lib.library(), SORTED_STRATEGIES[strategy]
        work = torch.empty((lib.hbr_scatter_work_bytes(si.numel(), strat),),
                           dtype=torch.uint8, device=sv.device)
        code = lib.hbr_scatter_sorted(
            si.contiguous().data_ptr(), sv.contiguous().data_ptr(),
            si.numel(), strat, out.data_ptr(),
            work.data_ptr() if work.numel() else None,
            cuda_lib.stream_handle(sv.device))
        add_sorted_kernel.launches += 1
        cuda_lib.check(code, "hbr_scatter_sorted")
    return out


def scatter(size: int, idx, val, strategy: str):
    """JAX ``scatter_add_flat`` for the sorted strategies: CPU tensors ->
    ``scatter_plain``; CUDA tensors -> ``sort_pairs``, then
    ``add_sorted_kernel``."""
    if val.device.type == "cpu":
        return scatter_plain(size, idx, val, strategy)
    return add_sorted_kernel(size, *sort_pairs(idx, val), strategy)


def stochastic_backward(table, x, mu, sigma, cfg: HashConfig, grad, bits,
                        pick=None, lsel=None, psel=None, scales=None):
    """The table gradient of a packed stochastic forward (bf16 or int8),
    straight-through, by ``cfg.scatter_strategy``: "random" by hash_kernel's
    atomic stochastic backward (subsampled given ``pick``), "sorted" and
    "segsum" by ``pairs_kernel`` and ``scatter``."""
    L, T, F = table.shape
    if cfg.scatter_strategy == "random":
        return hash_kernel.hash_encode_backward_kernel(
            table, x, mu, sigma, cfg, grad, bits, scales=scales, pick=pick,
            lsel=lsel, psel=psel)
    idx, val = pairs_kernel(table, x, mu, sigma, cfg, grad, bits, pick, lsel,
                            psel, scales)
    return scatter(L * T * F, idx, val,
                   cfg.scatter_strategy).reshape(L, T, F)


for _fn in (pack_kernel, packed_encode_kernel, cell_encode_kernel,
            cell_encode_backward_kernel, pairs_kernel, add_sorted_kernel):
    _fn.launches = 0
