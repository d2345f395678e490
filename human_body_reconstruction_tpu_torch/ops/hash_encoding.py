"""Full encoder (counterpart of ``encode_params`` in the JAX
ops/hash_encoding.py): dense coarse grids, then CP factor lines or the
hashed levels of the ``corner`` or ``cell`` variant.

Feature order: the dense (coarsest) levels first, then the CP or hashed
levels (hashed level l, feature f at column ``l * F + f``), as in the JAX
package, so the MLP sees the same layout.  ``encode_params`` is one
``torch.autograd.Function`` over (grids..., lines... or table): its forward
has the kernel wrappers write their column blocks of one (N, out_dim)
feature matrix, and its backward hands the matching column blocks of the
incoming gradient to the backward kernel wrappers.  The wrappers run the
plain versions for tensors on the CPU and launch the CUDA kernels for
tensors on a CUDA device.  A config that names the JAX XLA encoders
(``cp_impl``/``dense_impl`` "xla") runs those levels in plain PyTorch with
the XLA path's roundings instead (ops/xla_encoders.py) on either device;
"auto" and "pallas" take the kernels.  The forward saves only the points,
the scene normalisation, the tables and, in stochastic mode, the picked
corners' offset bits, uint8 (L, N), which the hash forward writes beside its
features; the uniforms are not kept (197 MB against the bits' 16 MB at the
hash path's 1,024,000 points).  The backward recomputes the per-axis lerps
and the cells instead of keeping them (the (3, N, C) CP products are 1.15
GB at 768k points).  Positions get no gradient.

The hashed levels take the branch of JAX ``encode`` (``hash_route``, named
for the JAX function it stands for): the cell variant
(ops/hash_variants.py), whether or not ``stochastic``; when training with
``stochastic``, the single-corner estimator driven by uniforms u (3, L, N)
(drawn by ``stoch_uniform``: the Philox kernel of ops/rng_kernel.py when
``cfg.hw_rng``, else ``torch.rand``; or handed in), reading the f32 table
(ops/hash_kernel.py) or, with ``cfg.packed``, int8 words or (F 2) bf16
pairs packed from it each call (ops/hash_variants.py); otherwise exact (8
corners, or 4 for the 2-D points of the image fit, whose encoder is the
table alone), through packed words when the config is packed and either
trains stochastically (``packed_eval``, the eval read of a packed model) or
trains the packed-exact read itself (``packed_exact_train``).  The packed
backwards are straight-through; with ``grad_subsample`` they route the
draws ``pick`` (L, N), ``lsel`` (N,) and ``psel`` (L / 2, N) that
``draw_subsample`` makes from the caller's generator (or that are handed
in), and ``cfg.scatter_strategy`` picks their scatter.  ``unported`` names
what is not ported: points of other dimensions than 2 and 3, and on 2-D
points anything but the exact f32 corner grid alone.

Level parallelism (``cfg.level_axis`` set; parallel/level_parallel.py):
the call gets a ``shard`` (``LevelShard``), this rank's place in the level
group.  The hashed table is the rank's contiguous level slice, encoded at
the slice's scales, with uniforms (3, L/k, N) of its own; CP lines are the
rank's (3, G_l, R/k) rank slices.  The dense levels are computed on every
rank; the rank's CP or hashed block is joined with the others by the
shard's ``gather`` and ``join_level_blocks`` (the CP blocks reordered
[rank, level, r_local] -> [level, rank, r_local], JAX's ``[chip, n, l,
r_local] -> [n, l, chip, r_local]``), so the MLP sees the single-device
layout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from human_body_reconstruction_tpu_torch.ops import (
    cp_kernel, dense_kernel, hash_kernel, hash_variants, rng_kernel,
    xla_encoders)
from human_body_reconstruction_tpu_torch.utils.config import HashConfig

# the routes of the hashed levels (``hash_route``) that read packed words
# stochastically, that draw uniforms, and that read packed words
PACKED_STOCHASTIC_ROUTES = ("hash_encode_stochastic_int8",
                            "hash_encode_stochastic_packed")
STOCHASTIC_ROUTES = PACKED_STOCHASTIC_ROUTES + ("hash_encode_stochastic",)
PACKED_ROUTES = PACKED_STOCHASTIC_ROUTES + ("hash_encode_packed_exact",)


@dataclasses.dataclass
class LevelShard:
    """This rank's place in the level group, as the encoder needs it (JAX
    ``cfg.level_axis`` with ``params["lp_scales"]``): the group's size, the
    f32 scales of a hashed table's level slice (None for CP, whose rank
    slices span every level), ``gather`` ((N, c) -> (N, k * c), the group's
    column blocks in rank order, whose backward hands each rank its own
    block) and ``psum`` (the group's sum of a replicated value, whose
    backward is the identity); parallel/level_parallel.py builds them on
    the group.  Without ``gather`` the encode returns the rank's own
    columns, for a caller that joins the blocks itself."""

    extent: int
    scales: Optional[torch.Tensor] = None
    gather: Optional[Callable] = None
    psum: Optional[Callable] = None


def join_level_blocks(dense, fine, n_lines: int, extent: int):
    """The single-device feature layout from the dense columns (N, D * F)
    and the level group's gathered blocks (N, k * c) in rank order: a
    hashed table's level blocks are already level-major; CP's k blocks of
    (n_lines, R / k) columns become [level, rank, r_local]."""
    if n_lines:
        n = fine.shape[0]
        fine = (fine.reshape(n, extent, n_lines, -1).transpose(1, 2)
                .reshape(n, -1))
    return torch.cat([dense, fine], dim=-1)


def unported(cfg: HashConfig) -> Optional[str]:
    """Why the port cannot run this encoder config, or None when it can.
    2-D points (the image fit's) go through the exact f32 corner hash grid
    alone."""
    if cfg.dim == 2 and (cfg.variant != "corner" or cfg.dense_levels
                         or cfg.num_hashed_levels == 0 or cfg.packed):
        return ("2-D points are ported for the corner hash grid alone (no "
                "dense levels, no CP, no packed words)")
    if cfg.dim == 2 and cfg.stochastic_train:
        return ("the stochastic hash grid on 2-D points (stochastic_train "
                "with dim 2) is not ported; no entry point runs it")
    if cfg.dim not in (2, 3):
        return f"{cfg.dim}-D points are not ported; 2-D and 3-D are"
    return None


def hash_route(cfg: HashConfig, stochastic: bool) -> str:
    """The hashed levels' branch of JAX ``encode``, by the name of the JAX
    function it takes: the cell variant first, then the stochastic paths
    (int8, bf16 pairs at F 2, else the f32 single corner), then the
    packed-exact read of a packed config that trains stochastically
    (``packed_eval``) or trains it (``packed_exact_train``), else exact."""
    if cfg.variant == "cell":
        return "hash_encode_cell"
    F = cfg.features_per_level
    if stochastic:
        if cfg.packed and cfg.pack_format == "int8":
            return "hash_encode_stochastic_int8"
        if cfg.packed and F == 2:
            return "hash_encode_stochastic_packed"
        return "hash_encode_stochastic"
    if (cfg.packed and (cfg.pack_format == "int8" or F == 2)
            and ((cfg.packed_eval and cfg.stochastic_train)
                 or cfg.packed_exact_train)):
        return "hash_encode_packed_exact"
    return "hash_encode"


def subsample_draws(route: str, cfg: HashConfig) -> tuple:
    """The draws a subsampled packed backward routes (JAX
    ``_stoch_packed_fwd``, ``_stoch_int8_fwd``): "pick" with
    ``grad_subsample``, then on the int8 route "psel" with
    ``grad_level_pair`` or "lsel" with ``grad_level_subsample``."""
    if route not in PACKED_STOCHASTIC_ROUTES or not cfg.grad_subsample:
        return ()
    if route == "hash_encode_stochastic_packed":
        return ("pick",)
    return ("pick",) + (("psel",) if cfg.grad_level_pair else ("lsel",)
                        if cfg.grad_level_subsample else ())


def draw_subsample(route: str, cfg: HashConfig, n_levels: int, n: int,
                   device, generator: Optional[torch.Generator] = None,
                   given: Optional[dict] = None) -> dict:
    """{name: draw} of ``subsample_draws``, uint8 on ``device``, each taken
    from ``given`` or drawn from ``generator``: pick (L, N), the feature of
    each (point, level) (bf16: bernoulli(0.5); int8: randint(0, F)); lsel
    (N,), one level a point; psel (L / 2, N), one level of each consecutive
    pair.  L is the table's level count (a level shard's own)."""
    given = given or {}
    high = {"pick": (cfg.features_per_level
                     if route == "hash_encode_stochastic_int8" else 2),
            "lsel": n_levels, "psel": 2}
    shape = {"pick": (n_levels, n), "lsel": (n,), "psel": (n_levels // 2, n)}
    return {k: given[k] if given.get(k) is not None else torch.randint(
        0, high[k], shape[k], generator=generator, device=device,
        dtype=torch.uint8) for k in subsample_draws(route, cfg)}


def init_table(cfg: HashConfig, generator: torch.Generator):
    """(L_hashed, T, F) table, U(-init_scale, init_scale), on the
    generator's device."""
    return torch.empty(
        (cfg.num_hashed_levels, cfg.table_size, cfg.payload),
        device=generator.device).uniform_(-cfg.init_scale, cfg.init_scale,
                                          generator=generator)


def stoch_uniform(shape, cfg: HashConfig, device,
                  generator: Optional[torch.Generator] = None):
    """Uniforms driving the stochastic corner bits (counterpart of
    ``_stoch_uniform``): with ``cfg.hw_rng`` a seed drawn on the device as
    JAX draws it, randint(0, 2^31 - 1), then the Philox kernel; otherwise
    ``torch.rand`` (the counterpart of threefry)."""
    if cfg.hw_rng:
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=device, dtype=torch.int32)
        return rng_kernel.uniform(seed, shape)
    return torch.rand(shape, generator=generator, device=device)


def _table_forward(route, table, x, mu, sigma, cfg: HashConfig, u, out,
                   scales):
    """The hashed levels of ``route`` into ``out``; returns the picked
    corners' bits (stochastic routes) or None."""
    if route == "hash_encode_cell":
        hash_variants.cell_encode_kernel(table, x, mu, sigma, cfg, out=out,
                                         scales=scales)
        return None
    if route in PACKED_ROUTES:
        words, scale = hash_variants.pack_kernel(table, cfg.pack_format)
        res = hash_variants.packed_encode_kernel(
            words, scale, x, mu, sigma, cfg, u, out=out, scales=scales)
    else:
        res = hash_kernel.hash_encode_kernel(table, x, mu, sigma, cfg, u,
                                             out=out, scales=scales)
    return None if u is None else res[1]


def _table_backward(route, table, x, mu, sigma, cfg: HashConfig, grad, bits,
                    sub, scales):
    """The f32 table gradient of ``route`` (the packed ones
    straight-through; ``sub``: pick, lsel, psel)."""
    if route == "hash_encode_cell":
        return hash_variants.cell_encode_backward_kernel(
            table, x, mu, sigma, cfg, grad, scales=scales)
    if route in PACKED_STOCHASTIC_ROUTES:
        return hash_variants.stochastic_backward(
            table, x, mu, sigma, cfg, grad, bits, *sub, scales=scales)
    return hash_kernel.hash_encode_backward_kernel(
        table, x, mu, sigma, cfg, grad, bits, scales=scales)


class _Encode(torch.autograd.Function):
    """(x, mu, sigma, draws, cfg, scales, n_dense, n_lines, *tables) -> (N,
    width) f32, where tables = grids + lines + (table,), ``draws`` {"route":
    the hashed levels' ``hash_route``, "u": the uniforms (3, L, N) of a
    stochastic route, "pick", "lsel", "psel": a subsampled backward's draws}
    and ``scales`` are the table's level scales (None: every hashed
    level's)."""

    @staticmethod
    def forward(ctx, x, mu, sigma, draws, cfg: HashConfig, scales,
                n_dense: int, n_lines: int, *tables):
        grids = tables[:n_dense]
        lines = tables[n_dense:n_dense + n_lines]
        table = tables[n_dense + n_lines:]
        d_dense = n_dense * cfg.features_per_level
        if lines:
            width = len(lines) * lines[0].shape[-1]
        elif table:
            width = table[0].shape[0] * cfg.features_per_level
        else:
            width = 0
        out = torch.empty((x.shape[0], d_dense + width), dtype=torch.float32,
                          device=x.device)
        if grids and cfg.dense_impl == "xla":
            out[:, :d_dense] = xla_encoders.dense_encode_xla(
                grids, x, mu, sigma, cfg)
        elif grids:
            dense_kernel.dense_encode_kernel(grids, x, mu, sigma, cfg,
                                             out=out[:, :d_dense])
        if lines and cfg.cp_impl == "xla":
            out[:, d_dense:] = xla_encoders.cp_encode_xla(lines, x, mu, sigma,
                                                          cfg)
        elif lines:
            cp_kernel.cp_encode_kernel(lines, x, mu, sigma, cfg,
                                       out=out[:, d_dense:])
        bits = None
        if table:
            bits = _table_forward(draws["route"], table[0], x, mu, sigma, cfg,
                                  draws["u"], out[:, d_dense:], scales)
        ctx.save_for_backward(x, mu, sigma, bits, draws["pick"],
                              draws["lsel"], draws["psel"], *tables)
        ctx.cfg, ctx.n_dense, ctx.n_lines = cfg, n_dense, n_lines
        ctx.scales, ctx.route = scales, draws["route"]
        return out

    @staticmethod
    def backward(ctx, grad):
        x, mu, sigma, bits, pick, lsel, psel, *tables = ctx.saved_tensors
        cfg, n_dense, n_lines = ctx.cfg, ctx.n_dense, ctx.n_lines
        d_dense = n_dense * cfg.features_per_level
        grids = tables[:n_dense]
        lines = tables[n_dense:n_dense + n_lines]
        table = tables[n_dense + n_lines:]
        if grad.stride(-1) != 1:
            grad = grad.contiguous()
        need = ctx.needs_input_grad[8:]
        g_grids = [None] * len(grids)
        g_rest = [None] * (len(lines) + len(table))
        if grids and any(need[:n_dense]):
            dense_bwd = (xla_encoders.dense_encode_xla_backward
                         if cfg.dense_impl == "xla"
                         else dense_kernel.dense_encode_backward_kernel)
            g_grids = dense_bwd(grids, x, mu, sigma, cfg, grad[:, :d_dense])
        if lines and any(need[n_dense:]):
            cp_bwd = (xla_encoders.cp_encode_xla_backward
                      if cfg.cp_impl == "xla"
                      else cp_kernel.cp_encode_backward_kernel)
            g_rest = cp_bwd(lines, x, mu, sigma, cfg, grad[:, d_dense:])
        if table and need[-1]:
            g_rest = [_table_backward(ctx.route, table[0], x, mu, sigma, cfg,
                                      grad[:, d_dense:], bits,
                                      (pick, lsel, psel), ctx.scales)]
        return (None,) * 8 + (*g_grids, *g_rest)


def encode_params(enc_params, x, mu, sigma, cfg: HashConfig, *,
                  stochastic: bool = False,
                  generator: Optional[torch.Generator] = None, u=None,
                  pick=None, lsel=None, psel=None,
                  shard: Optional[LevelShard] = None):
    """enc_params: {"dense": sequence of (G, G, G, F) grids (when
    cfg.dense_levels > 0), "lines": sequence of (3, G_l, R) lines (variant
    "cp") or "table": (L_hashed, T, F) (variant "corner"; (L_hashed, T, 8F)
    "cell")}.  ``stochastic`` (training, corner variant) picks one corner
    per (point, level) from uniforms ``u`` (3, L_hashed, N), and a
    subsampled packed backward routes ``pick``, ``lsel`` and ``psel``
    (``draw_subsample``), each drawn from ``generator`` when not given.
    Under ``cfg.level_axis`` the lines or table are this rank's slices and
    ``shard`` says which (u is then (3, L_hashed / k, N), and the draws of
    the slice's L_hashed / k levels); the blocks are joined by
    ``shard.gather`` (without it: the rank's own columns).
    Returns (N, cfg.out_dim) f32 features, differentiable w.r.t. every grid,
    line and table on both devices."""
    msg = unported(cfg)
    if msg:
        raise NotImplementedError(msg)
    if (cfg.level_axis is None) != (shard is None):
        raise ValueError("a level shard goes with cfg.level_axis, and only "
                         "with it")
    grids, lines, table = [], [], []
    if cfg.dense_levels > 0:
        if "dense" not in enc_params:
            raise ValueError(f"cfg.dense_levels={cfg.dense_levels} but the "
                             "encoder params carry no 'dense' grids")
        grids = list(enc_params["dense"])
    if cfg.num_hashed_levels > 0:
        if cfg.variant == "cp":
            lines = list(enc_params["lines"])
        else:
            table = [enc_params["table"]]
    scales = None if shard is None or not table else shard.scales
    route = hash_route(cfg, stochastic) if table else None
    draws = {"route": route, "u": None, "pick": None, "lsel": None,
             "psel": None}
    if route in STOCHASTIC_ROUTES:
        n_levels, n = table[0].shape[0], x.shape[0]
        draws["u"] = (stoch_uniform((3, n_levels, n), cfg, x.device,
                                    generator) if u is None else u)
        draws.update(draw_subsample(
            route, cfg, n_levels, n, x.device, generator,
            {"pick": pick, "lsel": lsel, "psel": psel}))
    mu, sigma = (torch.as_tensor(v, dtype=torch.float32, device=x.device)
                 for v in (mu, sigma))
    out = _Encode.apply(x, mu, sigma, draws, cfg, scales, len(grids),
                        len(lines), *grids, *lines, *table)
    if shard is None or shard.gather is None or not (lines or table):
        return out
    d_dense = len(grids) * cfg.features_per_level
    return join_level_blocks(out[:, :d_dense],
                             shard.gather(out[:, d_dense:]), len(lines),
                             shard.extent)
