"""PyTorch port vs the JAX package: the hash-grid variants.

The packed tables (bf16 pairs, int8 words with their per-level scales), the
packed stochastic forwards on JAX's own uniforms, the packed-exact and cell
forwards, every table gradient (the subsampled ones given JAX's own draws
pick, lsel and psel, made from its key as its forwards make them), the three
scatter strategies, ``encode``'s branch for every quality-matrix mode, one
training step of three modes against the JAX ``loss_fn``, twelve steps of
the int8 level-pair mode through its occupancy grid's install against the
JAX ``train_step``, a JAX-written int8 run served by the port, and a port
int8 run restored by JAX.  Small widths
(L 4, T 2^10, tables lifted to U(-1, 1)); test names avoid the words that
tests/conftest.py marks slow.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu.models import nerf as jnerf
from human_body_reconstruction_tpu.ops import hash_encoding as jhe
from human_body_reconstruction_tpu.ops import occupancy as jocc
from human_body_reconstruction_tpu.ops import sampling as jsampling
from human_body_reconstruction_tpu.pipeline import restore as jrestore
from human_body_reconstruction_tpu.train import checkpoint as jckpt
from human_body_reconstruction_tpu.train import state as jstate
from human_body_reconstruction_tpu.train import step as jstep
from human_body_reconstruction_tpu.train import trainer as jtrainer
from human_body_reconstruction_tpu_torch.cli import (
    quality_holdout as qh, serve, train_hash)
from human_body_reconstruction_tpu_torch.ops import (
    cuda_lib, hash_encoding, hash_kernel, hash_variants as hv, occupancy)
from human_body_reconstruction_tpu_torch.pipeline import restore
from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
from human_body_reconstruction_tpu_torch.train import state as state_lib
from human_body_reconstruction_tpu_torch.train import step
from human_body_reconstruction_tpu_torch.utils import config as C
from test_torch_hash import (  # noqa: F401
    LO, HI, B, camera, jax_render, small_dataset, t)
from torch_threads import one_torch_thread  # noqa: F401

N = 600
MU = np.array([-1.0, -2.0, -0.5], np.float32)
SIGMA = np.float32(3.0)


def vcfg(**kw) -> C.HashConfig:
    base = dict(num_levels=4, log2_table_size=10, n_max=128,
                features_per_level=2)
    base.update(kw)
    return C.HashConfig(**base)


BF16 = dict(stochastic_train=True, packed=True)
INT8 = dict(stochastic_train=True, packed=True, pack_format="int8",
            features_per_level=4)


def points(seed=0, n=N):
    """World points, a quarter of them outside the unit box of normalised
    coordinates on one axis."""
    rng = np.random.default_rng(seed)
    xn = rng.uniform(0.0, 1.0, (n, 3))
    out = rng.permutation(n)[:n // 4]
    xn[out, rng.integers(0, 3, n // 4)] = rng.uniform(-0.5, 1.5, n // 4)
    return (MU + xn * SIGMA).astype(np.float32)


def table_for(cfg, seed=0):
    rng = np.random.default_rng(seed + 100)
    return rng.uniform(-1, 1, (cfg.num_hashed_levels, cfg.table_size,
                               cfg.payload)).astype(np.float32)


def jargs(table, x):
    return (jnp.asarray(table), jnp.asarray(x), jnp.asarray(MU),
            jnp.asarray(SIGMA))


def jax_draws(cfg, key, n=N):
    """The uniforms and the subsampling draws JAX's packed forwards make
    from ``key`` (no level axis): u, then pick, lsel, psel where the config
    asks for them (None elsewhere), as numpy."""
    L, F = cfg.num_hashed_levels, cfg.features_per_level
    out = {"u": np.asarray(jax.random.uniform(key, (3, L, n)))}
    int8 = cfg.pack_format == "int8"
    if cfg.grad_subsample:
        k1 = jax.random.fold_in(key, 1)
        out["pick"] = np.asarray(
            jax.random.randint(k1, (L, n), 0, F) if int8
            else jax.random.bernoulli(k1, 0.5, (L, n))).astype(np.uint8)
    if cfg.grad_level_subsample:
        out["lsel"] = np.asarray(jax.random.randint(
            jax.random.fold_in(key, 2), (n,), 0, L)).astype(np.uint8)
    if cfg.grad_level_pair:
        out["psel"] = np.asarray(jax.random.randint(
            jax.random.fold_in(key, 3), (L // 2, n), 0, 2)).astype(np.uint8)
    return out


def port_encode(table, x, cfg, stochastic=False, draws=None):
    kw = {k: t(v) for k, v in (draws or {}).items()}
    return hash_encoding.encode_params({"table": table}, t(x), t(MU),
                                       t(SIGMA), cfg, stochastic=stochastic,
                                       **kw)


# ------------------------------------------------------------------ packing

def tie_table(fmt: str, F: int):
    """A table whose packing meets ties: int8, each level's max 127 so the
    scaled values are the entries, many of them k + 0.5; bf16, entries whose
    low 16 bits are exactly 0x8000."""
    rng = np.random.default_rng(3)
    tab = rng.uniform(-1, 1, (3, 256, F)).astype(np.float32)
    if fmt == "int8":
        tab[:, 0, 0] = 127.0
        tab[:, 1:200, :] = (rng.integers(-126, 126, (3, 199, F))
                            + 0.5).astype(np.float32)
        tab[1, 0, 0] = -127.0          # the max by magnitude, negative
        tab[2] *= 1e-3                 # a scale away from 127
    else:
        bits = tab.view(np.uint32)
        bits[:, :128] = (bits[:, :128] & 0xFFFF0000) | 0x8000
    return tab


@pytest.mark.parametrize("fmt,F,edit", [
    ("bf16", 2, None), ("int8", 2, None), ("int8", 3, None), ("int8", 4, None),
    ("int8", 1, None), ("int8", 4, "zero_level"), ("int8", 4, "max_last")],
    ids=["bf16", "int8_f2", "int8_f3", "int8_f4", "int8_f1",
         "int8_f4_zero_level", "int8_f4_max_last"])
def test_pack_tables_match_jax_bit_for_bit(fmt, F, edit):
    """Words and scales equal JAX ``pack_table_bf16``/``pack_table_int8``
    bit for bit, on tables with ties (round half to even decides them), a
    level of zeros (scale 1e-12) or a level whose max is its last entry, and
    the kernel wrapper on the CPU is the plain version."""
    tab = tie_table(fmt, F)
    if edit == "zero_level":
        tab[2] = 0.0
    elif edit == "max_last":
        tab[2, -1, -1] = -3.0          # the others within 1e-3
    if fmt == "int8":
        s = np.abs(tab).max(axis=(1, 2)) + np.float32(1e-12)
        scaled = tab / s[:, None, None] * np.float32(127.0)
        assert (scaled[:2] == np.floor(scaled[:2]) + 0.5).sum() > min(
            500, 300 * F)
        jw, js = jhe.pack_table_int8(jnp.asarray(tab))
    else:
        assert ((tab.view(np.uint32) & 0xFFFF) == 0x8000).sum() > 500
        jw, js = jhe.pack_table_bf16(jnp.asarray(tab)), None
    pw, ps = hv.pack_kernel(torch.tensor(tab), fmt)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw).view(np.int32))
    if fmt == "int8":
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        if edit == "zero_level":
            assert ps[2] == np.float32(1e-12) and not pw.reshape(3, -1)[2].any()
        if edit == "max_last":
            assert (np.asarray(jw)[-1] >> (8 * (F - 1))) & 0xFF == 0x81
        b = (np.asarray(jw)[:, None] >> (8 * np.arange(F))) & 0xFF
        assert set(np.unique(b)) >= {0x7F, 0x81}     # +-127 both reached
    else:
        assert ps is None


# ------------------------------------------------------------------ forwards

@pytest.mark.parametrize("kind", ["bf16", "int8", "int8_f2"])
def test_packed_stochastic_forward_matches_jax(kind):
    """The packed bf16 and int8 stochastic encodes on JAX's uniforms equal
    JAX's bit for bit, and their corner bits are (u < frac) of the f32
    stochastic encode's."""
    cfg = vcfg(**(BF16 if kind == "bf16" else INT8))
    if kind == "int8_f2":
        cfg = dataclasses.replace(cfg, features_per_level=2)
    table, x = table_for(cfg), points(1)
    key = jax.random.PRNGKey(4)
    fn = (jhe.hash_encode_stochastic_packed if kind == "bf16"
          else jhe.hash_encode_stochastic_int8)
    ref = np.asarray(fn(*jargs(table, x), cfg, key))
    u = jax_draws(cfg, key)["u"]
    port = port_encode(t(table), x, cfg, True, {"u": u})
    np.testing.assert_array_equal(port.numpy(), ref)
    route = hash_encoding.hash_route(cfg, True)
    words, scale = hv.pack_kernel(t(table), cfg.pack_format)
    feats, bits = hv.packed_encode_kernel(words, scale, t(x), t(MU), t(SIGMA),
                                          cfg, u=t(u))
    assert torch.equal(feats, port) and route != "hash_encode_stochastic"
    _, want = hash_kernel.hash_encode_plain(t(table), t(x), t(MU), t(SIGMA),
                                            cfg, t(u))
    assert torch.equal(bits, want)


# Exact trilerps summed over the same 8 corners in JAX's order: rtol 0,
# atol 1e-6.
@pytest.mark.parametrize("kind", ["bf16", "int8", "cell"])
def test_packed_exact_and_cell_forwards_match_jax(kind):
    if kind == "cell":
        cfg = vcfg(variant="cell")
        fn = jhe.hash_encode_cell
    else:
        cfg = vcfg(**(BF16 if kind == "bf16" else INT8))
        fn = jhe.hash_encode_packed_exact
    table, x = table_for(cfg, 2), points(2)
    assert table.shape[-1] == (16 if kind == "cell" else
                               cfg.features_per_level)
    ref = np.asarray(fn(*jargs(table, x), cfg))
    port = port_encode(t(table), x, cfg)
    assert port.shape == ref.shape == (N, 4 * cfg.features_per_level)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-6)
    exact = jhe.hash_encode(*jargs(table[..., :cfg.features_per_level], x),
                            cfg)
    assert np.abs(ref - np.asarray(exact)).max() > 1e-3


# -------------------------------------------------------------- gradients

GRAD_CASES = {
    "bf16": BF16, "bf16_gsub": dict(BF16, grad_subsample=True),
    "int8": INT8, "int8_gsub": dict(INT8, grad_subsample=True),
    "int8_lvl": dict(INT8, grad_subsample=True, grad_level_subsample=True),
    "int8_lpair": dict(INT8, grad_subsample=True, grad_level_pair=True),
    "bf16_gsub_sorted": dict(BF16, grad_subsample=True,
                             scatter_strategy="sorted"),
    "bf16_segsum": dict(BF16, scatter_strategy="segsum"),
    "int8_lpair_segsum": dict(INT8, grad_subsample=True, grad_level_pair=True,
                              scatter_strategy="segsum"),
    "int8_sorted": dict(INT8, scatter_strategy="sorted"),
    "packed_exact": dict(packed=True, packed_exact_train=True),
    "packed_exact_int8": dict(packed=True, packed_exact_train=True,
                              pack_format="int8", features_per_level=4),
    "cell": dict(variant="cell"),
    "int8_lvl_f1": dict(INT8, features_per_level=1, grad_subsample=True,
                        grad_level_subsample=True),
    "int8_lpair_f1": dict(INT8, features_per_level=1, grad_subsample=True,
                          grad_level_pair=True),
    "int8_lvl_level_undrawn": dict(INT8, grad_subsample=True,
                                   grad_level_subsample=True),
    "int8_lvl_one_cell": dict(INT8, grad_subsample=True,
                              grad_level_subsample=True),
    "int8_lpair_one_cell": dict(INT8, grad_subsample=True,
                                grad_level_pair=True),
    "cell_one_cell": dict(variant="cell"),
}
# Cases whose draws or points are edited: the stochastic ones held to JAX's
# ``_stoch_int8_bwd`` given the edited draws (no point draws level 1; every
# point in one cell of each level), the cell variant to the VJP of JAX
# ``hash_encode_cell`` (every point in one cell: a level's terms all on one
# row).
GRAD_EDGES = {"int8_lvl_level_undrawn": "level_undrawn",
              "int8_lvl_one_cell": "one_cell",
              "int8_lpair_one_cell": "one_cell",
              "cell_one_cell": "one_cell"}


def one_cell_points(seed=5, n=N):
    """World points within 1e-7 of one another in normalised coordinates:
    one cell of every level (checked by the caller)."""
    xn = 0.3 + np.random.default_rng(seed).uniform(0.0, 1e-7, (n, 3))
    return (MU + xn * SIGMA).astype(np.float32)


# Table gradients: the same terms summed in other orders (XLA's scatter,
# index_add_, the sorted sums): ||port - jax|| <= 1e-5 ||jax||.
@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_table_gradients_match_jax(case):
    cfg = vcfg(**GRAD_CASES[case])
    edit = GRAD_EDGES.get(case)
    table = table_for(cfg, 3)
    x = one_cell_points() if edit == "one_cell" else points(3)
    key = jax.random.PRNGKey(7)
    route = hash_encoding.hash_route(cfg, cfg.stochastic_train)
    fn = getattr(jhe, route)
    stochastic = route in hash_encoding.STOCHASTIC_ROUTES
    extra = (key,) if stochastic else ()
    L, F = cfg.num_hashed_levels, cfg.features_per_level
    g = np.random.default_rng(4).normal(size=(N, L * F)).astype(np.float32)
    draws = jax_draws(cfg, key) if stochastic else None
    if edit == "one_cell":
        xn = (t(x) - t(MU)) / t(SIGMA)
        for s in hash_kernel._scales(cfg):
            assert len(torch.unique(hash_kernel.level_coords(
                xn, float(s))[0], dim=0)) == 1
    if edit is None or not stochastic:
        _, vjp = jax.vjp(lambda tb: fn(tb, *jargs(table, x)[1:], cfg, *extra),
                         jnp.asarray(table))
        ref = np.asarray(vjp(jnp.asarray(g))[0])
    else:
        if edit == "level_undrawn":
            draws["lsel"][draws["lsel"] == 1] = 0
        _, (rows, *_, tshape) = jhe._stoch_int8_fwd(*jargs(table, x), cfg,
                                                    key)
        sel = [None if draws.get(k) is None else
               jnp.asarray(draws[k].astype(np.int32))
               for k in ("pick", "lsel", "psel")]
        ref = np.asarray(jhe._stoch_int8_bwd(cfg, (rows, *sel, tshape),
                                             jnp.asarray(g))[0])
    tp = t(table).requires_grad_(True)
    out = port_encode(tp, x, cfg, stochastic, draws)
    (out * t(g)).sum().backward()
    assert tp.grad.shape == ref.shape and np.abs(ref).max() > 0.1
    rel = np.linalg.norm(tp.grad.numpy() - ref) / np.linalg.norm(ref)
    assert rel <= 1e-5, rel
    if cfg.grad_subsample:      # one value a routed (point, level)
        routed = N * (1 if cfg.grad_level_subsample else L // 2
                      if cfg.grad_level_pair else L)
        assert 0 < np.count_nonzero(ref) <= routed
    if edit == "level_undrawn":
        assert not ref[1].any() and not tp.grad[1].any()
    elif edit == "one_cell":    # on the cell's 8 rows (cell: its one row)
        assert (np.count_nonzero(ref.reshape(L, -1), axis=1) <= 8 * F).all()


def scatter_layout(layout: str):
    """(indices, values) of a run layout over 400 entries: "mixed", random
    indices with one run of 1000; "long_run", a run of 70,000 pairs (longer
    than any tile of the segsum kernel, 2048 pairs) among 5000 random ones;
    "tile_edges", runs of a tile less one, a tile and a tile and one, at
    2048 and 4096 pairs, from the first, with single pairs between;
    "one_index", every pair on the last index."""
    rng = np.random.default_rng(6)
    if layout == "mixed":
        idx = rng.integers(0, 300, 5000)
        idx[:1000] = 7                                 # one long run
    elif layout == "long_run":
        idx = np.concatenate([np.full(70_000, 11), rng.integers(0, 400, 5000)])
        rng.shuffle(idx)
    elif layout == "tile_edges":
        lens = (2047, 2048, 2049, 4095, 4096, 4097)
        idx = np.concatenate([np.concatenate([np.full(n, 2 * i), [2 * i + 1]])
                              for i, n in enumerate(lens)]
                             + [rng.integers(12, 400, 300)])
    else:
        idx = np.full(9000, 399)
    return (idx.astype(np.int32),
            rng.normal(size=len(idx)).astype(np.float32))


@pytest.mark.parametrize("layout", ["mixed", "long_run", "tile_edges",
                                    "one_index"])
@pytest.mark.parametrize("strategy", ["random", "sorted", "segsum"])
def test_scatter_strategies_match_jax(strategy, layout):
    """``scatter`` sums what JAX ``scatter_add_flat`` sums, duplicates
    included, at each ``scatter_layout`` (f32 reassociation: atol 1e-5 for
    the mixed layout's runs of up to 1000 terms; the sum-order tolerance,
    2^-18 of the terms' absolute sum, for the runs of 4095 to 70,000); the
    sorted strategies through ``scatter`` and the add wrapper on the CPU are
    the plain version."""
    idx, val = scatter_layout(layout)
    ref = np.asarray(jhe.scatter_add_flat(400, jnp.asarray(idx),
                                          jnp.asarray(val), strategy))
    got = hv.scatter_plain(400, t(idx), t(val), strategy)
    if layout == "mixed":
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    else:
        abs_sum = hv.scatter_plain(400, t(idx), t(np.abs(val)))
        assert bool(((got - t(ref)).abs() <= cuda_lib.sum_order_tolerance(
            t(ref), abs_sum, False)).all())
    if strategy != "random":
        assert torch.equal(hv.scatter(400, t(idx), t(val), strategy), got)
        assert torch.equal(hv.add_sorted_kernel(
            400, *hv.sort_pairs(t(idx), t(val)), strategy), got)
    assert np.count_nonzero(ref) == len(np.unique(idx))


# ------------------------------------------------------------------- routes

@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_encode_routes_match_jax_for_every_mode(train, monkeypatch):
    """For the hash config of each of the 60 quality-matrix modes (and its
    holdout's, stochastic_train off), in training (``stochastic`` as the
    trainer passes it) and at evaluation: JAX ``encode`` calls the function
    that ``hash_route`` names.  No mode is refused."""
    for name in ("hash_encode_cell", "hash_encode_stochastic_int8",
                 "hash_encode_stochastic_packed", "hash_encode_stochastic",
                 "hash_encode_packed_exact", "hash_encode"):
        monkeypatch.setattr(jhe, name, lambda *a, _n=name, **k: _n)
    assert qh.refused_modes() == {}
    seen = set()
    for mode, cfg in qh.all_modes().items():
        for h in (cfg.hash, qh.eval_config(cfg).hash):
            assert hash_encoding.unported(h) is None, mode
            if h.variant == "cp":
                continue
            stochastic = train and h.stochastic_train
            got = jhe.encode(None, None, None, None, h, key=0,
                             stochastic=stochastic)
            assert hash_encoding.hash_route(h, stochastic) == got, mode
            seen.add(got)
    assert len(seen) == (5 if train else 3)


def test_every_accepted_hash_flag_combination_is_ported(monkeypatch):
    """Every combination of the hash flags (variant, F, stochastic_train,
    packed, pack_format, the three grad_* routings, packed_eval,
    packed_exact_train, scatter_strategy) that JAX's
    ``HashConfig.__post_init__`` accepts is one the port runs, and takes
    JAX ``encode``'s branch in training and at evaluation."""
    import itertools

    from human_body_reconstruction_tpu.utils import config as jC

    for name in ("hash_encode_cell", "hash_encode_stochastic_int8",
                 "hash_encode_stochastic_packed", "hash_encode_stochastic",
                 "hash_encode_packed_exact", "hash_encode"):
        monkeypatch.setattr(jhe, name, lambda *a, _n=name, **k: _n)
    keys = ("variant", "features_per_level", "stochastic_train", "packed",
            "pack_format", "grad_subsample", "grad_level_subsample",
            "grad_level_pair", "packed_eval", "packed_exact_train",
            "scatter_strategy")
    values = (("corner", "cell"), (2, 4), (False, True), (False, True),
              ("bf16", "int8"), (False, True), (False, True), (False, True),
              (False, True), (False, True), ("random", "sorted", "segsum"))
    accepted = 0
    for combo in itertools.product(*values):
        kw = dict(zip(keys, combo))
        try:
            jC.HashConfig(num_levels=4, **kw)
        except ValueError:
            continue
        accepted += 1
        h = vcfg(**kw)
        assert hash_encoding.unported(h) is None, kw
        for train in (True, False):
            stochastic = train and h.stochastic_train
            assert hash_encoding.hash_route(h, stochastic) == jhe.encode(
                None, None, None, None, h, key=0, stochastic=stochastic), kw
    assert accepted > 500


@pytest.mark.parametrize("flags,want", [
    (dict(pack_format="bf16", features_per_level=4),
     ("hash_encode_stochastic", "hash_encode")),
    (dict(packed_eval=False), ("hash_encode_stochastic_packed",
                               "hash_encode")),
    (dict(packed_exact_train=True, pack_format="int8"),
     ("hash_encode_stochastic_int8", "hash_encode_packed_exact")),
    (dict(variant="cell", packed=False),
     ("hash_encode_cell", "hash_encode_cell"))],
    ids=["bf16_f4", "no_packed_eval", "exact_train_int8", "cell"])
def test_encode_route_edge_cases(flags, want, monkeypatch):
    """JAX's branch order, against JAX ``encode`` in training and at
    evaluation: bf16 at F 4 falls through to the f32 stochastic path;
    packed_eval off reads the f32 table at evaluation; packed-exact training
    of a stochastic config keeps the stochastic path in training; the cell
    variant ignores ``stochastic``."""
    for name in set(want):
        monkeypatch.setattr(jhe, name, lambda *a, _n=name, **k: _n)
    h = vcfg(**{**dict(stochastic_train=True, packed=True), **flags})
    got = tuple(hash_encoding.hash_route(h, s) for s in (True, False))
    assert got == want == tuple(
        jhe.encode(None, None, None, None, h, key=0, stochastic=s)
        for s in (True, False))


# ---------------------------------------------------------------- one step

def mode_step_cfg(mode: str) -> C.PipelineConfig:
    """A quality-matrix mode's hash flags at a CPU width (T 2^10; the int8
    mode keeps its 2 dense + 6 hashed levels at F 4, f32 dense levels), with
    the small f32 step of test_torch_hash's ``step_cfg``."""
    h = qh.all_modes()[mode].hash
    h = dataclasses.replace(h, log2_table_size=10, init_scale=1.0,
                            dense_bf16=False, dense_impl="xla")
    return C.PipelineConfig(
        hash=h, mlp=C.MLPConfig(width=16),
        render=C.RenderConfig(num_samples=16),
        train=C.TrainConfig(ray_batch=B, compute_dtype="float32"))


def group_grads(grads_j, field):
    """{group: (port flat gradient, JAX flat gradient)}."""
    out = {"table": (field.table.grad.numpy().reshape(-1),
                     np.asarray(grads_j["table"]).reshape(-1)),
           "mlp": (np.concatenate([p.grad.numpy().reshape(-1)
                                   for p in field.mlp.parameters()]),
                   np.concatenate([np.asarray(g).reshape(-1)
                                   for branch in ("sig", "col")
                                   for layer in grads_j["mlp"][branch]
                                   for g in (np.asarray(layer["w"]).T,
                                             layer["b"])]))}
    if len(field.dense):
        out["dense"] = (np.concatenate([g.grad.numpy().reshape(-1)
                                        for g in field.dense]),
                        np.concatenate([np.asarray(g).reshape(-1)
                                        for g in grads_j["dense"]]))
    return out


# One f32 step: the same function, sums in other orders: loss rtol 1e-5,
# gradients per group ||port - jax|| / ||jax|| <= 1e-5.
@pytest.mark.parametrize("mode", ["packed_gsub",
                                  "int8_dense_guided_k32_mass_lpair", "cell"])
def test_mode_step_loss_and_grads_match_jax(mode):
    """One training step of the mode against the JAX ``loss_fn`` from the
    same params, batch, sample placement (JAX's own t: the cell field jumps
    across cell faces, so a t one ulp apart can land in another cell) and
    encoder draws (u, and pick and psel where the mode routes them, made
    from JAX's encoder key)."""
    cfg = mode_step_cfg(mode)
    params = jax.tree.map(np.array, jtrainer.init_params(
        jax.random.PRNGKey(0), cfg))
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
    _, _, k_enc, _ = jax.random.split(key, 4)
    S = cfg.render.num_samples
    jparams = jax.tree.map(jnp.asarray, params)
    jt = jnerf.render_rays(jparams, jrestore.scene_from_bounds(LO, HI),
                           *batch[:3], key, cfg)["t"]
    draws = {}
    if cfg.hash.stochastic_train:
        draws.update({f"enc_{k}": t(v) for k, v in
                      jax_draws(cfg.hash, k_enc, B * S).items()})
    assert set(draws) == ({"enc_u", "enc_pick"} | (
        {"enc_psel"} if "lpair" in mode else set())
        if mode != "cell" else set())
    (loss_j, _), grads_j = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        jparams, jrestore.scene_from_bounds(LO, HI), batch, key, cfg, None,
        None, step=0)
    tbatch = step.sample_ray_batch(t(images), t(c2ws), t(K), B,
                                   img_idx=t(img), pix_idx=t(pix))
    loss_p, _ = step.loss_fn(field, restore.scene_from_bounds(LO, HI), tbatch,
                             cfg, None, None, step=0, draws=draws,
                             placement=(t(jt), None))
    loss_p.backward()
    assert float(loss_p.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    for k, (gp, gj) in group_grads(grads_j, field).items():
        rel = np.linalg.norm(gp - gj) / np.linalg.norm(gj)
        assert rel <= 1e-5, (k, rel)


# Twelve f32 steps of int8_dense_guided_k32_mass_lpair (2 dense + 6 hashed
# levels, F 4, T 2^10, width 16; 16 samples, guided placement of 8 after
# the grid's install at step 4, 16 probes, a 16^3 grid refreshed again at
# step 8 from 2048 cells, the density bias lowered by 0.1 so that the grid
# holds both kinds of cell) against the JAX train_step with the protocol's
# key use: the port's step is handed JAX's batch, placement (t and dt) and
# encoder draws (u, pick, psel), and its refresh JAX's cells and jitter.
# Measured: losses within 9.9e-6 of JAX's (relative), parameters within
# 1.4e-5 of their norm after the last step.  Limits: 1e-4 per loss, 1e-3
# per parameter leaf; the grids equal except at cells a refresh drew twice
# (JAX keeps an unspecified candidate there, the port the largest).
LPAIR_STEPS, LPAIR_INSTALL, LPAIR_REFRESH, LPAIR_CELLS = 12, 4, 8, 2048


def lpair_run_cfg() -> C.PipelineConfig:
    m = qh.all_modes()["int8_dense_guided_k32_mass_lpair"]
    return dataclasses.replace(
        m, hash=mode_step_cfg("int8_dense_guided_k32_mass_lpair").hash,
        mlp=dataclasses.replace(m.mlp, width=16),
        render=dataclasses.replace(m.render, num_samples=16,
                                   compact_samples=8, occ_probes=16,
                                   occupancy_resolution=16),
        train=dataclasses.replace(m.train, ray_batch=B,
                                  compute_dtype="float32",
                                  occ_warmup_steps=LPAIR_INSTALL))


def test_int8_lpair_steps_match_jax_through_the_grid_install():
    cfg = lpair_run_cfg()
    r, g = cfg.render, cfg.render.occupancy_resolution
    assert r.occupancy and r.occ_guided and cfg.hash.dense_levels == 2
    params = jax.tree.map(np.array, jtrainer.init_params(
        jax.random.PRNGKey(0), cfg))
    params["mlp"]["sig"][-1]["b"][0] -= 0.1
    images, c2ws, K = small_dataset()
    jscene, scene = (jrestore.scene_from_bounds(LO, HI),
                     restore.scene_from_bounds(LO, HI))
    sj, tx = jstate.create_train_state(jax.tree.map(jnp.asarray, params),
                                       cfg.train, LPAIR_STEPS)
    sp = state_lib.create_train_state(ckpt.from_jax_params(params, cfg),
                                      cfg.train, LPAIR_STEPS)
    data = tuple(jnp.asarray(a) for a in (images, c2ws, K))
    key, twice = jax.random.PRNGKey(1), np.zeros(g ** 3, bool)
    for i in range(LPAIR_STEPS):
        if i in (LPAIR_INSTALL, LPAIR_REFRESH):
            # the protocol's refresh: JAX update's draws from PRNGKey(steps)
            k1, k2 = jax.random.split(jax.random.PRNGKey(i))
            cells = np.asarray(jax.random.randint(k1, (LPAIR_CELLS,), 0,
                                                  g ** 3))
            jit = np.asarray(jax.random.uniform(k2, (LPAIR_CELLS, 3)))
            sj = sj._replace(occ=jocc.update_from_field(
                sj.occ or jocc.init_grid(g, threshold=r.occ_threshold),
                sj.params, jscene, jax.random.PRNGKey(i), cfg,
                num_cells=LPAIR_CELLS))
            sp.occ = occupancy.update_from_field(
                sp.occ or occupancy.init_grid(g, r.occ_threshold), sp.field,
                scene, cfg, num_cells=LPAIR_CELLS, flat_idx=t(cells).long(),
                jitter=t(jit))
            idx, counts = np.unique(cells, return_counts=True)
            twice[idx[counts > 1]] = True
            mask_j = np.asarray(sj.occ.mask).reshape(-1)
            assert 0.05 < mask_j.mean() < 0.95, (i, mask_j.mean())
            np.testing.assert_array_equal(
                sp.occ.mask.numpy().reshape(-1)[~twice], mask_j[~twice])
        # the JAX step's draws: batch, then placement and encoder keys
        k_batch, k_render = jax.random.split(jax.random.fold_in(key, i))
        k1, k2 = jax.random.split(k_batch)
        img = np.asarray(jax.random.randint(k1, (B,), 0, images.shape[0]))
        pix = np.asarray(jax.random.randint(k2, (B,), 0, 64))
        o, d = jstep.sample_ray_batch(k_batch, *data, B)[:2]
        k_strat, _, k_enc, _ = jax.random.split(k_render, 4)
        if sj.occ is None:
            placement = (t(np.asarray(jsampling.stratified_ts(
                k_strat, (B,), r.near, r.far, r.num_samples,
                per_ray_jitter=r.per_ray_jitter))), None)
        else:
            placement = tuple(t(np.asarray(v)) for v in (
                jsampling.occupancy_guided_ts(
                    k_strat, o, d, sj.occ, jscene["mu"], jscene["sigma"],
                    r.near, r.far, r.compact_samples, num_probe=r.occ_probes,
                    explore_frac=r.occ_explore, dt_mode=r.occ_dt)))
        n = placement[0].numel()
        assert n == B * (r.num_samples if i < LPAIR_INSTALL
                         else r.compact_samples)
        draws = {f"enc_{k}": t(v)
                 for k, v in jax_draws(cfg.hash, k_enc, n).items()}
        assert set(draws) == {"enc_u", "enc_pick", "enc_psel"}
        sj, mj = jstep.train_step(sj, jscene, *data, key, cfg, tx, B)
        sp.opt.zero_grad()
        loss, _ = step.loss_fn(
            sp.field, scene, step.sample_ray_batch(
                t(images), t(c2ws), t(K), B, img_idx=t(img),
                pix_idx=t(pix)), cfg, sp.occ, None, step=sp.step,
            draws=draws, placement=placement)
        loss.backward()
        sp.opt.step(sp.step)
        sp.step += 1
        assert float(loss.detach()) == pytest.approx(float(mj["loss"]),
                                                     rel=1e-4), i
    for a, b in zip(ckpt.jax_leaves(sp.field),
                    jax.tree_util.tree_leaves(sj.params)):
        b = np.asarray(b)
        assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(b)


# ---------------------------------------------------------- run directories

def int8_cfg(**kw) -> C.PipelineConfig:
    return C.PipelineConfig(
        hash=vcfg(**INT8, grad_subsample=True, dense_levels=1,
                  dense_bf16=False, dense_impl="xla", init_scale=0.5, **kw),
        mlp=C.MLPConfig(width=16))


def test_jax_int8_run_serves_in_port(tmp_path):
    """A run directory written by the JAX package for an int8 model (dense
    level, stochastic int8 training config) restores in the port's server,
    which serves it through the packed-exact read, and the frame equals
    JAX's render of the same pose (its eval encode is the packed-exact read
    too; f32, atol 1e-4)."""
    d = str(tmp_path)
    cfg = int8_cfg()
    params = jax.tree.map(np.array, jtrainer.init_params(
        jax.random.PRNGKey(1), cfg))
    params["mlp"]["sig"][-1]["b"][0] += 2.0
    jckpt.save_pytree(os.path.join(d, "j_ckpt.npz"), params)
    C.to_json(cfg, os.path.join(d, "j_config.json"))
    jckpt.save_bounds(os.path.join(d, "bounds_model.npy"), LO, HI)
    server = serve.RenderServer(serve.build_parser().parse_args([
        "--ckpt_dir", d, "--model_name", "j", "--height", "12", "--width",
        "12", "--num_samples", "16", "--fp32", "--device", "cpu"]))
    assert hash_encoding.hash_route(server.base_cfg.hash, False) == \
        "hash_encode_packed_exact"
    n = hv.packed_encode_kernel.launches, hv.pack_kernel.launches
    resp = server.handle({"orbit": {"index": 1, "count": 4},
                          "no_image": True})
    assert resp["ok"], resp
    assert n == (hv.packed_encode_kernel.launches, hv.pack_kernel.launches)
    K, c2w = camera()
    img = step.render_image(server.field, server.scene, 12, 12, t(K), t(c2w),
                            server.base_cfg, num_samples=16).numpy()
    jres = jrestore.restore(d, "j", log_fn=lambda s: None)
    ref = jax_render(jres, K, c2w)
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-4)
    h = server.base_cfg.hash                 # the int8 read, not the f32 one
    table, x = server.field.table.detach(), t(points(5))
    mu, sigma = server.scene["mu"], server.scene["sigma"]
    read = hash_encoding.encode_params({"table": table, "dense": [
        g.detach() for g in server.field.dense]}, x, mu, sigma, h)[:, 4:]
    assert torch.equal(read, hv.packed_encode_plain(
        *hv.pack_plain(table, "int8"), x, mu, sigma, h))
    assert float((read - hash_kernel.hash_encode_plain(
        table, x, mu, sigma, h)).abs().max()) > 1e-4


# A port CLI run (6 steps, int8 words with 1-of-F and level-pair routing,
# plain versions on the CPU) restored and rendered by both packages through
# the packed-exact read, in f32: atol 1e-4 on pixel values.
def test_cli_int8_run_restores_in_jax(tmp_path):
    d = str(tmp_path)
    tr = train_hash.main([
        "--synthetic", "--stochastic", "--packed", "--pack_format", "int8",
        "--features_per_level", "4", "--grad_subsample", "--grad_level_pair",
        "--num_levels", "4", "--hash_size", "10", "--max_res", "64",
        "--num_batch", "128", "--num_samples", "16", "--steps", "6",
        "--log_every", "3", "--device", "cpu", "--out_dir", d,
        "--model_name", "q"])
    h = tr.cfg.hash
    assert (h.pack_format, h.features_per_level, h.grad_subsample,
            h.grad_level_pair) == ("int8", 4, True, True)
    assert tr.state.step == 6
    assert all(np.isfinite(r["loss"]) for r in tr.history)
    jres = jrestore.restore(d, "q", log_fn=lambda s: None)
    pres = restore.restore(d, "q", device="cpu", log_fn=lambda s: None)
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
