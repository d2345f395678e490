"""Level-parallel (tensor-parallel) encoding over a (data, level) layout of
the world (counterpart of the JAX parallel/level_parallel.py).

The hashed table's level axis is split over the ranks of a level group:
each holds a contiguous slice of L / k levels (and their Adam moments),
encodes its levels for its data shard's points at the slice's scales, and
``comm.gather_cols`` joins the blocks before the MLP, which runs replicated
over the level group.  The gather's backward hands each rank the group's
sum of its block of the cotangent (k times its own block, as JAX's
transpose gives), so table gradients stay local; the MLP, dense-grid and
table gradients are then averaged over the data group only, as in data
parallelism.  Dense coarse levels are replicated and computed on every
rank.  The CP factor lines have no lookups to divide, so the same axis
splits their RANK: each rank holds (3, G_l, R / k) column slices of every
level's lines, and the gathered blocks are put back in the single-device
level-major, rank-minor order (ops/hash_encoding.py).  The factor-line TV
is summed over the level group (train/step.py).

All level ranks of one data shard draw the same rays and sample positions
(their generator folds the data index only); in stochastic mode each level
rank draws its corner uniforms from a stream of its own (JAX
``_fold_level_axis``).  ``shard_lp_state`` cuts a whole train state into this
rank's, ``gather_lp_state`` joins the shards back into the single-device
state that the checkpoint writes.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Optional

import torch
from torch import nn

from human_body_reconstruction_tpu_torch.ops.hash_encoding import LevelShard
from human_body_reconstruction_tpu_torch.parallel import comm
from human_body_reconstruction_tpu_torch.parallel import data_parallel as dp
from human_body_reconstruction_tpu_torch.train import state as state_lib
from human_body_reconstruction_tpu_torch.train import step as step_lib
from human_body_reconstruction_tpu_torch.utils.config import (
    PipelineConfig, fine_scales)

LEVEL_AXIS = "level"
ENCODER_STREAM = 1      # the word that keys the encoder's draws apart


def make_lp_mesh(n_data: int, n_level: int) -> comm.Mesh:
    """The (data, level) layout over the whole world; either extent may be
    1."""
    return comm.make_mesh(n_data, n_level, LEVEL_AXIS)


def validate(cfg: PipelineConfig, shape, batch_size: Optional[int]):
    """Refuse a (n_data, n_level) layout the config cannot split, with the
    JAX ``_validate`` messages."""
    h = cfg.hash
    n_data, n_level = shape
    if h.variant == "cp":
        if h.cp_rank % n_level:
            raise ValueError(
                f"cp_rank {h.cp_rank} not divisible by the level-axis "
                f"extent {n_level} (variant='cp' shards the rank axis)")
    elif h.num_hashed_levels % n_level:
        raise ValueError(
            f"hashed level count {h.num_hashed_levels} not divisible by "
            f"the level-axis extent {n_level} (dense levels are "
            "replicated; only the hashed ladder shards)")
    elif h.grad_level_pair and (h.num_hashed_levels // n_level) % 2:
        # a rank pairs the levels of its own slice (JAX reshapes the
        # slice's (L / k, N) draws to pairs and fails on an odd count);
        # the message is HashConfig's for an odd pair count
        raise ValueError(
            "grad_level_pair needs an even number of hashed levels, got "
            f"{h.num_hashed_levels // n_level} in each of the {n_level} "
            "level slices")
    if batch_size is not None and batch_size % n_data:
        raise ValueError(f"batch_size {batch_size} not divisible by the "
                         f"data-axis extent {n_data}")


def lp_cfg(cfg: PipelineConfig) -> PipelineConfig:
    return dataclasses.replace(
        cfg, hash=dataclasses.replace(cfg.hash, level_axis=LEVEL_AXIS))


def _slice(cfg: PipelineConfig, mesh: comm.Mesh):
    """(start, stop) of this rank's table levels or line columns."""
    h, k, i = cfg.hash, mesh.n_inner, mesh.inner_index
    per = (h.cp_rank if h.variant == "cp" else h.num_hashed_levels) // k
    return i * per, (i + 1) * per


def level_shard(cfg: PipelineConfig, mesh: comm.Mesh) -> LevelShard:
    """The encoder's view of this rank: the level group's size, for a hashed
    table the f32 scales of its level slice (JAX ``level_scales_array``
    sliced), and the group's ``gather_cols`` and ``psum_replicated``."""
    lo, hi = _slice(cfg, mesh)
    scales = None if cfg.hash.variant == "cp" else fine_scales(cfg.hash)[lo:hi]
    group = mesh.inner_group
    return LevelShard(mesh.n_inner, scales,
                      functools.partial(comm.gather_cols, group=group),
                      functools.partial(comm.psum_replicated, group=group))


def _cut(t, cfg: PipelineConfig, lo: int, hi: int):
    """A table's level slice, or a line's rank columns."""
    return t[..., lo:hi] if cfg.hash.variant == "cp" else t[lo:hi]


def _copy(field):
    """A deep copy of the field without its level shard (the process group
    in its collectives does not copy)."""
    return copy.deepcopy(field, {id(field.lp): None})


def _sharded(field):
    """The field's sharded parameters: its lines, or its table."""
    return list(field.lines) if len(field.lines) else [field.table]


@torch.no_grad()
def shard_field(field, cfg: PipelineConfig, mesh: comm.Mesh):
    """This rank's field from a whole one: the table's level slice or the
    lines' rank columns, the rest copied; ``lp`` set."""
    validate(cfg, mesh.shape, None)
    lo, hi = _slice(cfg, mesh)
    local = _copy(field)
    if len(field.lines):
        local.lines = nn.ParameterList(
            nn.Parameter(_cut(ln.detach(), cfg, lo, hi).clone())
            for ln in field.lines)
    else:
        local.table = nn.Parameter(
            _cut(field.table.detach(), cfg, lo, hi).clone())
    local.lp = level_shard(cfg, mesh)
    return local


def _moved_moments(src_opt, dst_opt, pairs, count: int, fn):
    """Install fn(moment) of each (source, destination) parameter pair's
    Adam state."""
    for p, q in pairs:
        m, v = src_opt.moments(p)
        dst_opt.set_moments(q, count, fn(m, p), fn(v, p))


def shard_lp_state(state, cfg: PipelineConfig, mesh: comm.Mesh,
                   total_steps: int):
    """This rank's train state from a whole one (JAX ``shard_lp_state``):
    the sharded parameters and their Adam moments cut, the rest copied."""
    lo, hi = _slice(cfg, mesh)
    field = shard_field(state.field, cfg, mesh)
    opt = state_lib.make_optimizer(cfg.train, total_steps, field)
    sharded = {id(p) for p in _sharded(state.field)}
    _moved_moments(
        state.opt, opt, zip(state.field.parameters(), field.parameters()),
        state.step,
        lambda m, p: _cut(m, cfg, lo, hi) if id(p) in sharded else m)
    return state_lib.TrainState(state.step, field, opt, state.occ)


def _joined(t, cfg: PipelineConfig, group):
    parts = comm.all_gather_stack(t.detach().contiguous(), group)
    return torch.cat(list(parts), dim=-1 if cfg.hash.variant == "cp" else 0)


@torch.no_grad()
def gather_lp_state(state, cfg: PipelineConfig, mesh: comm.Mesh,
                    total_steps: int = 1):
    """The whole (single-device) train state joined from the level group's
    shards; every rank of the group calls it and gets it."""
    group = mesh.inner_group
    field = _copy(state.field)
    if len(field.lines):
        field.lines = nn.ParameterList(
            nn.Parameter(_joined(ln, cfg, group)) for ln in state.field.lines)
    else:
        field.table = nn.Parameter(_joined(state.field.table, cfg, group))
    opt = state_lib.make_optimizer(cfg.train, total_steps, field)
    sharded = {id(p) for p in _sharded(state.field)}
    _moved_moments(
        state.opt, opt, zip(state.field.parameters(), field.parameters()),
        state.step,
        lambda m, p: _joined(m, cfg, group) if id(p) in sharded else m)
    return state_lib.TrainState(state.step, field, opt, state.occ)


def make_lp_train_step(cfg: PipelineConfig, batch_size: int,
                       mesh: comm.Mesh,
                       steps_per_call: int = 1) -> dp.ParallelStep:
    """The level- and data-parallel step (a ``dp.ParallelStep``), in place
    on this rank's state (from ``shard_lp_state``): ``steps_per_call``
    updates of the global ``batch_size``-ray batch a call.  Rays and
    samples are drawn from (seed, step, data index), the stochastic
    encoder's uniforms from (seed, step, data index, ENCODER_STREAM, level
    index); the gather and the TV's psum over the level group run inside a
    captured window."""
    validate(cfg, mesh.shape, batch_size)
    cfg_lp = lp_cfg(cfg)
    local_batch = batch_size // mesh.n_data
    seed = cfg.train.seed

    def streams(step_no):
        words = [(seed, step_no, mesh.data_index)]
        if cfg.hash.stochastic_train:
            words.append((seed, step_no, mesh.data_index, ENCODER_STREAM,
                          mesh.inner_index))
        return words

    def update(state, scene, images, c2ws, K, gens, feed):
        batch = step_lib.sample_ray_batch(
            images, c2ws, K, local_batch, gens[0], feed.get("img_idx"),
            feed.get("pix_idx"))
        return dp.reduced_step(state, scene, batch, cfg_lp, mesh.data_group,
                               mesh.n_data, generator=gens[0],
                               enc_generator=gens[1] if len(gens) > 1
                               else None, draws=feed.get("draws"),
                               placement=feed.get("placement"))

    return dp.ParallelStep(update, streams, mesh, steps_per_call)


def make_lp_render(cfg: PipelineConfig, mesh: comm.Mesh,
                   num_samples: int = 128, hierarchical: bool = False,
                   compute_dtype=None, chunk: int = 16384):
    """render(field, scene, rays_o, rays_d, dir_norm, occ=None) -> (N, 3):
    the eval branch with rays split over the data group and the encoder
    over the level group (JAX ``make_lp_render``); every rank of the world
    calls it and gets the colours."""
    validate(cfg, mesh.shape, None)
    cfg_lp = lp_cfg(cfg)

    def render(field, scene, rays_o, rays_d, dir_norm, occ=None):
        return dp.render_split(
            lambda o, d, n: step_lib.render_rays_chunked(
                field, scene, o, d, n, cfg_lp, occ=occ,
                num_samples=num_samples, chunk=chunk,
                hierarchical=hierarchical,
                bf16=compute_dtype == torch.bfloat16),
            mesh, rays_o, rays_d, dir_norm)

    return render
