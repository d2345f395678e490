"""Ray-batch data parallelism over a world of ranks (counterpart of the JAX
parallel/data_parallel.py).

Every rank holds the whole model and its optimizer (``replicate``
broadcasts rank 0's at the start) and draws its own ``batch / n`` rays from
a generator folded from (seed, step, data index), the JAX ``fold_in(
fold_in(key, step), axis)``.  After the backward, one all-reduce over a
flat buffer averages the gradients over the data group, then another the
loss and aux metrics (JAX ``pmean``); every rank then applies the same
update, so the replicas stay equal without a broadcast.  The global batch
must divide by n, as in JAX.  ``make_dp_render`` splits a render's rays
over the ranks, with no collective in the render, and gathers the colours.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from human_body_reconstruction_tpu_torch.parallel import comm
from human_body_reconstruction_tpu_torch.train import step as step_lib
from human_body_reconstruction_tpu_torch.utils.config import PipelineConfig


def make_mesh(n: Optional[int] = None) -> comm.Mesh:
    """The 1-D data layout over the whole world (JAX ``make_mesh``): n data
    ranks (the world's size by default), an inner axis of 1."""
    return comm.make_mesh(n or dist.get_world_size(), 1, comm.DATA_AXIS)


def compute_dtype_of(cfg: PipelineConfig):
    return torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else None


def reduced_step(state, scene, batch, cfg: PipelineConfig, group, n: int, *,
                 generator=None, enc_generator=None, draws=None,
                 placement=None) -> dict:
    """One optimizer step, in place on ``state``, whose gradients, loss and
    aux are averaged over ``group`` (n ranks) before the update; the shared
    body of the data- and level-parallel steps.  Returns the metrics."""
    state.opt.zero_grad()
    loss, aux = step_lib.loss_fn(
        state.field, scene, batch, cfg, state.occ, compute_dtype_of(cfg),
        step=state.step, generator=generator, draws=draws,
        placement=placement, enc_generator=enc_generator)
    loss.backward()
    comm.all_reduce_mean_([p.grad for p in state.field.parameters()
                           if p.grad is not None], group, n)
    metrics = torch.stack([loss.detach(), *(v.detach() for v in aux.values())])
    comm.all_reduce_mean_([metrics], group, n)
    state.opt.step(state.step)
    state.step += 1
    return dict(zip(["loss", *aux], metrics.unbind()))


def make_dp_train_step(cfg: PipelineConfig, batch_size: int, mesh: comm.Mesh):
    """The data-parallel step: step(state, scene, images, c2ws, K, *,
    generator=None, img_idx=None, pix_idx=None, draws=None, placement=None)
    -> metrics, one update of the global ``batch_size``-ray batch, in place
    on ``state``.  ``generator`` replaces the folded one; ``img_idx`` and
    ``pix_idx`` (this rank's batch / n), ``draws`` and ``placement`` replace
    the draws, as in ``train.step``."""
    n = mesh.n_data
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh "
                         f"size {n}")
    local_batch = batch_size // n

    def step(state, scene, images, c2ws, K, *, generator=None, img_idx=None,
             pix_idx=None, draws=None, placement=None):
        if generator is None:
            generator = comm.fold_generator(images.device, cfg.train.seed,
                                            state.step, mesh.data_index)
        batch = step_lib.sample_ray_batch(images, c2ws, K, local_batch,
                                          generator, img_idx, pix_idx)
        return reduced_step(state, scene, batch, cfg, mesh.data_group, n,
                            generator=generator, draws=draws,
                            placement=placement)

    return step


@torch.no_grad()
def replicate(state, group=None):
    """Overwrite every rank's parameters with rank 0's (JAX
    ``replicate_to_mesh``): the replicas start equal."""
    comm.broadcast_(list(state.field.parameters()), 0, group)


def render_split(render_local, mesh: comm.Mesh, rays_o, rays_d, dir_norm):
    """Render this data index's contiguous share of the rays with
    ``render_local(o, d, n) -> (B, 3)`` and gather every share (the count
    padded to a multiple of the data extent by repeating the last ray);
    returns the (N, 3) colours on every rank."""
    n_rays = rays_o.shape[0]
    per = -(-n_rays // mesh.n_data)
    idx = torch.arange(mesh.data_index * per, (mesh.data_index + 1) * per,
                       device=rays_o.device).clamp(max=n_rays - 1)
    rgb = render_local(rays_o[idx], rays_d[idx], dir_norm[idx])
    return comm.all_gather_stack(rgb, mesh.data_group).reshape(
        per * mesh.n_data, 3)[:n_rays]


def make_dp_render(cfg: PipelineConfig, mesh: comm.Mesh,
                   num_samples: int = 256, hierarchical: bool = False):
    """render(field, scene, rays_o, rays_d, dir_norm, occ=None) -> (N, 3):
    the eval branch in bf16 with each rank's share of the rays, gathered
    (JAX ``make_dp_render``)."""
    def render(field, scene, rays_o, rays_d, dir_norm, occ=None):
        return render_split(
            lambda o, d, n: step_lib.render_rays_chunked(
                field, scene, o, d, n, cfg, occ=occ, num_samples=num_samples,
                hierarchical=hierarchical, bf16=True),
            mesh, rays_o, rays_d, dir_norm)

    return render
