"""Multi-scene fitting: S independent models trained at once (counterpart
of the JAX parallel/multi_scene.py).

JAX stacks the S scenes' params on a leading axis and ``vmap``s one step
over it.  The port's encoder kernels are ``autograd.Function``s that
``torch.func.vmap`` does not batch, so here the S fields are a list and a
step is a loop of launches over them: each scene draws its batch from its
own generator (or takes injected draws) and back-propagates into its own
field, then ONE grouped optimizer (``state.GroupedOptimizer`` over every
field) applies the update, and the metrics are the mean over scenes.  The
per-scene occupancy grids ride along.  With a mesh the scenes are split over
the world's ranks, each rank fitting its own S / n scenes; the only
collective is the metric mean.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.ops import occupancy
from human_body_reconstruction_tpu_torch.parallel import comm
from human_body_reconstruction_tpu_torch.parallel import data_parallel as dp
from human_body_reconstruction_tpu_torch.train import state as state_lib
from human_body_reconstruction_tpu_torch.train import step as step_lib
from human_body_reconstruction_tpu_torch.utils.config import PipelineConfig


def init_multi_fields(cfg: PipelineConfig, num_scenes: int,
                      generator: torch.Generator) -> list:
    """S freshly initialised fields, drawn one after another from the
    generator, on its device."""
    return [nerf.Field(cfg, generator=generator) for _ in range(num_scenes)]


def init_multi_occ(num_scenes: int, resolution: int = 128,
                   threshold: float = 0.01, device=None) -> list:
    """S all-occupied grids."""
    return [occupancy.init_grid(resolution, threshold, device)
            for _ in range(num_scenes)]


def update_multi_occ(occs, fields, scenes, cfg: PipelineConfig, generators,
                     num_cells: int = 2 ** 16) -> list:
    """One culling round per scene against its own field."""
    return [occupancy.update_from_field(o, f, sc, cfg, num_cells=num_cells,
                                        generator=g)
            for o, f, sc, g in zip(occs, fields, scenes, generators)]


@dataclasses.dataclass
class MultiState:
    """Step count, the scenes' fields, the one optimizer over them and the
    scenes' occupancy grids (or None)."""

    step: int
    fields: list
    opt: state_lib.GroupedOptimizer
    occ: Optional[list] = None


def create_multi_state(fields, cfg: PipelineConfig, total_steps: int,
                       occ=None) -> MultiState:
    return MultiState(0, list(fields), state_lib.GroupedOptimizer(
        cfg.train, total_steps, list(fields)), occ)


def local_scenes(num_scenes: int, mesh: Optional[comm.Mesh] = None):
    """The scene indices this rank fits: all of them without a mesh, else
    its contiguous S / n."""
    if mesh is None:
        return range(num_scenes)
    n = mesh.n_data
    if num_scenes % n:
        raise ValueError(f"{num_scenes} scenes not divisible by mesh size {n}")
    per = num_scenes // n
    return range(mesh.data_index * per, (mesh.data_index + 1) * per)


def make_multi_train_step(cfg: PipelineConfig, batch_per_scene: int,
                          mesh: Optional[comm.Mesh] = None):
    """step(state, scenes, images, c2ws, Ks, generators, *, batch_idx=None,
    draws=None) -> metrics: one update of this rank's scenes, in place on
    ``state`` (whose lists hold this rank's scenes, in order).  ``scenes``,
    ``images``, ``c2ws``, ``Ks`` and ``generators`` are per-scene lists;
    ``batch_idx`` a list of (img_idx, pix_idx) and ``draws`` a list of
    ``render_rays`` draws replace the draws.  The metrics are the mean over
    every scene of the mesh."""
    compute_dtype = dp.compute_dtype_of(cfg)

    def step(state: MultiState, scenes, images, c2ws, Ks, generators, *,
             batch_idx=None, draws=None):
        state.opt.zero_grad()
        per_scene = []
        for s, field in enumerate(state.fields):
            img, pix = (None, None) if batch_idx is None else batch_idx[s]
            batch = step_lib.sample_ray_batch(images[s], c2ws[s], Ks[s],
                                              batch_per_scene, generators[s],
                                              img, pix)
            loss, aux = step_lib.loss_fn(
                field, scenes[s], batch, cfg,
                None if state.occ is None else state.occ[s], compute_dtype,
                step=state.step, generator=generators[s],
                draws=None if draws is None else draws[s])
            loss.backward()
            per_scene.append(torch.stack(
                [loss.detach(), *(v.detach() for v in aux.values())]))
        state.opt.step(state.step)
        state.step += 1
        metrics = torch.stack(per_scene).mean(dim=0)
        if mesh is not None:
            comm.all_reduce_mean_([metrics], mesh.data_group, mesh.n_data)
        return dict(zip(["loss", *aux], metrics.unbind()))

    return step
