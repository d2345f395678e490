"""Ray-batch data parallelism over a world of ranks (counterpart of the JAX
parallel/data_parallel.py).

Every rank holds the whole model and its optimizer (``replicate``
broadcasts rank 0's at the start) and draws its own ``batch / n`` rays from
a generator folded from (seed, step, data index), the JAX ``fold_in(
fold_in(key, step), axis)``.  After the backward, one all-reduce over a
flat buffer averages the gradients over the data group, then another the
loss and aux metrics (JAX ``pmean``); every rank then applies the same
update, so the replicas stay equal without a broadcast.  The global batch
must divide by n, as in JAX.  A step function (``ParallelStep``, shared
with the level-parallel step) takes ``steps_per_call`` updates a call: on
the card one update captured as a CUDA graph with its NCCL collectives and
replayed, on the CPU an eager loop.  ``make_dp_render`` splits a render's
rays over the ranks, with no collective in the render, and gathers the
colours.
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
    """One optimizer step at the optimizer's device count, in place on
    ``state`` (the host count is the caller's), whose gradients, loss and
    aux are averaged over ``group`` (n ranks) before the update; the shared
    body of the data- and level-parallel steps, which a window captures.
    Returns the metrics."""
    state.opt.zero_grad()
    loss, aux = step_lib.loss_fn(
        state.field, scene, batch, cfg, state.occ, compute_dtype_of(cfg),
        step=state.opt.count, generator=generator, draws=draws,
        placement=placement, enc_generator=enc_generator,
        horizon=state.opt.total_steps)
    loss.backward()
    comm.all_reduce_mean_([p.grad for p in state.field.parameters()
                           if p.grad is not None], group, n)
    metrics = torch.stack([loss.detach(), *(v.detach() for v in aux.values())])
    comm.all_reduce_mean_([metrics], group, n)
    state.opt.step()
    return dict(zip(["loss", *aux], metrics.unbind()))


class ParallelStep:
    """A data- or level-parallel step function, ``steps_per_call`` updates a
    call (JAX's ``make_*_train_step(steps_per_call=n)``: a ``lax.scan`` over
    the ``shard_map`` body), returning each metric's mean over them:
    step(state, scene, images, c2ws, K, *, generator=None,
    enc_generator=None, img_idx=None, pix_idx=None, draws=None,
    placement=None, feeds=None) -> metrics, in place on ``state``.

    ``update(state, scene, images, c2ws, K, generators, feed)`` takes one
    update at the optimizer's device count; ``streams(step_no)`` gives the
    words each of its generators is folded from at update ``step_no`` (the
    rays and samples', then the stochastic encoder's).  An update draws
    from fresh folded generators, as JAX folds its key with the step;
    ``generator``/``enc_generator`` replace them and ``img_idx``,
    ``pix_idx``, ``draws`` and ``placement`` the draws of a single step.  A
    window on the card is a ``step.WindowGraph``: one update captured with
    its collectives and replayed a step, its registered generators reseeded
    in place to the step's words before each replay (``comm.reseed_``), so
    replay k draws what eager step k draws; the ranks agree
    (``comm.mesh_any``) to capture again when any rank's tensors were
    rebound.  A failed capture raises.  On the CPU a window is an eager
    loop, where ``feeds`` (one feed a step: "img_idx", "pix_idx", "draws",
    "placement") may replace the draws."""

    def __init__(self, update, streams, mesh: comm.Mesh,
                 steps_per_call: int = 1):
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be at least 1, got "
                             f"{steps_per_call}")
        self.update, self.streams, self.mesh = update, streams, mesh
        self.steps_per_call = steps_per_call
        self.graph = step_lib.WindowGraph()
        self._gens = None

    def __call__(self, state, scene, images, c2ws, K, *, generator=None,
                 enc_generator=None, img_idx=None, pix_idx=None, draws=None,
                 placement=None, feeds=None):
        data, n = (scene, images, c2ws, K), self.steps_per_call
        feed = {k: v for k, v in (("img_idx", img_idx), ("pix_idx", pix_idx),
                                  ("draws", draws), ("placement", placement))
                if v is not None}
        if n == 1 and feeds is None:
            return self._one(state, data, (generator, enc_generator), feed)
        if feed or generator is not None or enc_generator is not None:
            raise ValueError("a window draws from its own folded generators; "
                             "feeds replace its draws on the CPU")
        if images.device.type == "cuda":
            if feeds is not None:
                raise ValueError("feeds replace the draws of the eager loop, "
                                 "which runs on the CPU")
            return self._graphed(state, data)
        sums = {}
        for i in range(n):
            step_lib._add_to(sums, self._one(
                state, data, (None, None), {} if feeds is None else feeds[i]))
        return {k: v / n for k, v in sums.items()}

    def _one(self, state, data, given, feed):
        gens = [g if g is not None
                else comm.fold_generator(data[1].device, *words)
                for g, words in zip(given, self.streams(state.step))]
        state.opt.set_count(state.step)
        metrics = self.update(state, *data, gens, feed)
        state.step += 1
        return metrics

    def _graphed(self, state, data):
        dev = data[1].device
        if self._gens is None:
            self._gens = [torch.Generator(dev) for _ in self.streams(0)]
        base = state.step

        def before(i):
            for gen, words in zip(self._gens, self.streams(base + i)):
                comm.reseed_(gen, *words)

        return self.graph.run(
            state, self.steps_per_call,
            lambda: self.update(state, *data, self._gens, {}),
            step_lib.window_key(state, *data[0].values(), *data[1:]),
            generators=self._gens, before=before,
            agree=lambda changed: comm.mesh_any(changed, self.mesh, dev))


def make_dp_train_step(cfg: PipelineConfig, batch_size: int, mesh: comm.Mesh,
                       steps_per_call: int = 1) -> ParallelStep:
    """The data-parallel step (a ``ParallelStep``): ``steps_per_call``
    updates of the global ``batch_size``-ray batch a call, each rank drawing
    its batch / n rays from (seed, step, data index); a single step's
    ``img_idx`` and ``pix_idx`` are this rank's batch / n."""
    n = mesh.n_data
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh "
                         f"size {n}")
    local_batch = batch_size // n

    def update(state, scene, images, c2ws, K, gens, feed):
        batch = step_lib.sample_ray_batch(
            images, c2ws, K, local_batch, gens[0],
            feed.get("img_idx"), feed.get("pix_idx"))
        return reduced_step(state, scene, batch, cfg, mesh.data_group, n,
                            generator=gens[0], draws=feed.get("draws"),
                            placement=feed.get("placement"))

    return ParallelStep(
        update, lambda step_no: [(cfg.train.seed, step_no, mesh.data_index)],
        mesh, steps_per_call)


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
