"""The training step and eval-time image rendering (counterpart of
``sample_ray_batch``, ``loss_fn``, ``train_step``, ``train_step_multi``,
``render_chunk``, ``render_image_fused`` and ``render_poses_fused`` in the
JAX train/step.py).

A training step samples a batch of (image, pixel) rays on the device,
renders them on the training branch of ``nerf.render_rays``, takes the
loss (MSE coarse + MSE fine, the eikonal term in SDF mode, the
factor-line TV after its warmup, the density L1 when weighted), back-propagates through the encoder kernels and
applies the grouped optimizer.  The MLP computes in
``cfg.train.compute_dtype`` (bf16 operands, f32 accumulation).  The step
reads the update count from the optimizer's device counter (the TV gate is
a device-side select on it), so that it runs without reading the host.

The JAX package fuses n steps into one dispatch (``lax.scan``) and a frame
into one (``lax.map`` over chunks).  Here the counterparts are CUDA graphs:
``WindowGraph`` captures one training step (a real step, run first on the
capture stream, then the capture) and replays it for each step of a window,
the metrics summed in device buffers; ``FrameGraphs`` captures a frame's or
a pose batch's eager chunk loop, keyed by its shapes and options, in one
memory pool, the poses and K copied into static inputs before each replay.
A graph draws from the registered generators, so replay k draws what eager
step k would (a parallel window reseeds them in place before each replay to
the step's folded words, ``parallel.data_parallel.ParallelStep``).  On the
CPU the same functions run their eager loops.  Rays are independent, so the
last chunk is simply shorter instead of padded (the fused frame keeps the
eager chunk boundaries and equals the eager frame).
``bf16`` means what it means in JAX: the MLP runs in bf16 compute with f32
accumulation.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.ops import compositing
from human_body_reconstruction_tpu_torch.ops import rays as rays_lib
from human_body_reconstruction_tpu_torch.utils import observability as obs
from human_body_reconstruction_tpu_torch.utils.config import PipelineConfig


def sample_ray_batch(images, c2ws, K, batch: int, generator=None,
                     img_idx=None, pix_idx=None):
    """Uniformly sample ``batch`` (image, pixel) pairs and build their
    rays.  images (N, H, W, 3) f32 and c2ws (N, 4, 4) on the device;
    ``img_idx``/``pix_idx`` (batch,) replace the draws.  Returns (rays_o,
    rays_d, dir_norm, gt)."""
    N, H, W = images.shape[:3]
    dev = images.device
    if img_idx is None:
        img_idx = torch.randint(0, N, (batch,), generator=generator,
                                device=dev)
    if pix_idx is None:
        pix_idx = torch.randint(0, H * W, (batch,), generator=generator,
                                device=dev)
    j, i = pix_idx // W, pix_idx % W
    o, d, n = rays_lib.rays_for_pixels(i, j, K, c2ws[img_idx])
    return o, d, n, images[img_idx, j, i]


def loss_fn(field, scene, batch, cfg: PipelineConfig, occ=None,
            compute_dtype=None, step=None, generator=None, draws=None,
            placement=None, enc_generator=None, horizon=None):
    """(loss, aux) of one ray batch, as the JAX ``loss_fn``.  A head that
    renders itself (``field.mlp.renders``) gives its own ``loss_fn``, the
    neuralangelo head's at the schedule's stage at ``step`` (a device
    count) over ``horizon`` steps (its last stage without a step).  ``step``
    (the update count: a host integer, or a device tensor, then a select)
    gates the factor-line TV by ``cfg.train.cp_tv_warmup``;
    ``draws``, ``placement`` and ``enc_generator`` go to ``render_rays``.
    On a rank-parallel field (``field.lp``) the TV of the rank's line
    slices, normalised by the global rank, is summed over the level group
    (``field.lp.psum``), so loss and aux are the single-device values on
    every rank."""
    rays_o, rays_d, dir_norm, gt = batch
    if field.mlp.renders:
        return field.mlp.loss_fn(field, scene, batch, cfg, step=step,
                                 horizon=horizon, generator=generator,
                                 draws=draws)
    out = nerf.render_rays(field, scene, rays_o, rays_d, dir_norm, cfg,
                           occ=occ, compute_dtype=compute_dtype, jitter=True,
                           generator=generator, draws=draws,
                           placement=placement, enc_generator=enc_generator)
    mse = torch.mean((out["fine"] - gt) ** 2)
    loss = torch.mean((out["coarse"] - gt) ** 2) + mse
    aux = {"mse": mse}
    tc = cfg.train
    if cfg.render.use_sdf:
        eik = nerf.eikonal_loss(out["eikonal_norm"])
        loss = loss + tc.eikonal_weight * eik
        aux["eikonal"] = eik
    if tc.cp_tv_weight > 0.0 and len(field.lines):
        # normalised by the global rank (JAX: exact under rank parallelism)
        rank = cfg.hash.cp_rank
        tv = sum(torch.sum((ln[:, 1:, :] - ln[:, :-1, :]) ** 2)
                 / (ln.shape[0] * (ln.shape[1] - 1) * rank)
                 for ln in field.lines) / len(field.lines)
        if field.lp is not None:
            tv = field.lp.psum(tv)
        if torch.is_tensor(step) and tc.cp_tv_warmup > 0:
            # on the device count: adds exactly 0 before the warmup
            loss = loss + torch.where(step >= tc.cp_tv_warmup,
                                      tc.cp_tv_weight * tv,
                                      torch.zeros_like(tv))
        elif tc.cp_tv_warmup <= 0 or step is None or step >= tc.cp_tv_warmup:
            loss = loss + tc.cp_tv_weight * tv
        aux["cp_tv"] = tv
    if tc.sigma_l1_weight > 0.0:
        sl1 = torch.mean(torch.clamp(out["density"], min=0.0))
        loss = loss + tc.sigma_l1_weight * sl1
        aux["sigma_l1"] = sl1
    aux["psnr"] = compositing.psnr(out["fine"], gt)
    return loss, aux


def _update(state, scene, images, c2ws, K, cfg: PipelineConfig,
            batch_size: int, generator, enc_generator, feed):
    """One update at the optimizer's device count: what an eager step runs
    and a ``WindowGraph`` captures.  ``feed`` may hold "img_idx",
    "pix_idx", "draws" and "placement", which replace the draws."""
    feed = feed or {}
    batch = sample_ray_batch(images, c2ws, K, batch_size, generator,
                             img_idx=feed.get("img_idx"),
                             pix_idx=feed.get("pix_idx"))
    state.opt.zero_grad()
    compute_dtype = (torch.bfloat16 if cfg.train.compute_dtype == "bfloat16"
                     else None)
    loss, aux = loss_fn(state.field, scene, batch, cfg, state.occ,
                        compute_dtype, step=state.opt.count,
                        generator=generator, draws=feed.get("draws"),
                        placement=feed.get("placement"),
                        enc_generator=enc_generator,
                        horizon=state.opt.total_steps)
    loss.backward()
    state.opt.step()
    return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}


def train_step(state, scene, images, c2ws, K, cfg: PipelineConfig,
               batch_size: int, generator=None, enc_generator=None,
               feed=None):
    """One optimization step, in place on ``state`` (its field, optimizer
    and step count).  Returns the metrics (detached tensors).  The
    stochastic encoder draws from ``enc_generator`` when given, else from
    ``generator``; ``feed`` replaces the draws (``_update``)."""
    state.opt.set_count(state.step)
    metrics = _update(state, scene, images, c2ws, K, cfg, batch_size,
                      generator, enc_generator, feed)
    state.step += 1
    return metrics


def _add_to(sums: dict, metrics: dict):
    for k, v in metrics.items():
        if k not in sums:
            sums[k] = torch.zeros_like(v)
        sums[k].add_(v)


def train_step_multi(state, scene, images, c2ws, K, cfg: PipelineConfig,
                     batch_size: int, n_steps: int, generator=None,
                     enc_generator=None, graph=None, feeds=None):
    """``n_steps`` sequential ``train_step``s, in place on ``state``;
    returns each metric's mean over the window (its f32 sum over n).  On a
    CUDA device the steps are replays of ``graph`` (a ``WindowGraph``,
    captured on its first use and whenever what it reads was rebound; a
    temporary one when None); on the CPU an eager loop, where ``feeds``
    (one ``feed`` a step) may replace the draws."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be at least 1, got {n_steps}")
    if images.device.type == "cuda":
        if feeds is not None:
            raise ValueError("feeds replace the draws of the eager loop, "
                             "which runs on the CPU")
        gens = [g for g in {id(g): g for g in (generator, enc_generator)
                            if g is not None}.values()]
        return (graph or WindowGraph()).run(
            state, n_steps,
            lambda: _update(state, scene, images, c2ws, K, cfg, batch_size,
                            generator, enc_generator, None),
            (cfg, batch_size, *(id(g) for g in gens),
             window_key(state, *scene.values(), images, c2ws, K)),
            generators=gens)
    sums = {}
    for i in range(n_steps):
        _add_to(sums, train_step(state, scene, images, c2ws, K, cfg,
                                 batch_size, generator, enc_generator,
                                 None if feeds is None else feeds[i]))
    return {k: v / n_steps for k, v in sums.items()}


class Captured:
    """``fn(*inputs)`` captured once as a CUDA graph: one warm-up call on
    the capture stream (it builds and loads the kernels, sets their
    attributes and makes cuBLAS's workspace, none of which a capture may
    do), then the capture, with ``generators`` registered so that each
    replay draws afresh, into ``pool`` (a private one when None).
    ``inputs`` are the graph's static inputs, ``out`` its output."""

    def __init__(self, fn, inputs=(), generators=(), pool=None):
        self.inputs = list(inputs)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.out = fn(*self.inputs)

    def replay(self):
        self.graph.replay()
        return self.out


def _ptrs(*tensors) -> tuple:
    return tuple(t.data_ptr() for t in tensors)


def window_key(state, *tensors) -> tuple:
    """What a captured update of ``state`` reads, by identity and address:
    the state and its optimizer, the parameters, the grid and ``tensors``
    (scene, data)."""
    occ = () if state.occ is None else tuple(state.occ)
    return (id(state), id(state.opt),
            _ptrs(*state.field.parameters(), *occ, *tensors))


class WindowGraph:
    """The training step as a CUDA graph replayed once a step of a window
    (the counterpart of JAX ``train_step_multi``'s scan, and of its
    ``lax.scan`` over the parallel steps' ``shard_map`` bodies).  One step
    is captured, so a remainder window needs no second capture and the
    graph's pool holds one step's activations.  The first window's first
    step is the warm-up, run eagerly on the capture stream.  The graph reads
    the parameters, moments, grid, scene and data at the addresses it
    captured: when any of them was rebound (the grid's install, a load that
    replaced a tensor) the step is captured again and the old graph
    dropped, so a window never reads a stale grid; an in-place refresh of
    the grid needs no new capture.  ``captures`` counts captures,
    ``capture_s`` their seconds (warm-up step included) and ``replays`` the
    graph's replays; a capture is the span ``hbr.train.capture``."""

    def __init__(self):
        self._call, self._key, self._sums = None, None, {}
        self.captures, self.capture_s, self.replays = 0, 0.0, 0

    def run(self, state, n_steps: int, update, key, generators=(),
            before=None, agree=None):
        """``n_steps`` updates of ``state``; returns each metric's mean over
        them.  ``update()`` takes one update at the optimizer's device count
        and returns its metrics: the warm-up step runs it and the graph
        captures it.  ``key`` names what it reads (``window_key`` and the
        options): another key captures again.  ``generators`` are
        registered with the graph; ``before(i)`` runs before step i of the
        window (the warm-up or a replay), where a parallel step reseeds
        them; ``agree(changed) -> changed`` makes every rank of a world
        take one decision to capture again."""
        for v in self._sums.values():
            v.zero_()
        state.opt.set_count(state.step)
        changed = key != self._key
        if agree is not None:
            changed = agree(changed)
        first = 0
        if changed:
            self._call = self._key = None      # free the old graph's pool
            t0 = time.perf_counter()
            with obs.span("train.capture"):
                if before is not None:
                    before(0)

                def body():
                    m = update()
                    _add_to(self._sums, m)
                    return m

                self._call = Captured(body, generators=generators)
                torch.cuda.synchronize()
            self._key = key
            self.captures += 1
            self.capture_s += time.perf_counter() - t0
            first = 1
        for i in range(first, n_steps):
            if before is not None:
                before(i)
            self._call.graph.replay()
            self.replays += 1
        state.step += n_steps
        return {k: v / n_steps for k, v in self._sums.items()}


@torch.no_grad()
def render_chunk(field, scene, rays_o, rays_d, dir_norm, cfg: PipelineConfig,
                 occ=None, num_samples: int = 256, hierarchical: bool = False,
                 bf16: bool = False, draws=None):
    """Colours (B, 3) of one ray chunk: the second pass's with
    ``hierarchical`` (whose quantiles ``draws["fine_u"]`` may give)."""
    out = nerf.render_rays(field, scene, rays_o, rays_d, dir_norm, cfg,
                           num_samples=num_samples, hierarchical=hierarchical,
                           occ=occ, draws=draws,
                           compute_dtype=torch.bfloat16 if bf16 else None)
    return out["fine"]


def fine_quantiles(cfg: PipelineConfig, num_samples: int, chunk: int, device):
    """The eval second pass's quantiles (chunk, n_fine), U[0, 1 - 1e-6) from
    a generator seeded 0: the JAX render functions hand every chunk one
    fixed key, so every chunk draws the same."""
    n_fine = cfg.render.num_fine_samples or num_samples
    gen = torch.Generator(device).manual_seed(0)
    return torch.rand((chunk, n_fine), generator=gen,
                      device=device) * (1.0 - 1e-6)


@torch.no_grad()
def render_rays_chunked(field, scene, o, d, n, cfg: PipelineConfig, occ=None,
                        num_samples: int = 256, chunk: int = 16384,
                        hierarchical: bool = False, bf16: bool = False,
                        fine_u=None):
    """Colours (R, 3) of R rays, ``chunk`` rays per pass; ``fine_u``
    replaces ``fine_quantiles`` (a captured frame draws them before the
    capture)."""
    u = fine_u
    if hierarchical and u is None:
        u = fine_quantiles(cfg, num_samples, min(chunk, o.shape[0]), o.device)
    outs = [render_chunk(field, scene, o[s:s + chunk], d[s:s + chunk],
                         n[s:s + chunk], cfg, occ=occ,
                         num_samples=num_samples, hierarchical=hierarchical,
                         bf16=bf16,
                         draws=None if not hierarchical else {
                             "fine_u": u[:o[s:s + chunk].shape[0]]})
            for s in range(0, o.shape[0], chunk)]
    return torch.cat(outs)


def render_image(field, scene, H: int, W: int, K, c2w, cfg: PipelineConfig,
                 occ=None, num_samples: int = 256, hierarchical: bool = False,
                 chunk: int = 16384, bf16: bool = False, fine_u=None):
    """(H, W, 3) float32 image on the field's device.  ``hierarchical``
    (not ``cfg.render.hierarchical``, as in JAX) asks for the second
    pass."""
    o, d, n = rays_lib.full_image_rays(H, W, K, c2w)
    return render_rays_chunked(field, scene, o, d, n, cfg, occ=occ,
                               num_samples=num_samples, chunk=chunk,
                               hierarchical=hierarchical, bf16=bf16,
                               fine_u=fine_u).reshape(H, W, 3)


def render_poses(field, scene, H: int, W: int, K, c2ws, cfg: PipelineConfig,
                 occ=None, num_samples: int = 256, hierarchical: bool = False,
                 chunk: int = 16384, bf16: bool = False, fine_u=None):
    """(P, H, W, 3) images of a pose stack (P, 4, 4).  The chunks tile the
    concatenated rays of all poses, so only the batch's last chunk is
    short."""
    o, d, n = rays_lib.full_image_rays(H, W, K, c2ws[:, None, :, :])
    P = c2ws.shape[0]
    img = render_rays_chunked(field, scene, o.reshape(-1, 3),
                              d.reshape(-1, 3), n.reshape(-1, 1), cfg,
                              occ=occ, num_samples=num_samples, chunk=chunk,
                              hierarchical=hierarchical, bf16=bf16,
                              fine_u=fine_u)
    return img.reshape(P, H, W, 3)


class FrameGraphs:
    """Captured frame renders (CUDA): one graph per (render function, H, W,
    num_samples, hierarchical, bf16, chunk, poses, cfg) and the addresses of
    the field, scene and grid it reads, every graph in one memory pool.  A
    call copies K and the pose(s) into the graph's static inputs, replays it
    and returns a copy of its frame (the next capture into the shared pool
    may reuse a graph's output memory).  ``captures`` counts captures,
    ``capture_s`` their seconds (warm-up frame included) and ``replays`` the
    frames replayed; a capture is the span ``hbr.serve.capture``."""

    def __init__(self):
        self._graphs, self._pool = {}, None
        self.captures, self.capture_s, self.replays = 0, 0.0, 0

    def render(self, render_fn, field, scene, H: int, W: int, K, c2w,
               cfg: PipelineConfig, occ, num_samples: int, hierarchical: bool,
               chunk: int, bf16: bool):
        occ_t = () if occ is None else tuple(occ)
        key = (render_fn, H, W, num_samples, hierarchical, bf16, chunk,
               tuple(c2w.shape), cfg,
               _ptrs(*field.parameters(), *scene.values(), *occ_t))
        call = self._graphs.get(key)
        if call is None:
            t0 = time.perf_counter()
            with obs.span("serve.capture"):
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                rays = H * W * (c2w.shape[0] if c2w.dim() == 3 else 1)
                u = (fine_quantiles(cfg, num_samples, min(chunk, rays),
                                    K.device) if hierarchical else None)

                def frame(K_s, c2w_s):
                    return render_fn(field, scene, H, W, K_s, c2w_s, cfg,
                                     occ=occ, num_samples=num_samples,
                                     hierarchical=hierarchical, chunk=chunk,
                                     bf16=bf16, fine_u=u)

                call = Captured(frame, inputs=(K.clone(), c2w.clone()),
                                pool=self._pool)
                torch.cuda.synchronize()
            self._graphs[key] = call
            self.captures += 1
            self.capture_s += time.perf_counter() - t0
        call.inputs[0].copy_(K)
        call.inputs[1].copy_(c2w)
        self.replays += 1
        return call.replay().clone()


def render_image_fused(field, scene, H: int, W: int, K, c2w,
                       cfg: PipelineConfig, occ=None, num_samples: int = 256,
                       hierarchical: bool = False, chunk: int = 16384,
                       bf16: bool = False, graphs: Optional[FrameGraphs] = None):
    """``render_image`` as one dispatch: on a CUDA device the replay of a
    captured frame (``graphs``, a temporary holder when None), on the CPU
    the eager chunk loop.  Equal to ``render_image`` bit for bit."""
    if K.device.type != "cuda":
        return render_image(field, scene, H, W, K, c2w, cfg, occ=occ,
                            num_samples=num_samples,
                            hierarchical=hierarchical, chunk=chunk, bf16=bf16)
    return (graphs or FrameGraphs()).render(
        render_image, field, scene, H, W, K, c2w, cfg, occ, num_samples,
        hierarchical, chunk, bf16)


def render_poses_fused(field, scene, H: int, W: int, K, c2ws,
                       cfg: PipelineConfig, occ=None, num_samples: int = 256,
                       hierarchical: bool = False, chunk: int = 16384,
                       bf16: bool = False, graphs: Optional[FrameGraphs] = None):
    """``render_poses`` of a pose stack (P, 4, 4) as one dispatch, as
    ``render_image_fused`` is ``render_image``'s."""
    if K.device.type != "cuda":
        return render_poses(field, scene, H, W, K, c2ws, cfg, occ=occ,
                            num_samples=num_samples,
                            hierarchical=hierarchical, chunk=chunk, bf16=bf16)
    return (graphs or FrameGraphs()).render(
        render_poses, field, scene, H, W, K, c2ws, cfg, occ, num_samples,
        hierarchical, chunk, bf16)
