"""High-level trainer (counterpart of the JAX train/trainer.py): data,
model, grouped optimizer, occupancy warmup and refreshes, periodic eval
renders, checkpoints and metrics.

One process on one device, or, with ``data_parallel`` or
``level_parallel`` k > 1, one rank of a world of processes that
``parallel.comm`` has joined (JAX: a mesh over the visible devices): the
world is laid out (n_data, k), n_data the world's size over k with
``data_parallel``, else 1, and the step is ``parallel.data_parallel``'s or
``parallel.level_parallel``'s; even a world of one runs the data-parallel
step through its group.  Every rank starts from the same seeded field (then
rank 0's is broadcast, or each level rank keeps its slice), refreshes the
occupancy grid from a generator folded from (seed, 10000 + step), as JAX
folds its key, and then takes rank 0's grid; under level parallelism the
eval render splits rays over the data group (``make_lp_render``) and the
checkpoint joins the level shards into the single-device file that the
other entry points and ``load`` read (``load`` shards it again).  Only rank
0 logs and writes.  ``steps_per_call`` n > 1 runs the steps in windows of
n (JAX's fused multi-step dispatch): on the card a window is n replays of
one captured step (``step.WindowGraph``; the unculled and the culled step
are two captures), on the CPU an eager loop; the grid's install lands on
the first window boundary at or past the warmup, the refresh, log and eval
fire when a window crosses their cadence, the logged metrics are the
window's means, and the last window may be shorter.  Under data or level
parallelism the window is the parallel step's (``ParallelStep``: its
collectives captured with it, on the CPU an eager loop) and fixed, as
JAX's: the remainder (steps % n) runs as single steps, so the metrics
logged after it are the last single step's.  A refresh writes into the
grid's storage (``occupancy.write_``), which a captured step reads, and
under parallelism then takes rank 0's grid in place.  The JAX trainer's
compiled-executable cache is not ported.  ``log_grad_norms`` adds each
group's
gradient norm (of the whole field, joined under level parallelism) on a
256-ray probe batch to every log record, as the JAX trainer does; the
probe draws from its own generator, seeded with ``cfg.train.seed`` at each
log (the JAX probe reuses one key), so the training draws are untouched.
``display`` writes every eval render to ``<model>_preview.png`` too and
shows it in a cv2 window where cv2 imports and a display exists.  In a
``torch.profiler`` trace each call that takes steps, each refresh and each
log (the probe's gradient norms included) is a span (``hbr.train.window``,
``hbr.train.refresh``, ``hbr.train.log``; ``observability.span``), and
under the neuralangelo head each window that crosses a stage of its
schedule is followed by ``hbr.train.stage`` (the stage is read on the
device from the step count, so a window graph needs no new capture; the
span logs the new stage), whose log records carry ``active_levels`` and
``normal_eps``; with
``steps_per_call`` n > 1 every log record carries the window graph's
cumulative ``captures`` and ``replays``.  The step
count is kept on the host; every random draw comes from one
``torch.Generator`` on the training device, seeded with ``cfg.train.seed``
(the JAX keys give other bits, so runs of the two packages are alike in
distribution, not in samples).  ``load`` continues a run from a checkpoint of either package:
params, optimizer state, step and grid; the generator's state from a
port-written file (so that the continuation draws what an uninterrupted
run draws), else reseeded from (seed, step).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.ops import occupancy
from human_body_reconstruction_tpu_torch.ops import rays as rays_lib
from human_body_reconstruction_tpu_torch.parallel import comm
from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt_lib
from human_body_reconstruction_tpu_torch.train import state as state_lib
from human_body_reconstruction_tpu_torch.train import step as step_lib
from human_body_reconstruction_tpu_torch.utils import config as C
from human_body_reconstruction_tpu_torch.utils import observability as obs

PROBE_RAYS = 256        # the gradient-norm probe's batch (JAX _probe_loss)


def probe_grad_norms(field, scene, ds, cfg: C.PipelineConfig, occ,
                     generator: torch.Generator, batch=None, draws=None):
    """``grad_norm/<group>`` of the loss on a PROBE_RAYS-ray batch (JAX
    ``jax.grad(_probe_loss)`` through ``grad_norms``): f32 numerics, no TV
    warmup gating; ``batch`` and ``draws`` replace the draws.  The field's
    ``.grad`` is left as it was."""
    if batch is None:
        batch = step_lib.sample_ray_batch(ds["images"], ds["c2ws"], ds["K"],
                                          PROBE_RAYS, generator)
    loss, _ = step_lib.loss_fn(field, scene, batch, cfg, occ, None,
                               generator=generator, draws=draws)
    groups = obs.param_groups(field)
    params = [p for ps in groups.values() for p in ps]
    grads = iter(torch.autograd.grad(loss, params, allow_unused=True))
    return obs.grad_norms({
        k: [torch.zeros_like(p) if g is None else g
            for p, g in zip(ps, grads)] for k, ps in groups.items()})


def init_params(cfg: C.PipelineConfig, generator: torch.Generator) -> nerf.Field:
    """A freshly initialised field on the generator's device."""
    return nerf.Field(cfg, generator=generator)


def scene_from_dataset(ds, cfg: C.PipelineConfig):
    """Bounds of every ray of every view at {near, far + margin} -> the
    scene dict ("diagonal" or "unit_box" normalisation)."""
    lo, hi = rays_lib.scene_bounds(ds["H"], ds["W"], ds["K"], ds["c2ws"],
                                   cfg.render.near, cfg.render.far)
    return nerf.scene_from_bounds(lo, hi, cfg.render.normalization,
                                  device=ds["K"].device)


@dataclasses.dataclass
class Trainer:
    cfg: C.PipelineConfig
    ds: dict                       # images/c2ws/K tensors on the device
    out_dir: str = "results"
    model_name: str = "default"
    bounds_path: str = "bounds_model.npy"
    log_fn: Callable[[str], None] = print
    eval_ds: Optional[dict] = None
    total_steps: Optional[int] = None  # schedule horizon; default
                                       # num_epochs * steps per epoch
    log_grad_norms: bool = False       # --plot_grads
    display: bool = False              # --display
    data_parallel: bool = False        # --data_parallel
    level_parallel: int = 0            # --level_parallel
    steps_per_call: int = 1            # --steps_per_call

    def __post_init__(self):
        cfg = self.cfg
        self._window = step_lib.WindowGraph()
        self.device = self.ds["images"].device
        self.mesh, self._step_fn, self.run_cfg = None, None, cfg
        spc = max(1, self.steps_per_call)
        self._lp = self.level_parallel > 1
        if self.data_parallel or self._lp:
            if not dist.is_initialized():
                raise RuntimeError("data or level parallelism runs in a "
                                   "world of processes (parallel.comm.init "
                                   "or spawn); none is joined")
            n_data, n_level = comm.layout(dist.get_world_size(),
                                          self.data_parallel,
                                          self.level_parallel,
                                          cfg.train.ray_batch)
            if n_data * n_level != dist.get_world_size():
                raise ValueError(f"mesh {n_data}x{n_level} != "
                                 f"{dist.get_world_size()} ranks")
            self.mesh = comm.make_mesh(n_data, n_level, "level")
        self.rank0 = self.mesh is None or dist.get_rank() == 0
        if not self.rank0:
            self.log_fn = lambda line: None
        os.makedirs(self.out_dir, exist_ok=True)
        self.scene = scene_from_dataset(self.ds, cfg)
        if self.rank0:
            ckpt_lib.save_bounds(
                os.path.join(self.out_dir, self.bounds_path),
                self.scene["min_bound"].cpu().numpy(),
                self.scene["max_bound"].cpu().numpy())
        self.generator = torch.Generator(self.device).manual_seed(
            cfg.train.seed)
        field = init_params(cfg, self.generator)
        occ = (occupancy.init_grid(cfg.render.occupancy_resolution,
                                   cfg.render.occ_threshold, self.device)
               if cfg.render.occupancy else None)
        # occupancy warmup: train unculled first; the grid is installed
        # (and refreshed from the field at once) at the warmup step
        self._occ_pending = None
        if occ is not None and cfg.train.occ_warmup_steps > 0:
            self._occ_pending, occ = occ, None
        if self.total_steps is None:
            self.total_steps = cfg.train.num_epochs * max(
                1, (self.ds["images"].numel() // 3) // cfg.train.ray_batch)
        self.state = state_lib.create_train_state(
            field, cfg.train, self.total_steps, occ=occ)
        if self._lp:
            from human_body_reconstruction_tpu_torch.parallel import (
                level_parallel as lp)

            self.state = lp.shard_lp_state(self.state, cfg, self.mesh,
                                           self.total_steps)
            self._step_fn, self._window_fn = (
                lp.make_lp_train_step(cfg, cfg.train.ray_batch, self.mesh,
                                      steps_per_call=n) for n in (1, spc))
            self.run_cfg = lp.lp_cfg(cfg)
            self._lp_render = lp.make_lp_render(
                cfg, self.mesh, num_samples=256,
                hierarchical=cfg.render.hierarchical)
            self.log_fn(f"level-parallel over {self.mesh.n_inner} ranks"
                        + (f" x {self.mesh.n_data} data shards"
                           if self.mesh.n_data > 1 else ""))
        elif self.mesh is not None:
            from human_body_reconstruction_tpu_torch.parallel import (
                data_parallel as dp)

            dp.replicate(self.state)
            self._step_fn, self._window_fn = (
                dp.make_dp_train_step(cfg, cfg.train.ray_batch, self.mesh,
                                      steps_per_call=n) for n in (1, spc))
            self.log_fn(f"data-parallel over {self.mesh.n_data} ranks")
        if self._step_fn is not None:   # the parallel step's window graph
            self._window = self._window_fn.graph
        self.history = []
        self.metrics = obs.MetricsLogger(self.out_dir,
                                         name=f"{self.model_name}_metrics")

    # -- checkpointing ----------------------------------------------------
    def ckpt_path(self):
        return os.path.join(self.out_dir, f"{self.model_name}_ckpt.npz")

    def whole_state(self):
        """The single-device train state: this rank's, or, under level
        parallelism, the level group's shards joined (every rank calls
        it)."""
        if not self._lp:
            return self.state
        from human_body_reconstruction_tpu_torch.parallel import (
            level_parallel as lp)

        return lp.gather_lp_state(self.state, self.cfg, self.mesh,
                                  self.total_steps)

    def save(self):
        """The checkpoint (params, optimizer state, step, occupancy grid,
        generator) and the config JSON, by rank 0; the bounds were written
        at construction."""
        state = self.whole_state()
        if not self.rank0:
            return
        ckpt_lib.save_train_state(self.ckpt_path(), state,
                                  generator=self.generator)
        C.to_json(self.cfg, os.path.join(
            self.out_dir, f"{self.model_name}_config.json"))

    def load(self, path: Optional[str] = None):
        """Continue from a train-state checkpoint (this run's by default).
        A saved grid comes back when the config has occupancy, and then no
        install is pending; a run loaded past its warmup without one
        installs the grid at its first step."""
        whole = self.state
        if self._lp:
            whole = state_lib.create_train_state(
                nerf.Field(self.cfg, device=self.device), self.cfg.train,
                self.total_steps, occ=self.state.occ)
        ckpt_lib.load_train_state(
            path or self.ckpt_path(), whole,
            allow_occ=self.cfg.render.occupancy, generator=self.generator,
            seed=self.cfg.train.seed)
        if self._lp:           # every rank read the whole file: cut it again
            from human_body_reconstruction_tpu_torch.parallel import (
                level_parallel as lp)

            self.state = lp.shard_lp_state(whole, self.cfg, self.mesh,
                                           self.total_steps)
        if self.state.occ is not None:
            self._occ_pending = None

    # -- occupancy --------------------------------------------------------
    def _install_occ(self, step_no: int):
        """End of warmup: attach the grid and refresh it from the (now
        trained) field so the first culling decision is informed."""
        self.state.occ, self._occ_pending = self._occ_pending, None
        self.update_occupancy()
        self.log_fn(f"occupancy culling engaged at step {step_no}")

    def update_occupancy(self):
        if self.state.occ is None:
            return
        with obs.span("train.refresh"):
            gen = self.generator
            if self.mesh is not None:
                gen = comm.fold_generator(self.device, self.cfg.train.seed,
                                          10_000 + self.state.step)
            occupancy.write_(self.state.occ, occupancy.update_from_field(
                self.state.occ, self.state.field, self.scene, self.run_cfg,
                generator=gen))
            if self.mesh is not None:       # hold the ranks' grids equal
                comm.broadcast_(self.state.occ[:2])

    # -- training ---------------------------------------------------------
    def run(self, steps: int, log_every: int = 100,
            eval_every: Optional[int] = None):
        cfg = self.cfg
        t_last = time.perf_counter()
        rays_done = 0
        start_step = self.state.step

        def crossed(upto: int, n: int, every: int) -> bool:
            """Did [upto-n, upto] cross a multiple of ``every``?"""
            return every > 0 and upto // every > (upto - n) // every

        spc, i = max(1, self.steps_per_call), 0
        head = self.state.field.mlp
        stage = head.stage_key(cfg, start_step)
        while i < steps:
            if self._occ_pending is not None and (
                    start_step + i >= cfg.train.occ_warmup_steps):
                self._install_occ(start_step + i)
            n = min(spc, steps - i)
            if self._step_fn is not None:
                # the parallel window is fixed, as JAX's: a remainder
                # (steps % spc) runs single steps
                fn = self._window_fn if n == spc else self._step_fn
                for _ in range(1 if n == spc else n):
                    with obs.span("train.window"):
                        metrics = fn(self.state, self.scene,
                                     self.ds["images"], self.ds["c2ws"],
                                     self.ds["K"])
            elif spc > 1:
                with obs.span("train.window"):
                    metrics = step_lib.train_step_multi(
                        self.state, self.scene, self.ds["images"],
                        self.ds["c2ws"], self.ds["K"], cfg,
                        cfg.train.ray_batch, n, self.generator,
                        graph=self._window)
            else:
                with obs.span("train.window"):
                    metrics = step_lib.train_step(
                        self.state, self.scene, self.ds["images"],
                        self.ds["c2ws"], self.ds["K"], cfg,
                        cfg.train.ray_batch, self.generator)
            rays_done += cfg.train.ray_batch * n
            i += n
            step_no = start_step + i
            if head.stage_key(cfg, step_no) != stage:
                with obs.span("train.stage"):
                    stage = head.stage_key(cfg, step_no)
                    st = head.stage_record(cfg, step_no, self.total_steps,
                                           self.scene)
                    self.log_fn(f"stage at step {step_no}: "
                                f"{st['active_levels']} levels active, "
                                f"eps {st['normal_eps']:.6g}, curvature "
                                f"weight {st['curvature_weight']:.6g}")
            if cfg.render.occupancy and crossed(step_no, n,
                                                cfg.train.update_rate):
                self.update_occupancy()
            if log_every and crossed(i, n, log_every):
                with obs.span("train.log"):
                    # the probe field: under level parallelism every rank
                    # joins the shards, then rank 0 alone logs
                    probe = (self.whole_state().field if self.log_grad_norms
                             else None)
                    if self.rank0:
                        self._log(step_no, metrics, rays_done, t_last, probe)
                t_last = time.perf_counter()
                rays_done = 0
            if eval_every and crossed(i, n, eval_every):
                self.eval_render(tag=f"{step_no:07d}")
                self.save()
        return self.state

    def _log(self, step_no: int, metrics, rays_done: int, t_last: float,
             probe):
        """One log record; the rate of the rays since ``t_last``, timed
        after the sync of reading the loss."""
        rec = {"step": step_no, "loss": float(metrics["loss"]),
               "psnr": float(metrics["psnr"])}
        rec["rays_per_sec"] = rays_done / (time.perf_counter() - t_last)
        if self.state.occ is not None:
            rec["occupied_frac"] = float(
                occupancy.occupied_fraction(self.state.occ))
        rec.update(self.state.field.mlp.stage_record(
            self.cfg, step_no, self.total_steps, self.scene))
        if self.steps_per_call > 1:     # the window graph's, cumulative
            rec["captures"] = self._window.captures
            rec["replays"] = self._window.replays
        if probe is not None:
            norms = probe_grad_norms(
                probe, self.scene, self.ds, self.cfg, self.state.occ,
                torch.Generator(self.device).manual_seed(self.cfg.train.seed))
            rec.update({k: float(v) for k, v in norms.items()})
        self.history.append(rec)
        self.metrics.log(rec)
        self.log_fn(f"step {rec['step']:7d}  loss {rec['loss']:.5f}  "
                    f"psnr {rec['psnr']:6.2f}  "
                    f"{rec['rays_per_sec'] / 1e6:7.3f} Mrays/s")

    def eval_render(self, tag: str = "final"):
        """Render view 0 of the eval (else the training) dataset in f32 on
        the eval branch with 256 samples; write a PNG and return the PSNR
        against the dataset image (rank 0; None on the other ranks, which
        take part in a level-parallel render)."""
        from human_body_reconstruction_tpu_torch.data import png

        ds = self.eval_ds if self.eval_ds is not None else self.ds
        hier = self.cfg.render.hierarchical
        if self._lp:              # every rank: rays over the data group
            o, d, n = rays_lib.full_image_rays(ds["H"], ds["W"], ds["K"],
                                               ds["c2ws"][0])
            img = self._lp_render(
                self.state.field, self.scene, o.reshape(-1, 3),
                d.reshape(-1, 3), n.reshape(-1, 1), occ=self.state.occ)
            img = img.reshape(ds["H"], ds["W"], 3)
        elif self.rank0:
            img = step_lib.render_image(
                self.state.field, self.scene, ds["H"], ds["W"], ds["K"],
                ds["c2ws"][0], self.cfg, occ=self.state.occ,
                num_samples=256, hierarchical=hier)
        if not self.rank0:
            return None
        img = img.cpu().numpy()
        gt = ds["images"][0].cpu().numpy()
        mse = float(np.mean((img - gt) ** 2))
        psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
        arr8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        png.write_png(os.path.join(self.out_dir,
                                   f"{self.model_name}_{tag}.png"), arr8)
        if self.display:
            self._show_preview(arr8)
        self.log_fn(f"eval [{tag}] view 0: PSNR {psnr:.2f} dB")
        return psnr

    def _show_preview(self, arr8):
        """The rolling live preview: overwrite ``<model>_preview.png`` and,
        where cv2 imports and a display exists, show it in a non-blocking
        window."""
        from human_body_reconstruction_tpu_torch.data import png

        png.write_png(os.path.join(self.out_dir,
                                   f"{self.model_name}_preview.png"), arr8)
        try:
            import cv2
        except ImportError:
            return                  # headless: the rolling PNG is the preview
        if os.environ.get("DISPLAY") or os.name == "nt":
            cv2.imshow(f"{self.model_name} preview", arr8[..., ::-1])
            cv2.waitKey(1)
