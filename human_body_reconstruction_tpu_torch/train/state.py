"""Training state: the grouped optimizer and its schedule (counterpart of
the JAX train/state.py).

The JAX package drives one ``optax.multi_transform`` over the params
pytree: Adam (eps 1e-15) on the embedding-like groups ``dense``,
``lines`` and ``table``, AdamW (weight decay ``cfg.weight_decay``) on ``mlp``, each on
``cosine_to_floor`` of its own base rate, and in SDF mode AdamW at the
constant rate ``cfg.lr_var`` with optax's default weight decay 1e-4 (not
torch's 1e-2) on the sharpness ``var``.  Here each group is an
``AdamGroup``: optax's Adam/AdamW update on the device (one pass of
``ops/adam_kernel.py``'s CUDA kernel a group; its foreach passes on the
CPU), its rate from the group's schedule evaluated in f32 on the
device at the count of updates taken so far (optax's ``scale_by_schedule``
reads its count before incrementing it), the count an int32 device tensor.
One formulation serves the eager step and a captured CUDA graph (torch's
``capturable`` Adam refuses CPU tensors, and its eager form corrects the
bias on the host).  ``moments``/``set_moments`` read and write one
parameter's Adam moments (and the count), which the checkpoint maps to the
optax state.  The host closed forms ``cosine_to_floor`` (torch's recursive
``CosineAnnealingLR`` drifts from it) and ``onecycle`` (optax's
``cosine_onecycle_schedule``) stay for the vanilla NeRF's torch Adam and
as the device schedules' references.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.ops import adam_kernel
from human_body_reconstruction_tpu_torch.ops.occupancy import OccupancyGrid
from human_body_reconstruction_tpu_torch.utils.config import TrainConfig


def cosine_to_floor(lr: float, lr_final: float, total_steps: int):
    """CosineAnnealingLR with eta_min, closed form:
    lr_final + 0.5 * (lr - lr_final) * (1 + cos(pi * min(step / T, 1)))."""
    def sched(step: int) -> float:
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return lr_final + 0.5 * (lr - lr_final) * (1.0 + math.cos(math.pi * frac))
    return sched


def onecycle(peak: float, total_steps: int):
    """optax.cosine_onecycle_schedule(transition_steps=total_steps,
    peak_value=peak) with optax's defaults (pct_start 0.3, div_factor 25,
    final_div_factor 1e4), closed form: from peak / 25 up to peak over the
    first int(0.3 * T) steps, then down to peak / 2.5e5 at T, each leg
    ``end + (start - end) / 2 * (cos(pi * pct) + 1)``, flat after T.
    optax's schedule is NaN at every step when the first leg is empty (T <
    4), so that horizon is refused."""
    b1, b2 = int(0.3 * total_steps), int(total_steps)
    if b1 <= 0:
        raise ValueError(f"onecycle over {total_steps} steps: the warm-up "
                         f"leg int(0.3 * {total_steps}) is empty, where "
                         "optax's schedule is NaN")
    v0, v2 = peak / 25.0, peak / (25.0 * 1e4)

    def leg(start, end, pct):
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    def sched(step: int) -> float:
        if step < b1:
            return leg(v0, peak, max(step, 0) / b1)
        if step < b2:
            return leg(peak, v2, (step - b1) / (b2 - b1))
        return v2
    return sched


def _f32(x) -> float:
    return float(np.float32(x))


def cosine_to_floor_t(lr: float, lr_final: float, total_steps: int):
    """``cosine_to_floor`` on the device: the rate (a 0-d f32 tensor) at an
    integer count tensor, evaluated in f32 in the order optax's is (the
    Python constants rounded to f32 where they meet the tensor)."""
    half = 0.5 * (lr - lr_final)

    def sched(count):
        frac = torch.clamp(count / max(total_steps, 1), 0.0, 1.0)
        return lr_final + half * (1.0 + torch.cos(math.pi * frac))
    return sched


def onecycle_t(peak: float, total_steps: int):
    """``onecycle`` on the device, as optax's piecewise cosine interpolation
    evaluates it: the leg values are numpy's cumulative product of (peak /
    25, 25, 1 / 2.5e5) rounded to f32, each leg ``end + (start - end) / 2 *
    (cos(pi * pct) + 1)`` in f32, selected by the count."""
    onecycle(peak, total_steps)              # the same refusal
    b1, b2 = int(0.3 * total_steps), int(total_steps)
    v = np.cumprod([peak / 25.0, 25.0, 1.0 / (25.0 * 1e4)]).astype(np.float32)
    halves = [_f32((v[i] - v[i + 1]) / np.float32(2.0)) for i in range(2)]

    def leg(i, pct):
        return _f32(v[i + 1]) + halves[i] * (torch.cos(math.pi * pct) + 1.0)

    def sched(count):
        return torch.where(
            count < b1, leg(0, count / b1),
            torch.where(count < b2, leg(1, (count - b1) / (b2 - b1)),
                        torch.full_like(count, _f32(v[2]),
                                        dtype=torch.float32)))
    return sched


def two_steps_t(lr: float, warmup: int, total_steps: int):
    """Neuralangelo's ``two_steps_with_warmup`` on the device: lr * count /
    warmup before ``warmup`` updates, then lr, lr / 10 past 0.6 of the
    horizon and lr / 100 past 0.8 of it (the published 300,000 and 400,000
    of 500,000), evaluated in f32."""
    steps = (int(0.6 * total_steps), int(0.8 * total_steps))

    def rate(count, value):
        return torch.full_like(count, _f32(value), dtype=torch.float32)

    def sched(count):
        c = count.to(torch.float32)
        flat = torch.where(count > steps[1], rate(count, lr / 100.0),
                           torch.where(count > steps[0],
                                       rate(count, lr / 10.0),
                                       rate(count, lr)))
        if warmup <= 0:
            return flat
        return torch.where(count < warmup, c / warmup * _f32(lr), flat)
    return sched


def make_schedule(cfg: TrainConfig, lr: float, total_steps: int):
    """The schedule of a group whose base rate is ``lr`` (JAX
    ``_make_schedule``, and the port's ``two_steps``), on the device:
    count tensor -> f32 rate tensor."""
    if cfg.schedule == "onecycle":
        return onecycle_t(lr, max(total_steps, 1))
    if cfg.schedule == "two_steps":
        return two_steps_t(lr, cfg.warmup_steps, total_steps)
    return cosine_to_floor_t(lr, cfg.lr_final, total_steps)


OPTAX_ADAMW_DECAY = 1e-4     # optax.adamw's default weight_decay
ADAM_B1, ADAM_B2 = adam_kernel.B1, adam_kernel.B2


class AdamGroup:
    """optax's ``adam``/``adamw`` on a list of parameters, its rate from a
    device schedule: moments mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 +
    b2 nu, bias-corrected with the count after this update, the update
    mu_hat / (sqrt(nu_hat) + eps), plus ``weight_decay`` p (adamw), times
    -rate(count).  Every quantity is a device tensor and the moments are
    updated in place, so an update can be captured in a CUDA graph: on a
    CUDA device one pass of ``ops/adam_kernel.py``'s kernel, on the CPU its
    foreach passes.  A parameter without a gradient takes a zero one, as in
    JAX, where every leaf has a gradient.  ``lr`` holds the last rate
    used."""

    def __init__(self, params, sched, eps: float, weight_decay: float = 0.0):
        self.params = list(params)
        self.sched, self.eps, self.weight_decay = sched, eps, weight_decay
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.lr = None

    @torch.no_grad()
    def update(self, count, bc1, bc2):
        """One update at ``count`` (updates taken before it), ``bc1`` and
        ``bc2`` the bias corrections 1 - b^(count + 1)."""
        if not self.params:
            return
        self.lr = self.sched(count)
        adam_kernel.update(self.params, [p.grad for p in self.params],
                           self.exp_avg, self.exp_avg_sq, self.lr, bc1, bc2,
                           self.eps, self.weight_decay)


class GroupedOptimizer:
    """Adam on the encoder tables, AdamW on the MLP, both on
    ``cfg.schedule``; AdamW on the SDF sharpness at a constant rate.
    ``field`` may be a list of fields (the scenes of a multi-scene fit),
    each group then holding every field's parameters of its kind.  The
    update count lives on the device (``count``, int32, as optax's), so
    that the schedule, the bias corrections and the count's increment run
    inside a captured training step as they run eagerly."""

    def __init__(self, cfg: TrainConfig, total_steps: int, field):
        fields = field if isinstance(field, (list, tuple)) else [field]
        tables = [p for f in fields for p in (
            *f.dense, *f.lines, *([] if f.table is None else [f.table]))]
        mlp = [p for f in fields for p in f.mlp.parameters()]
        self.count = torch.zeros((), dtype=torch.int32,
                                 device=mlp[0].device)
        self.total_steps = total_steps
        self.groups = [
            AdamGroup(tables, make_schedule(cfg, cfg.lr_hash, total_steps),
                      eps=1e-15),
            AdamGroup(mlp, make_schedule(cfg, cfg.lr_mlp, total_steps),
                      eps=1e-8, weight_decay=cfg.weight_decay),
        ]
        var = [f.var_b for f in fields if f.var_b is not None]
        if var:
            self.groups.append(AdamGroup(
                var, lambda count: torch.full_like(count, cfg.lr_var,
                                                   dtype=torch.float32),
                eps=1e-8, weight_decay=OPTAX_ADAMW_DECAY))

    def zero_grad(self):
        for g in self.groups:
            for p in g.params:
                p.grad = None

    def set_count(self, count: int):
        """Write the update count (a host integer) to the device."""
        self.count.fill_(count)

    def step(self, count: Optional[int] = None):
        """Apply one update at learning rate schedule(count), ``count`` the
        updates taken before it (the device count when not given), and
        advance the device count."""
        if count is not None:
            self.set_count(count)
        c1 = self.count.to(torch.float32) + 1.0
        bc1 = 1.0 - torch.pow(ADAM_B1, c1)
        bc2 = 1.0 - torch.pow(ADAM_B2, c1)
        for g in self.groups:
            g.update(self.count, bc1, bc2)
        self.count.add_(1)

    def _slot(self, p):
        for g in self.groups:
            for i, q in enumerate(g.params):
                if q is p:
                    return g, i
        raise KeyError("not a parameter of this optimizer")

    def moments(self, p):
        """(first moment, second moment) of parameter p: zeros before its
        first update."""
        g, i = self._slot(p)
        return g.exp_avg[i], g.exp_avg_sq[i]

    def set_moments(self, p, count: int, exp_avg, exp_avg_sq):
        """Install p's Adam moments (in place) and the update count."""
        g, i = self._slot(p)
        g.exp_avg[i].copy_(exp_avg)
        g.exp_avg_sq[i].copy_(exp_avg_sq)
        self.set_count(count)


def make_optimizer(cfg: TrainConfig, total_steps: int, field) -> GroupedOptimizer:
    return GroupedOptimizer(cfg, total_steps, field)


@dataclasses.dataclass
class TrainState:
    """Step count (updates taken), the field (parameters), its optimizer
    and the occupancy grid once it is attached."""

    step: int
    field: torch.nn.Module
    opt: GroupedOptimizer
    occ: Optional[OccupancyGrid] = None


def create_train_state(field, cfg: TrainConfig, total_steps: int,
                       occ: Optional[OccupancyGrid] = None) -> TrainState:
    return TrainState(0, field, make_optimizer(cfg, total_steps, field), occ)
