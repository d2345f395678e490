"""Training state: the grouped optimizer and its schedule (counterpart of
the JAX train/state.py).

The JAX package drives one ``optax.multi_transform`` over the params
pytree: Adam (eps 1e-15) on the embedding-like groups ``dense``,
``lines`` and ``table``, AdamW (weight decay ``cfg.weight_decay``) on ``mlp``, each on
``cosine_to_floor`` of its own base rate, and in SDF mode AdamW at the
constant rate ``cfg.lr_var`` with optax's default weight decay 1e-4 (not
torch's 1e-2) on the sharpness ``var``.  Here the groups are
``torch.optim`` optimizers whose learning rate is set from the closed-form
schedule before every step, evaluated at the count of updates taken so far
(optax's ``scale_by_schedule`` reads its count before incrementing it).
``moments``/``set_moments`` read and write one parameter's Adam moments
(and count), which the checkpoint maps to the optax state.
torch's recursive ``CosineAnnealingLR`` is not used: it drifts from the
closed form.  The "onecycle" schedule is optax's
``cosine_onecycle_schedule``, also in closed form (``onecycle``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

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


def make_schedule(cfg: TrainConfig, lr: float, total_steps: int):
    """The schedule of a group whose base rate is ``lr`` (JAX
    ``_make_schedule``)."""
    if cfg.schedule == "onecycle":
        return onecycle(lr, max(total_steps, 1))
    return cosine_to_floor(lr, cfg.lr_final, total_steps)


OPTAX_ADAMW_DECAY = 1e-4     # optax.adamw's default weight_decay


class GroupedOptimizer:
    """Adam on the encoder tables, AdamW on the MLP, both on
    ``cfg.schedule``; AdamW on the SDF sharpness at a constant rate.
    ``field`` may be a list of fields (the scenes of a multi-scene fit),
    each group then holding every field's parameters of its kind."""

    def __init__(self, cfg: TrainConfig, total_steps: int, field):
        fields = field if isinstance(field, (list, tuple)) else [field]
        tables = [p for f in fields for p in (
            *f.dense, *f.lines, *([] if f.table is None else [f.table]))]
        self.groups = [
            (torch.optim.Adam(tables, lr=cfg.lr_hash, eps=1e-15),
             make_schedule(cfg, cfg.lr_hash, total_steps)),
            (torch.optim.AdamW([p for f in fields for p in f.mlp.parameters()],
                               lr=cfg.lr_mlp, weight_decay=cfg.weight_decay),
             make_schedule(cfg, cfg.lr_mlp, total_steps)),
        ]
        var = [f.var_b for f in fields if f.var_b is not None]
        if var:
            self.groups.append(
                (torch.optim.AdamW(var, lr=cfg.lr_var,
                                   weight_decay=OPTAX_ADAMW_DECAY),
                 lambda count: cfg.lr_var))

    def zero_grad(self):
        for opt, _ in self.groups:
            opt.zero_grad(set_to_none=True)

    def step(self, count: int):
        """Apply one update at learning rate schedule(count)."""
        for opt, sched in self.groups:
            for group in opt.param_groups:
                group["lr"] = sched(count)
            opt.step()

    def _owner(self, p):
        return next(opt for opt, _ in self.groups
                    if any(q is p for g in opt.param_groups
                           for q in g["params"]))

    def has_state(self, p) -> bool:
        """Has parameter p had an update (so that it has Adam moments)?"""
        return bool(self._owner(p).state.get(p))

    def moments(self, p):
        """(first moment, second moment) of parameter p: zeros before its
        first update."""
        st = self._owner(p).state.get(p)
        if not st:
            return torch.zeros_like(p), torch.zeros_like(p)
        return st["exp_avg"], st["exp_avg_sq"]

    def set_moments(self, p, count: int, exp_avg, exp_avg_sq):
        """Install p's Adam state as torch keeps it (the count a float32
        tensor on the CPU)."""
        self._owner(p).state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": exp_avg.to(p.device, p.dtype).clone(),
            "exp_avg_sq": exp_avg_sq.to(p.device, p.dtype).clone()}


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
