"""Training state: the grouped optimizer and its schedule (counterpart of
the JAX train/state.py).

The JAX package drives one ``optax.multi_transform`` over the params
pytree: Adam (eps 1e-15) on the embedding-like groups ``dense``,
``lines`` and ``table``, AdamW (weight decay ``cfg.weight_decay``) on ``mlp``, each on
``cosine_to_floor`` of its own base rate.  Here the groups are two
``torch.optim`` optimizers whose learning rate is set from the closed-form
schedule before every step, evaluated at the count of updates taken so far
(optax's ``scale_by_schedule`` reads its count before incrementing it).
torch's recursive ``CosineAnnealingLR`` is not used: it drifts from the
closed form.  Only the "cosine" schedule is ported.
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


class GroupedOptimizer:
    """Adam on the encoder tables, AdamW on the MLP, both scheduled."""

    def __init__(self, cfg: TrainConfig, total_steps: int, field):
        if cfg.schedule != "cosine":
            raise NotImplementedError(
                f"schedule {cfg.schedule!r} is not ported; only 'cosine'")
        tables = list(field.dense) + list(field.lines)
        if field.table is not None:
            tables.append(field.table)
        self.groups = [
            (torch.optim.Adam(tables, lr=cfg.lr_hash, eps=1e-15),
             cosine_to_floor(cfg.lr_hash, cfg.lr_final, total_steps)),
            (torch.optim.AdamW(field.mlp.parameters(), lr=cfg.lr_mlp,
                               weight_decay=cfg.weight_decay),
             cosine_to_floor(cfg.lr_mlp, cfg.lr_final, total_steps)),
        ]

    def zero_grad(self):
        for opt, _ in self.groups:
            opt.zero_grad(set_to_none=True)

    def step(self, count: int):
        """Apply one update at learning rate schedule(count)."""
        for opt, sched in self.groups:
            for group in opt.param_groups:
                group["lr"] = sched(count)
            opt.step()


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
