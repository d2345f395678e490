"""Checkpoints in the JAX package's ``.npz`` layout (counterpart of the JAX
train/checkpoint.py).

A JAX checkpoint stores the params pytree positionally, ``leaf_i`` in
``jax.tree_util`` flatten order, with extras as ``extra_<name>``.  Dict keys
flatten sorted, so a model's leaves are the dense grids, then the factor
lines, then ``mlp.col[*]``, then ``mlp.sig[*]``, each layer ``b`` before
``w``, and last the hash table (``"mlp" < "table"``); JAX stores ``w`` as (d_in, d_out), the transpose of
``nn.Linear.weight``.  A full train-state checkpoint stores (params,
opt_state), so its params are a positional prefix and load the same way.
The occupancy grid rides along as ``extra_occ_{density,mask,threshold}``.
``save_train_state`` writes the params plus ``extra_step`` and those
extras; the optimizer state is not saved yet, so a port-written checkpoint
restores a model (in either package) but does not resume training.  Bounds
are ``np.stack([min, max])`` under either spelling,
``bounds_model.npy`` or ``bounds.npy``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.models.nerf import Field
from human_body_reconstruction_tpu_torch.ops.occupancy import OccupancyGrid
from human_body_reconstruction_tpu_torch.utils.config import PipelineConfig

OCC_KEYS = ("occ_density", "occ_mask", "occ_threshold")


def _slots(field: Field):
    """(parameter, transposed?) in JAX flatten order."""
    slots = [(p, False) for p in field.dense]
    slots += [(p, False) for p in field.lines]
    for branch in (field.mlp.col, field.mlp.sig):
        for layer in branch:
            slots += [(layer.bias, False), (layer.weight, True)]
    if field.table is not None:
        slots.append((field.table, False))
    return slots


def jax_leaves(field: Field) -> list:
    """The field's parameters as numpy arrays in JAX leaf order/layout."""
    return [(p.detach().t() if tr else p.detach()).cpu().numpy()
            for p, tr in _slots(field)]


def load_leaves(field: Field, leaves):
    """Copy JAX-ordered leaves (numpy) into the field, checking shapes."""
    slots = _slots(field)
    if len(leaves) < len(slots):
        raise ValueError(f"{len(leaves)} leaves for a model of {len(slots)}")
    with torch.no_grad():
        for i, ((p, tr), arr) in enumerate(zip(slots, leaves)):
            want = tuple(p.t().shape if tr else p.shape)
            if tuple(np.shape(arr)) != want:
                raise ValueError(
                    f"checkpoint leaf {i} shape {np.shape(arr)} does not "
                    f"match the model's {want}: the config (encoder "
                    "variant, levels, rank, activations) differs from "
                    "training")
            t = torch.as_tensor(np.asarray(arr, np.float32))
            p.copy_(t.t() if tr else t)
    return field


def to_jax_params(field: Field) -> dict:
    """The field as the JAX params pytree, with numpy leaves."""
    def layers(branch):
        return [{"b": l.bias.detach().cpu().numpy(),
                 "w": l.weight.detach().t().cpu().numpy()} for l in branch]

    tree = {"mlp": {"col": layers(field.mlp.col),
                    "sig": layers(field.mlp.sig)}}
    if len(field.lines):
        tree["lines"] = tuple(p.detach().cpu().numpy() for p in field.lines)
    if len(field.dense):
        tree["dense"] = tuple(p.detach().cpu().numpy() for p in field.dense)
    if field.table is not None:
        tree["table"] = field.table.detach().cpu().numpy()
    return tree


def from_jax_params(tree, cfg: PipelineConfig, device=None) -> Field:
    """A Field on ``device`` holding the JAX params pytree ``tree``
    (numpy or array-like leaves)."""
    def layers(branch):
        return [v for layer in branch for v in (layer["b"], layer["w"])]

    leaves = (list(tree.get("dense", ())) + list(tree.get("lines", ()))
              + layers(tree["mlp"]["col"]) + layers(tree["mlp"]["sig"])
              + ([tree["table"]] if "table" in tree else []))
    return load_leaves(Field(cfg), leaves).to(device)


def save_params(path: str, field: Field, extra=None):
    """Write the field as a JAX-layout ``.npz`` (plus ``extra_*`` arrays)."""
    payload = {f"leaf_{i}": a for i, a in enumerate(jax_leaves(field))}
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = np.asarray(
            v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def occ_extras(occ: OccupancyGrid) -> dict:
    return dict(zip(OCC_KEYS, occ))


def save_train_state(path: str, state):
    """The trainer's checkpoint: the field's params as the leading
    ``leaf_i`` (JAX order), the step count, and the occupancy grid when
    attached."""
    extra = {"step": np.int64(state.step)}
    if state.occ is not None:
        extra.update(occ_extras(state.occ))
    save_params(path, state.field, extra=extra)


def load_params(path: str, field: Field) -> Field:
    """Fill the field from a JAX-layout checkpoint (bare params or full
    train state)."""
    with np.load(path) as data:
        n = len(_slots(field))
        missing = [i for i in range(n) if f"leaf_{i}" not in data]
        if missing:
            raise ValueError(f"{path} lacks leaves {missing}")
        return load_leaves(field, [data[f"leaf_{i}"] for i in range(n)])


def load_occ(path: str, device=None):
    """The occupancy grid saved in a checkpoint's extras, or None."""
    with np.load(path) as data:
        if "extra_occ_density" not in data:
            return None
        return OccupancyGrid(*(torch.as_tensor(data[f"extra_{k}"],
                                               dtype=torch.float32,
                                               device=device)
                               for k in OCC_KEYS))


def save_bounds(path: str, min_bound, max_bound):
    np.save(path, np.stack([np.asarray(min_bound), np.asarray(max_bound)]))


def load_bounds(path: str):
    """(min (3,), max (3,)) float32 from either bounds filename."""
    candidates = [path]
    d, b = os.path.dirname(path) or ".", os.path.basename(path)
    alt = {"bounds.npy": "bounds_model.npy",
           "bounds_model.npy": "bounds.npy"}.get(b)
    if alt:
        candidates.append(os.path.join(d, alt))
    for p in candidates:
        if os.path.exists(p):
            arr = np.load(p)
            return arr[0].astype(np.float32), arr[1].astype(np.float32)
    raise FileNotFoundError(f"no bounds file at any of {candidates}")
