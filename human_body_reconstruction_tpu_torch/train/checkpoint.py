"""Checkpoints in the JAX package's ``.npz`` layout (counterpart of the JAX
train/checkpoint.py).

A JAX checkpoint stores a pytree positionally, ``leaf_i`` in
``jax.tree_util`` flatten order, with extras as ``extra_<name>``.  Dict keys
flatten sorted, so a model's leaves are the dense grids, then the factor
lines, then ``mlp.col[*]``, then ``mlp.sig[*]``, each layer ``b`` before
``w``, then the hash table (``"mlp" < "table"``) and last, in SDF mode, the
sharpness ``var.b`` (a 0-d array); JAX stores ``w`` as (d_in, d_out), the
transpose of ``nn.Linear.weight``.  The neuralangelo head's weight-normed
layers (the port's own, no JAX counterpart) take the same places with
three leaves each, ``b``, ``g`` and ``v`` (d_in, d_out).

``save_train_state`` writes (params, opt_state) as JAX does, so either
package continues the other's run, with ``extra_step``, the occupancy grid
(``extra_occ_{density,mask,threshold}``) and the port's own
``extra_torch_rng``, the training generator's state, which the JAX loader
ignores.  The optax state of ``train/state.make_optimizer`` is one block a
label, in sorted label order (``opt_blocks``): ``dense``, ``lines`` and
``mlp`` hold Adam's count, its first moments, its second moments and the
schedule's count; ``table`` the same, and JAX builds it even for a model
with no table, where it holds the two counts alone; ``var`` holds count,
first and second moment (its constant rate keeps no state).  A full
checkpoint's params are a positional prefix, so ``load_params`` reads
either a bare params file or a train state.  Bounds are
``np.stack([min, max])`` under either spelling, ``bounds_model.npy`` or
``bounds.npy``.  ``save_pytree``/``load_pytree`` write and read any params
tree of nested dicts, lists and tuples (the vanilla NeRF's and the image
fit's, ``models/mlp.to_jax_tree``) as the JAX functions of the same names
do.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.models.nerf import Field
from human_body_reconstruction_tpu_torch.ops.occupancy import OccupancyGrid
from human_body_reconstruction_tpu_torch.utils.config import PipelineConfig

OCC_KEYS = ("occ_density", "occ_mask", "occ_threshold")


def _layer_slots(layer):
    if isinstance(layer, torch.nn.Linear):
        return [(layer.bias, False), (layer.weight, True)]
    return layer.slots()


def _mlp_slots(field: Field):
    return [s for branch in (field.mlp.col, field.mlp.sig)
            for layer in branch for s in _layer_slots(layer)]


def _slots(field: Field):
    """(parameter, transposed?) in JAX flatten order."""
    slots = [(p, False) for p in field.dense]
    slots += [(p, False) for p in field.lines]
    slots += _mlp_slots(field)
    if field.table is not None:
        slots.append((field.table, False))
    if field.var_b is not None:
        slots.append((field.var_b, False))
    return slots


def opt_blocks(field: Field):
    """The optax state's blocks in flatten order: (label, [(parameter,
    transposed?)], scheduled?).  The ``lines`` label exists for a CP model,
    ``dense`` with dense levels, ``var`` in SDF mode; ``table`` always."""
    slots = _slots(field)
    n_d, n_l = len(field.dense), len(field.lines)
    n_m = len(_mlp_slots(field))
    blocks = []
    if n_d:
        blocks.append(("dense", slots[:n_d], True))
    if field.variant == "cp":
        blocks.append(("lines", slots[n_d:n_d + n_l], True))
    blocks.append(("mlp", slots[n_d + n_l:n_d + n_l + n_m], True))
    blocks.append(("table", [] if field.table is None
                   else [(field.table, False)], True))
    if field.var_b is not None:
        blocks.append(("var", [(field.var_b, False)], False))
    return blocks


def _jax_layout(t, transposed: bool) -> np.ndarray:
    return (t.detach().t() if transposed else t.detach()).cpu().numpy()


def opt_leaves(field: Field, opt, step: int) -> list:
    """The optimizer's state as the optax leaves of ``opt_blocks``, numpy,
    in the JAX layout: counts int32, moments float32.  A label's counts
    are the update count ``step``, as every optax count is."""
    count = np.asarray(step, np.int32)
    leaves = []
    for _, slots, scheduled in opt_blocks(field):
        mom = [opt.moments(p) for p, _ in slots]
        leaves.append(count)
        leaves += [_jax_layout(m[0], tr) for m, (_, tr) in zip(mom, slots)]
        leaves += [_jax_layout(m[1], tr) for m, (_, tr) in zip(mom, slots)]
        if scheduled:
            leaves.append(count)
    return leaves


def load_opt_leaves(field: Field, opt, leaves):
    """Install optax leaves (numpy, the ``opt_blocks`` layout) as the
    optimizer's Adam state, checking shapes."""
    it = iter(leaves)
    for label, slots, scheduled in opt_blocks(field):
        count = int(next(it))
        mom = [[next(it) for _ in slots] for _ in range(2)]
        if scheduled:
            next(it)
        for i, (p, tr) in enumerate(slots):
            want = tuple(p.t().shape if tr else p.shape)
            arrs = [mom[0][i], mom[1][i]]
            if any(tuple(np.shape(a)) != want for a in arrs):
                raise ValueError(f"optimizer state of {label!r} does not "
                                 f"match the model's {want}")
            m, v = (torch.as_tensor(np.asarray(a, np.float32)) for a in arrs)
            opt.set_moments(p, count, m.t() if tr else m, v.t() if tr else v)


def jax_leaves(field: Field) -> list:
    """The field's parameters as numpy arrays in JAX leaf order/layout."""
    return [_jax_layout(p, tr) for p, tr in _slots(field)]


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
    if field.var_b is not None:
        tree["var"] = {"b": field.var_b.detach().cpu().numpy()}
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
              + ([tree["table"]] if "table" in tree else [])
              + ([tree["var"]["b"]] if "var" in tree else []))
    return load_leaves(Field(cfg), leaves).to(device)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples in
    ``jax.tree_util`` flatten order (a dict's keys sorted)."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for sub in tree for v in tree_leaves(sub)]
    return [tree]


def tree_unflatten(template, leaves):
    """``template``'s structure holding ``leaves`` (flatten order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(sub) for sub in t)
        return next(it)

    return build(template)


def save_pytree(path: str, tree, extra=None):
    """Write a params tree (numpy leaves) as the JAX ``save_pytree`` does:
    ``leaf_i`` in flatten order, extras as ``extra_<name>``."""
    _write(path, _payload([np.asarray(v) for v in tree_leaves(tree)], extra))


def load_pytree(path: str, template, extra_keys=()):
    """(tree, extras) read from a ``save_pytree`` file of either package
    into ``template``'s structure, each leaf's shape checked against the
    template's."""
    want = tree_leaves(template)
    with np.load(path) as data:
        leaves = []
        for i, leaf in enumerate(want):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(np.shape(leaf)):
                raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != "
                                 f"model {np.shape(leaf)}")
            leaves.append(arr)
        extra = {k: data[f"extra_{k}"] for k in extra_keys
                 if f"extra_{k}" in data}
    return tree_unflatten(template, leaves), extra


def _payload(leaves, extra=None) -> dict:
    payload = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = np.asarray(
            v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    return payload


def _write(path: str, payload: dict):
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def save_params(path: str, field: Field, extra=None):
    """Write the field as a JAX-layout ``.npz`` (plus ``extra_*`` arrays)."""
    _write(path, _payload(jax_leaves(field), extra))


def occ_extras(occ: OccupancyGrid) -> dict:
    return dict(zip(OCC_KEYS, occ))


def save_train_state(path: str, state, generator=None):
    """The trainer's checkpoint: (params, opt_state) as the JAX package
    writes them, the step count, the occupancy grid when attached, and the
    generator's state when given."""
    extra = {"step": np.int64(state.step)}
    if state.occ is not None:
        extra.update(occ_extras(state.occ))
    if generator is not None:
        extra["torch_rng"] = generator.get_state()
    _write(path, _payload(jax_leaves(state.field) + opt_leaves(
        state.field, state.opt, state.step), extra))


def load_train_state(path: str, state, allow_occ: bool = True,
                     generator=None, seed: int = 0):
    """Fill ``state`` (field, optimizer, step, grid) from a train-state
    checkpoint of either package, in place; returns it.  ``allow_occ``
    gates a saved grid into a state that has none (as in JAX: True when the
    run's occupancy is held back by its warmup, False when the config has
    none).  ``generator`` takes the saved ``extra_torch_rng``; a file
    without one (the JAX package's) reseeds it from (seed, step)."""
    n = len(_slots(state.field))
    with np.load(path) as data:
        n_opt = sum(1 + 2 * len(slots) + scheduled
                    for _, slots, scheduled in opt_blocks(state.field))
        missing = [i for i in range(n + n_opt) if f"leaf_{i}" not in data]
        if missing:
            raise ValueError(f"{path} holds no optimizer state (leaves "
                             f"{missing[0]}..{n + n_opt - 1} missing): a "
                             "bare params file restores a model but does "
                             "not continue its training")
        leaves = [data[f"leaf_{i}"] for i in range(n + n_opt)]
        step = int(data["extra_step"]) if "extra_step" in data else 0
        rng = data["extra_torch_rng"] if "extra_torch_rng" in data else None
    load_leaves(state.field, leaves[:n])
    load_opt_leaves(state.field, state.opt, leaves[n:])
    state.step = step
    saved = load_occ(path, next(state.field.parameters()).device)
    if saved is not None and (allow_occ or state.occ is not None):
        state.occ = saved
    if generator is not None:
        if rng is not None and rng.size == generator.get_state().numel():
            generator.set_state(torch.as_tensor(rng, dtype=torch.uint8))
        else:
            generator.manual_seed(seed * 2 ** 32 + step)
    return state


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
