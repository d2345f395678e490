"""The ranks of the parallel port tests (tests/test_torch_parallel.py and
tests/test_torch_sample_parallel.py): module-level functions that the
tests run in worlds of processes started by ``parallel.comm.spawn``
(spawn start method, gloo on the CPU, a ``file://`` rendezvous).  They
import torch and the port, never JAX: what JAX computes reaches them as
numpy arrays (params, draws) and goes back to the test as numpy arrays.

``run_cases`` runs a list of (name, case, payload) one after another in the
same world, so that one spawn serves many tests; each case returns its
result on every rank of its layout and None elsewhere.
"""

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.ops import hash_encoding, rays
from human_body_reconstruction_tpu_torch.parallel import comm
from human_body_reconstruction_tpu_torch.parallel import data_parallel as dp
from human_body_reconstruction_tpu_torch.parallel import level_parallel as lp
from human_body_reconstruction_tpu_torch.parallel import sample_parallel as sp
from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
from human_body_reconstruction_tpu_torch.train import state as state_lib
from human_body_reconstruction_tpu_torch.train import step as step_lib


def run_cases(device, cases):
    """{name: case(device, payload)} for each (name, case name, payload)."""
    torch.set_num_threads(1)
    return {name: globals()[case](device, payload)
            for name, case, payload in cases}


def _t(a):
    return None if a is None else torch.as_tensor(np.asarray(a))


def _data(p):
    scene = nerf.scene_from_bounds(*p["bounds"])
    return scene, _t(p["images"]), _t(p["c2ws"]), _t(p["K"])


def whole_grads(field, cfg, mesh):
    """{group: flat gradient} in the port's parameter order, the sharded
    lines or table joined over the level group first."""
    def grad(p):
        return torch.zeros_like(p) if p.grad is None else p.grad

    out = {}
    if len(field.dense):
        out["dense"] = [grad(p) for p in field.dense]
    if len(field.lines):
        out["lines"] = [grad(p) for p in field.lines]
    if field.table is not None:
        out["table"] = [grad(field.table)]
    if field.lp is not None:
        key = "lines" if len(field.lines) else "table"
        out[key] = [lp._joined(g, cfg, mesh.inner_group) for g in out[key]]
    out["mlp"] = [grad(p) for p in field.mlp.parameters()]
    return {k: torch.cat([g.reshape(-1) for g in v]).numpy()
            for k, v in out.items()}


def _state(p, cfg, mesh):
    field = ckpt.from_jax_params(p["params"], cfg)
    state = state_lib.create_train_state(field, cfg.train, p["total"])
    state.step = p["step"]
    if p["kind"] == "lp":
        state = lp.shard_lp_state(state, cfg, mesh, p["total"])
    return state


def _feed(shards, mesh):
    """This rank's draws of one step: its data shard's indices and jitter,
    and in int8 mode its level rank's encoder draws."""
    d = shards[mesh.data_index]
    draws = {"u": _t(d["u"])}
    if "enc" in d:          # this level rank's encoder draws
        draws.update({f"enc_{k}": _t(v)
                      for k, v in d["enc"][mesh.inner_index].items()})
    return {"img_idx": _t(d["img"]), "pix_idx": _t(d["pix"]), "draws": draws}


def _make_step(p, cfg, mesh, n: int = 1):
    make = (lp.make_lp_train_step if p["kind"] == "lp"
            else dp.make_dp_train_step)
    return make(cfg, p["batch"], mesh, steps_per_call=n)


def step_case(device, p):
    """One data- or level-parallel step on JAX's params with JAX's draws:
    the metrics, the averaged (and joined) gradients and the parameters
    after the update."""
    cfg = p["cfg"]
    mesh = comm.make_mesh(*p["shape"], "level")
    if mesh is None:
        return None
    state = _state(p, cfg, mesh)
    m = _make_step(p, cfg, mesh)(state, *_data(p),
                                 **_feed(p["draws"], mesh))
    grads = whole_grads(state.field, cfg, mesh)
    whole = (lp.gather_lp_state(state, cfg, mesh) if p["kind"] == "lp"
             else state)
    return {"metrics": {k: float(v) for k, v in m.items()}, "grads": grads,
            "params": ckpt.jax_leaves(whole.field)}


def window_case(device, p):
    """A window of ``p["n"]`` data- or level-parallel steps on JAX's params,
    each step handed JAX's draws for it: the window's mean metrics, the
    step and device counts, and the (joined) parameters after it."""
    cfg = p["cfg"]
    mesh = comm.make_mesh(*p["shape"], "level")
    if mesh is None:
        return None
    state = _state(p, cfg, mesh)
    m = _make_step(p, cfg, mesh, p["n"])(
        state, *_data(p), feeds=[_feed(d, mesh) for d in p["window_draws"]])
    whole = (lp.gather_lp_state(state, cfg, mesh) if p["kind"] == "lp"
             else state)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "counts": (state.step, int(state.opt.count)),
            "params": ckpt.jax_leaves(whole.field)}


def extents_case(device, p):
    """The same three steps at level extents ``p["extents"]`` (data extent
    1, the port's own folded draws): per extent, the losses, the first
    step's joined gradients and the joined lines or table after."""
    cfg = p["cfg"]
    out = {}
    for k in p["extents"]:
        mesh = comm.make_mesh(1, k, "level")
        if mesh is None:
            continue
        state = _state(dict(p, kind="lp"), cfg, mesh)
        step = lp.make_lp_train_step(cfg, p["batch"], mesh)
        losses, grads = [], None
        for _ in range(3):
            losses.append(float(step(state, *_data(p))["loss"]))
            grads = grads or whole_grads(state.field, cfg, mesh)
        whole = lp.gather_lp_state(state, cfg, mesh)
        out[k] = {"losses": losses, "grads": grads,
                  "params": ckpt.jax_leaves(whole.field)}
    return out


def streams_case(device, p):
    """One stochastic level-parallel step on a (2, 2) layout, recording
    this rank's ray origins and the uniforms its encoder drew."""
    cfg = p["cfg"]
    mesh = comm.make_mesh(2, 2, "level")
    if mesh is None:
        return None
    rec = {}
    sample, uniform = step_lib.sample_ray_batch, hash_encoding.stoch_uniform

    def spy_sample(*a, **k):
        out = sample(*a, **k)
        rec["rays_o"] = out[0].numpy().copy()
        return out

    def spy_uniform(*a, **k):
        u = uniform(*a, **k)
        rec["u"] = u.numpy().copy()
        return u

    step_lib.sample_ray_batch = spy_sample
    hash_encoding.stoch_uniform = spy_uniform
    try:
        state = _state(dict(p, kind="lp"), cfg, mesh)
        lp.make_lp_train_step(cfg, p["batch"], mesh)(state, *_data(p))
    finally:
        step_lib.sample_ray_batch = sample
        hash_encoding.stoch_uniform = uniform
    return {"index": (mesh.data_index, mesh.inner_index), **rec}


def trainer_case(device, p):
    """The fit loop under level parallelism on the whole world: steps
    across the grid's install and refreshes, the checkpoint joined and
    written by rank 0, a level-parallel render of a frame, and a second run
    that loads the checkpoint (sharded again) and takes one more step."""
    from human_body_reconstruction_tpu_torch.data import synthetic
    from human_body_reconstruction_tpu_torch.train.trainer import Trainer

    cfg, k = p["cfg"], p["level_parallel"]
    ds = synthetic.make_dataset(n_views=3, H=12, W=12, focal=15.0,
                                gt_samples=32)
    kw = dict(cfg=cfg, ds=ds, out_dir=p["out_dir"], model_name="lp",
              total_steps=8, level_parallel=k, log_fn=lambda line: None)
    tr = Trainer(**kw)
    tr.run(p["steps"], log_every=2)
    tr.save()
    grids = comm.all_gather_stack(tr.state.occ.density, None)
    render = lp.make_lp_render(cfg, tr.mesh, num_samples=16)
    o, d, n = rays.full_image_rays(10, 10, _t(p["K"]), _t(p["c2w"]))
    with torch.no_grad():
        img = render(tr.state.field, tr.scene, o.reshape(-1, 3),
                     d.reshape(-1, 3), n.reshape(-1, 1), occ=tr.state.occ)
    tr2 = Trainer(**kw)
    tr2.load()
    loaded = tr2.state.step
    tr2.run(1, log_every=0)
    return {"img": img.numpy(), "grids_equal": bool(
        all(torch.equal(g, grids[0]) for g in grids)),
        "loaded_step": loaded, "step_after": tr2.state.step,
        "local_shape": tuple(lp._sharded(tr.state.field)[0].shape),
        "history": tr.history}


def dp_render_case(device, p):
    """``make_dp_render`` of JAX's params on a (2, 1) layout."""
    cfg = p["cfg"]
    mesh = comm.make_mesh(2, 1, "data")
    if mesh is None:
        return None
    field = ckpt.from_jax_params(p["params"], cfg)
    render = dp.make_dp_render(cfg, mesh, num_samples=p["num_samples"])
    with torch.no_grad():
        return render(field, nerf.scene_from_bounds(*p["bounds"]),
                      *(_t(a) for a in p["rays"])).numpy()


def multi_case(device, p):
    """One multi-scene step of 4 seeded scenes split over a (2, 1) layout:
    the mean loss over every scene, and the scenes this rank fitted."""
    from human_body_reconstruction_tpu_torch.parallel import multi_scene as ms

    cfg = p["cfg"]
    mesh = comm.make_mesh(2, 1, "data")
    if mesh is None:
        return None
    fields = ms.init_multi_fields(cfg, 4, torch.Generator().manual_seed(0))
    mine = list(ms.local_scenes(4, mesh))
    state = ms.create_multi_state([fields[s] for s in mine], cfg, 10)
    scene, images, c2ws, K = _data(p)
    m = ms.make_multi_train_step(cfg, p["batch"], mesh)(
        state, [scene] * 2, [images] * 2, [c2ws] * 2, [K] * 2,
        [torch.Generator().manual_seed(100 + s) for s in mine])
    return {"loss": float(m["loss"]), "scenes": mine}


def dryrun_case(device, p):
    from human_body_reconstruction_tpu_torch.parallel import dryrun

    return dryrun.dryrun(device)


def sp_case(device, p):
    """``make_sp_render`` on a (data, sample) layout of JAX's params."""
    cfg = p["cfg"]
    mesh = sp.make_sp_mesh(*p["shape"])
    if mesh is None:
        return None
    field = ckpt.from_jax_params(p["params"], cfg)
    occ = None
    if p.get("occ") is not None:
        from human_body_reconstruction_tpu_torch.ops.occupancy import (
            OccupancyGrid)

        occ = OccupancyGrid(*(_t(a) for a in p["occ"]))
    render = sp.make_sp_render(cfg, mesh, p["num_samples"],
                               compute_dtype=None)
    scene = nerf.scene_from_bounds(*p["bounds"])
    return render(field, scene, *(_t(a) for a in p["rays"]), occ=occ).numpy()
