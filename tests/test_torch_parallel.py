"""PyTorch port vs the JAX package: the data- and level-parallel steps.

The JAX side runs the JAX functions on meshes of the host's 8 CPU devices
(tests/conftest.py); the port side runs the same steps in worlds of gloo
processes started by ``parallel.comm.spawn`` from tests/torch_dist_worker.py
(which imports no JAX), one spawn serving several tests (module fixtures).
Both sides start from JAX's params and take JAX's draws: each data shard's
(image, pixel) indices and ladder jitter come from the keys the JAX shard
body derives, ``fold_in(fold_in(key, step), data index)`` -> ``split`` ->
``randint``/``uniform``, computed here and handed to each rank.  The JAX
step is given an optax transformation that records its gradients (the
update it returns is zero), so the averaged gradients of both sides can be
compared.  The configs are f32 (dense_bf16 off, f32 MLP) on the sample
ladder: tolerances as ``test_step_loss_and_grads_match_jax`` in f32, loss
rtol 1e-5 and each group's gradient within 1e-5 of its norm.

Under level parallelism JAX's gradient of the sharded group (the table's
levels, the lines' rank columns) is the level extent k times the
single-device one: the transpose of its ``all_gather`` sums the level
axis's cotangents, which the replicated MLP makes equal, and the TV's
``psum`` transposes to a sum too (measured: JAX's extent-2 and -4 gradients
divided by k equal its extent-1 gradient exactly).  Adam is invariant to
that scale, so JAX's extents take the same steps.  The port's gather and
psum hand back the single-device gradient, so its sharded group is held to
JAX's divided by k, and both take the same Adam step.  Test names avoid
the words that tests/conftest.py marks slow.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from human_body_reconstruction_tpu.cli import train_hash as jcli
from human_body_reconstruction_tpu.parallel import data_parallel as jdp
from human_body_reconstruction_tpu.parallel import level_parallel as jlp
from human_body_reconstruction_tpu.pipeline import restore as jrestore
from human_body_reconstruction_tpu.train import state as jstate
from human_body_reconstruction_tpu.train import trainer as jtrainer
from human_body_reconstruction_tpu.utils import config as jC
from human_body_reconstruction_tpu_torch.cli import train_hash
from human_body_reconstruction_tpu_torch.data import synthetic
from human_body_reconstruction_tpu_torch.ops import dense_grid
from human_body_reconstruction_tpu_torch.parallel import comm
from human_body_reconstruction_tpu_torch.parallel import level_parallel as lp
from human_body_reconstruction_tpu_torch.pipeline import restore
from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
from human_body_reconstruction_tpu_torch.train import step
from human_body_reconstruction_tpu_torch.utils import config as C
from torch_threads import one_torch_thread  # noqa: F401

LO = np.array([-1.5, -1.5, -1.5], np.float32)
HI = np.array([1.5, 1.5, 1.5], np.float32)
B = 64                  # the global ray batch
S = 16                  # ladder samples
SPAWN_TIMEOUT = 600


INT8_KW = dict(stochastic_train=True, packed=True, pack_format="int8",
               features_per_level=4, grad_subsample=True,
               grad_level_pair=True)


def cfgs(variant: str, tv_warmup: int = 0, **hash_kw):
    """(port config, JAX config) of one small f32 model: CP (rank 4 over 4
    levels, 2 dense), the corner hash grid (4 levels) or ("int8") that grid
    as int8 words at F 4 with 1-of-F and level-pair gradient routing, MLP
    width 16."""
    out = []
    if variant == "int8":
        variant, hash_kw = "corner", dict(INT8_KW, **hash_kw)
    for mod in (C, jC):
        if variant == "cp":
            h = mod.HashConfig(num_levels=4, n_max=128, variant="cp",
                               cp_rank=4, dense_bf16=False, init_scale=0.5,
                               cp_init_scale=0.6, dense_impl="xla", **hash_kw)
            h = dataclasses.replace(
                h, dense_levels=dense_grid.auto_dense_levels(h))
        else:
            h = mod.HashConfig(num_levels=4, log2_table_size=10, n_min=4,
                               n_max=64, init_scale=0.5, **hash_kw)
        out.append(mod.PipelineConfig(
            hash=h, mlp=mod.MLPConfig(width=16),
            render=mod.RenderConfig(num_samples=S),
            train=mod.TrainConfig(ray_batch=B,
                                  cp_tv_weight=1e-2 if variant == "cp"
                                  else 0.0, cp_tv_warmup=tv_warmup,
                                  compute_dtype="float32")))
    return out


def jax_params(jcfg):
    params = jax.tree.map(np.array, jtrainer.init_params(
        jax.random.PRNGKey(0), jcfg))
    params["mlp"]["sig"][-1]["b"][0] += 1.0       # visibly opaque density
    return params


def dataset(n=3, hw=8):
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(n, hw, hw, 3)).astype(np.float32)
    c2ws = synthetic.orbit_poses(n, radius=4.0, elevation=0.35)
    K = np.array([[10.0, 0, hw / 2], [0, 10.0, hw / 2], [0, 0, 1]],
                 np.float32)
    return images, c2ws, K


def jax_draws(key, step_no: int, n_data: int, images, cfg=None,
              n_level: int = 1):
    """Each data shard's draws as the JAX shard body makes them; for an int8
    ``cfg`` also each level rank's encoder draws ("enc": u, pick, psel of
    its L / n_level levels), as JAX's int8 forward makes them from the
    render key's third split folded by the level index."""
    n, h, w = images.shape[:3]
    local = B // n_data
    out = []
    for r in range(n_data):
        k = jax.random.fold_in(jax.random.fold_in(key, step_no), r)
        k_batch, k_render = jax.random.split(k)
        k1, k2 = jax.random.split(k_batch)
        k_strat, _, k_enc, _ = jax.random.split(k_render, 4)
        out.append({
            "img": np.asarray(jax.random.randint(k1, (local,), 0, n)),
            "pix": np.asarray(jax.random.randint(k2, (local,), 0, h * w)),
            "u": np.asarray(jax.random.uniform(k_strat, (local, S)))})
        if cfg is None or not cfg.hash.packed:
            continue
        L, F, m = cfg.hash.num_hashed_levels // n_level, \
            cfg.hash.features_per_level, local * S
        out[-1]["enc"] = []
        for i in range(n_level):
            kf = jax.random.fold_in(k_enc, i)
            out[-1]["enc"].append({
                "u": np.asarray(jax.random.uniform(kf, (3, L, m))),
                "pick": np.asarray(jax.random.randint(
                    jax.random.fold_in(kf, 1), (L, m), 0, F), np.uint8),
                "psel": np.asarray(jax.random.randint(
                    jax.random.fold_in(kf, 3), (L // 2, m), 0, 2),
                    np.uint8)})
    return out


def recording_tx():
    """An optax transformation that keeps the gradients as its state and
    updates nothing."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


def jax_group_grads(grads):
    """{group: flat gradient} in the port's parameter order and layout."""
    out = {}
    for k in ("dense", "lines", "table"):
        if k in grads:
            out[k] = np.concatenate([np.asarray(g).reshape(-1) for g in
                                     jax.tree_util.tree_leaves(grads[k])])
    out["mlp"] = np.concatenate(
        [np.asarray(g).reshape(-1) for branch in ("sig", "col")
         for layer in grads["mlp"][branch]
         for g in (np.asarray(layer["w"]).T, layer["b"])])
    return out


def jax_step(jcfg, params, kind: str, shape, step_no: int, key, tx=None,
             n: int = 1):
    """(metrics, gradients by group) of one JAX data- or level-parallel
    step on the first devices; given the optimizer ``tx``, (metrics, the
    params after its update, in the JAX leaf order), and with ``n`` > 1
    after a window of n steps (``steps_per_call``: its mean metrics)."""
    images, c2ws, K = dataset()
    record = tx is None
    tx = recording_tx() if record else tx
    jp = jax.tree.map(jnp.asarray, params)
    state = jstate.TrainState(step=jnp.asarray(step_no, jnp.int32),
                              params=jp, opt_state=tx.init(jp), occ=None)
    if kind == "dp":
        mesh = jdp.make_mesh(jax.devices()[:shape[0]])
        state = jdp.replicate_to_mesh(state, mesh)
        fn = jdp.make_dp_train_step(jcfg, tx, B, mesh, steps_per_call=n)
    else:
        mesh = jlp.make_lp_mesh(*shape)
        state = jlp.shard_lp_state(state, mesh)
        fn = jlp.make_lp_train_step(jcfg, tx, B, mesh, steps_per_call=n)
    state, m = fn(state, jrestore.scene_from_bounds(LO, HI),
                  jnp.asarray(images), jnp.asarray(c2ws), jnp.asarray(K), key)
    return ({k: float(v) for k, v in m.items()},
            jax_group_grads(state.opt_state) if record else
            [np.asarray(a) for a in jax.tree_util.tree_leaves(state.params)])


def nerf_scene():
    from human_body_reconstruction_tpu_torch.models import nerf

    return nerf.scene_from_bounds(LO, HI)


def frame_rays(n_side=8):
    """The rays of an n_side x n_side frame of a test pose, numpy."""
    from human_body_reconstruction_tpu_torch.ops import rays

    K = np.array([[10.0, 0, n_side / 2], [0, 10.0, n_side / 2], [0, 0, 1]],
                 np.float32)
    c2w = synthetic.orbit_poses(4, radius=4.0, elevation=0.35)[1]
    o, d, n = rays.full_image_rays(n_side, n_side, torch.tensor(K),
                                   torch.tensor(c2w))
    return (o.reshape(-1, 3).numpy(), d.reshape(-1, 3).numpy(),
            n.reshape(-1, 1).numpy())


def payload(cfg, params, kind: str, shape, step_no: int, key, **extra):
    images, c2ws, K = dataset()
    return dict(cfg=cfg, params=params, kind=kind, shape=shape, step=step_no,
                total=50, batch=B, bounds=(LO, HI), images=images,
                c2ws=c2ws, K=K, draws=jax_draws(key, step_no, shape[0],
                                                images, cfg, shape[1]),
                **extra)


# (name, variant, kind, (n_data, n_inner), step, TV warmup): the JAX-parity
# steps, all run in one world of 4 ranks
STEP_CASES = [
    ("dp2", "cp", "dp", (2, 1), 10, 5),
    ("dp4", "cp", "dp", (4, 1), 10, 5),
    ("lp_hash", "corner", "lp", (1, 2), 0, 0),
    ("lp_int8", "int8", "lp", (1, 2), 0, 0),
    ("lp_cp_tv", "cp", "lp", (1, 2), 0, 0),
    ("lp_cp_tv_gated", "cp", "lp", (1, 2), 0, 5),
]
EXTENTS = (1, 2, 4)
# (name, variant, kind, (n_data, n_inner), TV warmup, n): the windows held
# to JAX's steps_per_call steps from update 0, each step given JAX's draws;
# the CP windows turn the TV on at update 2, inside the window
WINDOW_CASES = [
    ("dp_window", "cp", "dp", (2, 1), 2, 3),
    ("lp_hash_window", "corner", "lp", (1, 2), 0, 3),
    ("lp_cp_window", "cp", "lp", (1, 2), 2, 3),
]


@pytest.fixture(scope="module")
def world4():
    """The JAX steps, and the port's in one spawned world of 4 ranks: the
    STEP_CASES, three steps at each level extent, and the stochastic
    streams of a (2, 2) layout."""
    key = jax.random.PRNGKey(7)
    jax_out, cases = {}, []
    for name, variant, kind, shape, step_no, warm in STEP_CASES:
        cfg, jcfg = cfgs(variant, warm)
        params = jax_params(jcfg)
        jax_out[name] = jax_step(jcfg, params, kind, shape, step_no, key)
        if kind == "lp":
            jax_out[name + "/adam"] = jax_step(
                jcfg, params, kind, shape, step_no, key,
                jstate.make_optimizer(jcfg.train, 50, params))
        cases.append((name, "step_case", payload(cfg, params, kind, shape,
                                                 step_no, key)))
    for name, variant, kind, shape, warm, n in WINDOW_CASES:
        cfg, jcfg = cfgs(variant, warm)
        params = jax_params(jcfg)
        jax_out[name] = jax_step(jcfg, params, kind, shape, 0, key,
                                 jstate.make_optimizer(jcfg.train, 50,
                                                       params), n=n)
        images = dataset()[0]
        cases.append((name, "window_case", payload(
            cfg, params, kind, shape, 0, key, n=n, window_draws=[
                jax_draws(key, i, shape[0], images, cfg, shape[1])
                for i in range(n)])))
    cfg, jcfg = cfgs("cp", 0)
    cases.append(("extents", "extents_case", dict(
        payload(cfg, jax_params(jcfg), "lp", (1, 1), 0, key),
        extents=EXTENTS)))
    cfg, jcfg = cfgs("corner", 0, stochastic_train=True, hw_rng=True)
    cases.append(("streams", "streams_case",
                  payload(cfg, jax_params(jcfg), "lp", (2, 2), 0, key)))
    cfg, jcfg = cfgs("cp", 0)
    cases.append(("dp_render", "dp_render_case", dict(
        cfg=cfg, params=jax_params(jcfg), bounds=(LO, HI), num_samples=S,
        rays=frame_rays())))
    cases.append(("multi", "multi_case",
                  payload(cfg, None, "dp", (2, 1), 0, key)))
    from torch_dist_worker import run_cases

    ranks = comm.spawn(run_cases, 4, (cases,), timeout=SPAWN_TIMEOUT)
    return jax_out, ranks


def rel_norm(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name", [c[0] for c in STEP_CASES])
def test_parallel_step_matches_jax(world4, name):
    """Loss, aux and every group's averaged gradient of one step against
    the JAX function's on the same layout (the sharded group's too: k times
    the single-device one under level parallelism, as JAX's transposes give
    it); every rank of the layout ends with the same parameters, and under
    level parallelism the parameters after the Adam update agree with
    JAX's as JAX's own extents test holds them."""
    jax_out, ranks = world4
    (jm, jg), shape = jax_out[name], dict(
        (c[0], c[3]) for c in STEP_CASES)[name]
    k = shape[1]
    mine = [r[name] for r in ranks[:shape[0] * shape[1]]]
    pm, pg = mine[0]["metrics"], mine[0]["grads"]
    assert np.isfinite(pm["loss"]) and pm["loss"] > 0
    assert pm["loss"] == pytest.approx(jm["loss"], rel=1e-5)
    assert pm["psnr"] == pytest.approx(jm["psnr"], abs=1e-4)
    if "cp_tv" in jm:
        assert pm["cp_tv"] == pytest.approx(jm["cp_tv"], rel=1e-5)
    assert set(pg) == set(jg)
    for g in jg:
        assert pg[g].shape == jg[g].shape, g
        assert rel_norm(pg[g], jg[g]) <= 1e-5, (g, rel_norm(pg[g], jg[g]))
    for other in mine[1:]:
        assert other["metrics"] == pm
        for a, b in zip(other["params"], mine[0]["params"]):
            np.testing.assert_array_equal(a, b)
    assert all(r[name] is None for r in ranks[shape[0] * shape[1]:])
    if k > 1:
        jm_adam, jparams = jax_out[name + "/adam"]
        assert jm_adam["loss"] == jm["loss"]
        diff = np.abs(np.concatenate([a.reshape(-1) for a in
                                      mine[0]["params"]])
                      - np.concatenate([a.reshape(-1) for a in jparams]))
        assert np.mean(diff < 1e-5) > 0.999 and diff.max() < 5e-3, \
            (np.mean(diff < 1e-5), diff.max())


@pytest.mark.parametrize("name", [c[0] for c in WINDOW_CASES])
def test_parallel_window_matches_jax(world4, name):
    """A window of 3 steps (``steps_per_call`` 3; on the CPU the eager
    loop) against JAX's ``make_*_train_step(steps_per_call=3)`` from the
    same params, every step given JAX's draws: the window's mean loss
    within 1e-5 relative and PSNR within 1e-4; the parameters after it
    within 1.4e-5 of each leaf's norm under data parallelism (as the
    single-device window's test), and as JAX's own extents test holds
    them under level parallelism (Adam turns the sign of a near-zero
    gradient of the sharded group, which JAX scales by k, into a step of
    the learning rate); every rank's parameters the same bit for bit."""
    jax_out, ranks = world4
    _, _, kind, shape, _, n = dict((c[0], c) for c in WINDOW_CASES)[name]
    jm, jparams = jax_out[name]
    mine = [r[name] for r in ranks[:shape[0] * shape[1]]]
    pm = mine[0]["metrics"]
    assert set(pm) == set(jm)
    assert mine[0]["counts"] == (n, n)
    assert np.isfinite(pm["loss"]) and pm["loss"] > 0
    assert pm["loss"] == pytest.approx(jm["loss"], rel=1e-5)
    assert pm["psnr"] == pytest.approx(jm["psnr"], abs=1e-4)
    for k in jm:
        assert pm[k] == pytest.approx(jm[k], rel=1e-5), k
    if kind == "dp":
        for a, b in zip(mine[0]["params"], jparams):
            assert np.linalg.norm(a - b) <= 1.4e-5 * np.linalg.norm(b)
    else:
        diff = np.abs(np.concatenate([a.reshape(-1) for a in
                                      mine[0]["params"]])
                      - np.concatenate([a.reshape(-1) for a in jparams]))
        assert np.mean(diff < 1e-5) > 0.999 and diff.max() < 5e-3, \
            (np.mean(diff < 1e-5), diff.max())
    for other in mine[1:]:
        assert other["metrics"] == pm
        for a, b in zip(other["params"], mine[0]["params"]):
            np.testing.assert_array_equal(a, b)
    assert all(r[name] is None for r in ranks[shape[0] * shape[1]:])


def test_tv_warmup_gates_the_rank_parallel_step(world4):
    """Before cp_tv_warmup the TV is reported but not in the loss; past it
    the loss carries cp_tv_weight * TV (psum'd over the level group)."""
    jax_out, ranks = world4
    gated, on = ranks[0]["lp_cp_tv_gated"]["metrics"], \
        ranks[0]["lp_cp_tv"]["metrics"]
    assert gated["cp_tv"] > 0
    assert gated["cp_tv"] == pytest.approx(on["cp_tv"], rel=1e-6)
    jg, jo = jax_out["lp_cp_tv_gated"][0], jax_out["lp_cp_tv"][0]
    assert on["loss"] - gated["loss"] == pytest.approx(
        jo["loss"] - jg["loss"], rel=1e-3)
    assert on["loss"] - gated["loss"] == pytest.approx(1e-2 * on["cp_tv"],
                                                      rel=1e-3)


@pytest.mark.parametrize("k", EXTENTS[1:])
def test_level_extents_take_the_same_steps(world4, k):
    """Extents 1, 2 and 4 of the rank-parallel CP step with the TV on take
    the same three steps: the same losses; the same first gradients but the
    lines', which at extent k are k times extent 1's, as JAX's own extents
    relate (the gather's and the TV psum's backwards sum the level group's
    replicated cotangents); lines that agree as JAX's own test holds them
    (Adam's scale invariance undoes the k, and turns the sign of a
    near-zero gradient into a step of the learning rate)."""
    one, got = world4[1][0]["extents"][1], world4[1][0]["extents"][k]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
    for g in one["grads"]:
        want = one["grads"][g] * (k if g in ("lines", "table") else 1)
        assert rel_norm(got["grads"][g], want) <= 1e-5, g
    diff = np.abs(np.concatenate([a.reshape(-1) for a in got["params"]])
                  - np.concatenate([a.reshape(-1) for a in one["params"]]))
    assert np.mean(diff < 1e-5) > 0.999 and diff.max() < 5e-3


def test_stochastic_level_ranks_draw_their_own_bits(world4):
    """On a (2, 2) layout: the level ranks of a data shard trace the same
    rays but draw different corner uniforms, (3, L / 2, N) each; the two
    data shards trace different rays."""
    recs = {r["streams"]["index"]: r["streams"] for r in world4[1]}
    for d in (0, 1):
        a, b = recs[(d, 0)], recs[(d, 1)]
        np.testing.assert_array_equal(a["rays_o"], b["rays_o"])
        assert a["u"].shape == (3, 2, (B // 2) * S)
        assert np.mean(a["u"] != b["u"]) > 0.99
    assert not np.array_equal(recs[(0, 0)]["rays_o"], recs[(1, 0)]["rays_o"])


def test_dp_render_is_the_single_device_render(world4):
    """``make_dp_render`` on a (2, 1) layout: each rank renders its half of
    the rays (bf16 MLP, as JAX's) and every rank gathers the frame the
    single-device chunked render gives."""
    cfg, jcfg = cfgs("cp", 0)
    field = ckpt.from_jax_params(jax_params(jcfg), cfg)
    o, d, n = (torch.as_tensor(a) for a in frame_rays())
    want = step.render_rays_chunked(field, nerf_scene(), o, d, n, cfg,
                                    num_samples=S, bf16=True).numpy()
    assert want.std() > 1e-3
    for r in world4[1][:2]:
        np.testing.assert_allclose(r["dp_render"], want, rtol=0, atol=1e-6)
    assert all(r["dp_render"] is None for r in world4[1][2:])


def test_multi_scene_over_a_mesh_is_the_one_device_step(world4):
    """Four scenes split over two ranks, each fitting its two: the metric
    mean over the mesh is the one-device multi-scene step's."""
    from human_body_reconstruction_tpu_torch.parallel import multi_scene as ms

    ranks = world4[1]
    assert [ranks[0]["multi"]["scenes"], ranks[1]["multi"]["scenes"]] == \
        [[0, 1], [2, 3]]
    cfg, _ = cfgs("cp", 0)
    fields = ms.init_multi_fields(cfg, 4, torch.Generator().manual_seed(0))
    state = ms.create_multi_state(fields, cfg, 10)
    images, c2ws, K = (torch.as_tensor(a) for a in dataset())
    m = ms.make_multi_train_step(cfg, B)(
        state, [nerf_scene()] * 4, [images] * 4, [c2ws] * 4, [K] * 4,
        [torch.Generator().manual_seed(100 + s) for s in range(4)])
    for r in ranks[:2]:
        assert r["multi"]["loss"] == pytest.approx(float(m["loss"]),
                                                    rel=1e-6)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """A world of 2 ranks: the fit loop at level extent 2 (its checkpoint
    in a temporary directory) and the dry run."""
    out_dir = str(tmp_path_factory.mktemp("lp_fit"))
    cfg, _ = cfgs("cp", 3)
    cfg = dataclasses.replace(
        cfg, render=dataclasses.replace(
            cfg.render, occupancy=True, occupancy_resolution=16,
            compact_samples=8, occ_guided=True, occ_probes=8,
            occ_explore=0.05, occ_dt="mass", occ_stratified=True),
        train=dataclasses.replace(cfg.train, occ_warmup_steps=2,
                                  update_rate=2))
    K = np.array([[12.0, 0, 5.0], [0, 12.0, 5.0], [0, 0, 1]], np.float32)
    c2w = synthetic.orbit_poses(4, radius=4.0)[1]
    cases = [("fit", "trainer_case", dict(cfg=cfg, level_parallel=2,
                                          out_dir=out_dir, steps=4, K=K,
                                          c2w=c2w)),
             ("dryrun", "dryrun_case", None)]
    from torch_dist_worker import run_cases

    ranks = comm.spawn(run_cases, 2, (cases,), timeout=SPAWN_TIMEOUT)
    return ranks, cfg, out_dir, K, c2w


def test_level_parallel_checkpoint_is_the_single_device_one(world2):
    """The fit loop at extent 2 installs and refreshes the grid (equal on
    both ranks), joins its rank shards into one checkpoint that the JAX
    restore and a single-device run read, where it renders the frame the
    level-parallel render gave; a second run loads it (sharded again) and
    continues."""
    ranks, cfg, out_dir, K, c2w = world2
    fit = ranks[0]["fit"]
    assert fit["grids_equal"] and ranks[1]["fit"]["grids_equal"]
    assert fit["loaded_step"] == 4 and fit["step_after"] == 5
    h = cfg.hash
    assert fit["local_shape"][-1] == h.cp_rank // 2
    assert [r["step"] for r in fit["history"]] == [2, 4]
    assert ranks[1]["fit"]["history"] == []
    pres = restore.restore(out_dir, "lp", device="cpu", with_occ=True,
                           log_fn=lambda s: None)
    assert pres.field.lines[0].shape[-1] == h.cp_rank
    jres = jrestore.restore(out_dir, "lp", with_occ=True,
                            log_fn=lambda s: None)
    for a, b in zip(jax.tree_util.tree_leaves(jres.params),
                    ckpt.jax_leaves(pres.field)):
        np.testing.assert_array_equal(np.asarray(a), b)
    img = step.render_image(pres.field, pres.scene, 10, 10, torch.tensor(K),
                            torch.tensor(c2w), pres.cfg, occ=pres.occ,
                            num_samples=16).numpy()
    assert img.std() > 1e-3
    np.testing.assert_allclose(fit["img"].reshape(10, 10, 3), img, rtol=0,
                               atol=1e-6)


def test_dryrun_runs_every_parallel_path(world2):
    """parallel/dryrun.py at world 2: the data-parallel step and a window
    of 2, the sample-split render in both modes, and level-parallel hash
    and CP steps and windows, each finite; the hash block ran on a pinned
    level count."""
    for r in world2[0]:
        out = r["dryrun"]
        assert set(out) == {"dp_loss", "dp_window_loss", "sp_density",
                            "sp_sdf", "lp_hash_loss", "lp_hash_window_loss",
                            "lp_cp_loss", "lp_cp_window_loss"}
        assert all(np.isfinite(v) for v in out.values())
    assert world2[0][0]["dryrun"] == world2[0][1]["dryrun"]


def test_dryrun_pins_a_level_count_or_raises():
    from human_body_reconstruction_tpu_torch.parallel import dryrun

    assert dryrun.pinned_levels(1) == 4 and dryrun.pinned_levels(3) == 6
    assert dryrun.pinned_levels(8) == 8
    with pytest.raises(ValueError, match="no level count"):
        dryrun.pinned_levels(32)


@pytest.mark.parametrize("argv,n_devices", [
    (["--level_parallel", "2"], 2),
    (["--stochastic", "--level_parallel", "3"], 3),
    (["--data_parallel", "--num_batch", "16001"], 4),
    (["--data_parallel", "--level_parallel", "2", "--cp_rank", "32",
      "--num_batch", "16001"], 4)])
def test_cli_refuses_layouts_with_the_jax_message(argv, n_devices):
    """A rank or level count the extent does not divide, or a batch the
    data extent does not divide, ends the CLI before any work with the
    message of JAX ``_validate`` on the same layout."""
    args = train_hash.build_parser().parse_args(argv)
    jargs = jcli.build_parser().parse_args(argv)
    n_level = max(args.level_parallel, 1)
    n_data = n_devices // n_level if args.data_parallel else 1
    with pytest.raises(ValueError) as want:
        jlp._validate(jcli.make_config(jargs),
                      jlp.make_lp_mesh(n_data, n_level), args.num_batch)
    with pytest.raises(SystemExit) as got:
        train_hash.check_supported(args, train_hash.make_config(args))
        train_hash.world_layout(args, n_devices)
    assert str(got.value) == str(want.value)


def test_cli_data_parallel_world_of_one(tmp_path):
    """``--data_parallel`` with one device runs the data-parallel step in a
    world of one (gloo on the CPU) in this process, and leaves it."""
    tr = train_hash.main([
        "--synthetic", "--steps", "3", "--num_batch", "32", "--max_res", "64",
        "--num_levels", "3", "--cp_rank", "2", "--num_samples", "8",
        "--compact", "4", "--occ_probes", "4", "--occ_warmup", "1",
        "--update_rate", "2", "--log_every", "1", "--device", "cpu",
        "--data_parallel", "--out_dir", str(tmp_path), "--model_name", "dp"])
    assert tr.mesh.shape == (1, 1) and tr._step_fn is not None
    assert tr.state.step == 3 and tr.state.occ is not None
    assert len(tr.history) == 3
    assert not torch.distributed.is_initialized()
    assert os.path.exists(tmp_path / "dp_ckpt.npz")


def test_cli_data_parallel_window_world_of_one(tmp_path):
    """``--data_parallel --steps_per_call 2`` over 5 steps in a world of
    one: two windows of the data-parallel step, then the remainder as a
    single step, a log after each, and the checkpoint."""
    tr = train_hash.main([
        "--synthetic", "--steps", "5", "--num_batch", "32", "--max_res", "64",
        "--num_levels", "3", "--cp_rank", "2", "--num_samples", "8",
        "--compact", "4", "--occ_probes", "4", "--occ_warmup", "1",
        "--update_rate", "2", "--log_every", "1", "--steps_per_call", "2",
        "--device", "cpu", "--data_parallel", "--out_dir", str(tmp_path),
        "--model_name", "dpw"])
    assert tr.mesh.shape == (1, 1) and tr._window_fn.steps_per_call == 2
    assert tr.state.step == 5 and int(tr.state.opt.count) == 5
    assert tr.state.occ is not None
    assert [r["step"] for r in tr.history] == [2, 4, 5]
    assert all(np.isfinite(r["loss"]) for r in tr.history)
    assert not torch.distributed.is_initialized()
    with np.load(tmp_path / "dpw_ckpt.npz") as data:
        assert int(data["extra_step"]) == 5


# steps_per_call 3 over 7 steps (windows 3, 3, then a single step), the
# grid's warmup 2, a refresh every 4, a log every step, an eval every 5
PW_EVENTS = dict(steps=7, spc=3, warmup=2, update_rate=4, log=1, every=5)


def window_event_cfgs():
    out = []
    for c in cfgs("cp", 0):
        out.append(dataclasses.replace(
            c, render=dataclasses.replace(c.render, occupancy=True,
                                          occupancy_resolution=8),
            train=dataclasses.replace(
                c.train, occ_warmup_steps=PW_EVENTS["warmup"],
                update_rate=PW_EVENTS["update_rate"])))
    return out


def jax_parallel_window_events(tmp_path, jcfg):
    """The JAX trainer's events under ``data_parallel`` (a mesh of the
    host's 8 CPU devices) with its parallel step functions stubbed: each
    call advances the count."""
    images, c2ws, K = dataset()
    ds = {"images": jnp.asarray(images), "c2ws": jnp.asarray(c2ws),
          "K": jnp.asarray(K), "H": 8, "W": 8}
    tr = jtrainer.Trainer(cfg=jcfg, ds=ds, out_dir=str(tmp_path),
                          log_fn=lambda s: None, write_metrics=False,
                          total_steps=PW_EVENTS["steps"],
                          data_parallel=True,
                          steps_per_call=PW_EVENTS["spc"])
    assert tr.mesh is not None and tr._dp_step1 is not None
    ev = {"install": [], "refresh": [], "calls": [], "eval": []}
    zero = {"loss": jnp.float32(0.0), "psnr": jnp.float32(0.0)}

    def stub(kind, n):
        def fn(state, *a):
            ev["calls"].append((kind, n))
            return state._replace(step=state.step + n), zero
        return fn

    tr._dp_step = stub("window", PW_EVENTS["spc"])
    tr._dp_step1 = stub("single", 1)
    install = tr._install_occ
    tr._install_occ = lambda s: (ev["install"].append(s), install(s))
    tr.update_occupancy = lambda s=None: (
        tr.state.occ is not None and ev["refresh"].append(s))
    tr.eval_render = lambda *a, tag="", **k: ev["eval"].append(int(tag))
    tr.save = lambda: None
    tr.run(PW_EVENTS["steps"], log_every=PW_EVENTS["log"],
           eval_every=PW_EVENTS["every"])
    ev["log"] = [r["step"] for r in tr.history]
    return ev


def test_parallel_window_events_match_jax(tmp_path):
    """Under ``data_parallel`` with ``steps_per_call`` 3 over 7 steps (a
    world of one over gloo, in this process): the port's fit loop calls the
    window twice and then the single step once, installs the grid,
    refreshes it, logs and evaluates at the steps the JAX trainer does on
    its mesh; the metrics logged after the remainder are the single step's;
    the window ran its steps."""
    from human_body_reconstruction_tpu_torch.train import trainer as tlib

    cfg, jcfg = window_event_cfgs()
    images, c2ws, K = dataset()
    ds = {"images": torch.as_tensor(images), "c2ws": torch.as_tensor(c2ws),
          "K": torch.as_tensor(K), "H": 8, "W": 8}
    want = jax_parallel_window_events(tmp_path / "j", jcfg)
    rdzv = tmp_path / "rdzv"
    rdzv.mkdir()
    comm.init("cpu", rank=0, world_size=1,
              init_method=f"file://{rdzv / 'rendezvous'}")
    try:
        tr = tlib.Trainer(cfg=cfg, ds=ds, out_dir=str(tmp_path / "p"),
                          log_fn=lambda s: None,
                          total_steps=PW_EVENTS["steps"], data_parallel=True,
                          steps_per_call=PW_EVENTS["spc"])
        ev = {"install": [], "refresh": [], "calls": [], "eval": []}
        last = {}

        def spy(kind, fn):
            def call(state, *a):
                ev["calls"].append((kind, state.step))
                out = fn(state, *a)
                ev["calls"][-1] = (kind, state.step - ev["calls"][-1][1])
                last.update(out)
                return out
            return call

        tr._window_fn = spy("window", tr._window_fn)
        tr._step_fn = spy("single", tr._step_fn)
        install, refresh = tr._install_occ, tr.update_occupancy
        tr._install_occ = lambda s: (ev["install"].append(s), install(s))
        tr.update_occupancy = lambda: (
            tr.state.occ is not None and ev["refresh"].append(tr.state.step),
            refresh())
        tr.eval_render = lambda tag="": ev["eval"].append(int(tag))
        tr.run(PW_EVENTS["steps"], log_every=PW_EVENTS["log"],
               eval_every=PW_EVENTS["every"])
    finally:
        torch.distributed.destroy_process_group()
    ev["log"] = [r["step"] for r in tr.history]
    assert want["calls"] == [("window", 3), ("window", 3), ("single", 1)]
    assert want["install"] == [3]       # the first boundary past 2
    assert ev == want
    assert tr.state.step == PW_EVENTS["steps"] and tr.state.occ is not None
    assert tr.history[-1]["loss"] == float(last["loss"])
    assert all(np.isfinite(r["loss"]) for r in tr.history)


def test_cli_under_torchrun_level_parallel(tmp_path):
    """``torchrun --nproc_per_node 2 -m ...train_hash --level_parallel 2
    --steps_per_call 2`` over 3 steps (gloo on the CPU): the ranks join
    torchrun's world from its environment, split the hash grid's levels,
    take a window of 2 steps and then a single step, and rank 0 alone logs
    and writes the checkpoint."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         "human_body_reconstruction_tpu_torch.cli.train_hash", "--synthetic",
         "--stochastic", "--hw_rng", "--num_levels", "4", "--hash_size", "10",
         "--max_res", "64", "--num_batch", "64", "--num_samples", "8",
         "--steps", "3", "--steps_per_call", "2", "--log_every", "1",
         "--device", "cpu", "--level_parallel", "2", "--out_dir",
         str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=repo)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("level-parallel over 2 ranks") == 1
    assert proc.stdout.count("step       2") == 1
    assert proc.stdout.count("step       3") == 1
    with np.load(tmp_path / "default_ckpt.npz") as data:
        assert int(data["extra_step"]) == 3
        shapes = [data[k].shape for k in data.files if k.startswith("leaf")]
    # the table and its two moments, joined: 4 levels, not a rank's 2
    assert shapes.count((4, 1024, 2)) == 3 and (2, 1024, 2) not in shapes


def test_shard_and_gather_round_trip_the_state():
    """Cutting a whole state into level shards and joining them again
    gives back every parameter and Adam moment (a world of one holding
    both shards' slices is not possible, so the cut is checked slice by
    slice against the whole)."""
    cfg, _ = cfgs("corner", 0)
    from human_body_reconstruction_tpu_torch.models.nerf import Field

    field = Field(cfg, generator=torch.Generator().manual_seed(0))
    for i in range(2):
        mesh = comm.Mesh((1, 2), "level", 0, i, None, None)
        local = lp.shard_field(field, cfg, mesh)
        lo, hi = 2 * i, 2 * i + 2
        assert torch.equal(local.table, field.table[lo:hi])
        np.testing.assert_array_equal(local.lp.scales,
                                      C.fine_scales(cfg.hash)[lo:hi])
        assert local.lp.extent == 2
    assert field.lp is None


@pytest.mark.parametrize("variant,k", [("corner", 2), ("corner", 4),
                                       ("cp", 2), ("cp", 4)])
def test_level_blocks_joined_equal_the_whole_encode(variant, k):
    """Each level rank's encode of its slice (``encode_params`` with a
    shard that has no gather: the rank's own columns), joined by
    ``join_level_blocks`` as the group's gather joins them, equals the
    single-device encode, and the gradient through the join hands each rank
    its slice of the single-device gradient (the smoke's serial drive on
    the card)."""
    from human_body_reconstruction_tpu_torch.models.nerf import Field
    from human_body_reconstruction_tpu_torch.ops import hash_encoding as he

    cfg, _ = cfgs(variant)
    h = cfg.hash
    field = Field(cfg, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((257, 3), generator=gen) * 3.0 - 1.5
    mu, sigma = torch.zeros(3), torch.ones(3) * 3.0
    g = torch.randn((257, h.out_dim), generator=gen)
    dense = [t.detach() for t in field.dense]
    cp = variant == "cp"
    whole = [t.detach().clone().requires_grad_()
             for t in (field.lines if cp else [field.table])]
    ref = he.encode_params({"dense": dense, ("lines" if cp else "table"):
                            whole if cp else whole[0]}, x, mu, sigma, h)
    ref_g = torch.autograd.grad(ref, whole, g)
    per = (h.cp_rank if cp else h.num_hashed_levels) // k
    scales = C.fine_scales(h)
    h_lp = dataclasses.replace(h, level_axis="level")
    outs, parts = [], []
    for i in range(k):
        cut = slice(i * per, (i + 1) * per)
        if cp:
            part = [t[..., cut].detach().clone().requires_grad_()
                    for t in whole]
            enc, shard = {"dense": dense, "lines": part}, he.LevelShard(k)
        else:
            part = [whole[0][cut].detach().clone().requires_grad_()]
            enc = {"dense": dense, "table": part[0]}
            shard = he.LevelShard(k, scales[cut])
        outs.append(he.encode_params(enc, x, mu, sigma, h_lp, shard=shard))
        parts.append(part)
    d = len(dense) * h.features_per_level
    joined = he.join_level_blocks(outs[0][:, :d],
                                  torch.cat([o[:, d:] for o in outs], 1),
                                  len(whole) if cp else 0, k)
    assert torch.equal(joined, ref)
    grads = torch.autograd.grad(joined, [p for part in parts for p in part],
                                g)
    for j, want in enumerate(ref_g):
        got = (torch.cat([grads[i * len(whole) + j] for i in range(k)], -1)
               if cp else torch.cat(grads, 0))
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
