"""PyTorch port vs the JAX package: the sample-split render and
multi-scene fitting.

``make_sp_render`` runs on (1, 4) and (2, 2) layouts on both sides: JAX on
meshes of the host's 8 CPU devices (tests/conftest.py), the port in one
spawned world of 4 gloo processes (tests/torch_dist_worker.py, no JAX),
density mode with occupancy and a white background and SDF mode with
occupancy, from JAX's params: within 1e-5, the f32 sums of the two packages
in other orders.  ``render_segments`` (the same segments one after another
on one device, then ``combine_segments``) is held to the port's one-pass
render of the same rays at n = 2, 4 and 8 segments, and the multi-scene step
(S = 2, one device) to JAX's ``make_multi_train_step`` given the draws the
JAX step derives from each scene's key, in f32 (loss rtol 1e-5, each
group's gradient within 1e-5 of its norm), and to two single-scene steps.
Test names avoid the words that tests/conftest.py marks slow.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from human_body_reconstruction_tpu.ops import occupancy as jocc
from human_body_reconstruction_tpu.parallel import multi_scene as jms
from human_body_reconstruction_tpu.parallel import sample_parallel as jsp
from human_body_reconstruction_tpu.pipeline import restore as jrestore
from human_body_reconstruction_tpu.utils import config as jC
from human_body_reconstruction_tpu_torch.data import synthetic
from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.ops import occupancy, rays
from human_body_reconstruction_tpu_torch.parallel import comm
from human_body_reconstruction_tpu_torch.parallel import multi_scene as ms
from human_body_reconstruction_tpu_torch.parallel import sample_parallel as sp
from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
from human_body_reconstruction_tpu_torch.train import state as state_lib
from human_body_reconstruction_tpu_torch.train import step
from human_body_reconstruction_tpu_torch.utils import config as C
from torch_threads import one_torch_thread  # noqa: F401

LO = np.array([-1.5, -1.5, -1.5], np.float32)
HI = np.array([1.5, 1.5, 1.5], np.float32)
S = 32                  # the render's samples


def cfgs(mode: str):
    """(port config, JAX config): a corner hash grid of 4 levels, MLP width
    16, 32 samples; "density" with occupancy and a white background, "sdf"
    with occupancy."""
    out = []
    for mod in (C, jC):
        r = mod.RenderConfig(num_samples=S, occupancy=True,
                             occupancy_resolution=16,
                             white_background=mode == "density",
                             use_sdf=mode == "sdf")
        out.append(mod.PipelineConfig(
            hash=mod.HashConfig(num_levels=4, log2_table_size=12, n_min=4,
                                n_max=64, init_scale=0.5),
            mlp=mod.MLPConfig(width=16, density_activation=(
                "sdf" if mode == "sdf" else "leaky_relu")),
            render=r))
    return out


def jax_params(jcfg):
    from human_body_reconstruction_tpu.train import trainer as jtrainer

    params = jax.tree.map(np.array, jtrainer.init_params(
        jax.random.PRNGKey(0), jcfg))
    params["mlp"]["sig"][-1]["b"][0] += 1.0
    if "var" in params:
        params["var"]["b"] = np.asarray(4.0, np.float32)  # a sharper surface
    return params


def ball_occ(g=16):
    c = (np.arange(g) + 0.5) / g * np.sqrt(3.0) * 3.0 - 1.5
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    mask = ((xx ** 2 + yy ** 2 + zz ** 2) < 1.0).astype(np.float32)
    return mask, mask, np.float32(0.01)


def frame_rays(n_side=8):
    K = np.array([[10.0, 0, n_side / 2], [0, 10.0, n_side / 2], [0, 0, 1]],
                 np.float32)
    c2w = synthetic.orbit_poses(4, radius=4.0, elevation=0.35)[1]
    o, d, n = rays.full_image_rays(n_side, n_side, torch.tensor(K),
                                   torch.tensor(c2w))
    return o.reshape(-1, 3).numpy(), d.reshape(-1, 3).numpy(), \
        n.reshape(-1, 1).numpy()


SP_CASES = [(mode, shape) for mode in ("density", "sdf")
            for shape in ((1, 4), (2, 2))]


@pytest.fixture(scope="module")
def sp_world4():
    """JAX's sample-split renders, and the port's in one world of 4."""
    jax_out, cases = {}, []
    o, d, n = frame_rays()
    for mode, shape in SP_CASES:
        cfg, jcfg = cfgs(mode)
        params = jax_params(jcfg)
        render = jsp.make_sp_render(jcfg, jsp.make_sp_mesh(*shape,
                                    jax.devices()[:4]), num_samples=S,
                                    compute_dtype=None)
        occ = ball_occ()
        jax_out[(mode, shape)] = np.asarray(render(
            jax.tree.map(jnp.asarray, params),
            jrestore.scene_from_bounds(LO, HI), jnp.asarray(o),
            jnp.asarray(d), jnp.asarray(n[:, 0]),
            occ=jocc.OccupancyGrid(*(jnp.asarray(a) for a in occ))))
        cases.append(((mode, shape), "sp_case", dict(
            cfg=cfg, params=params, shape=shape, num_samples=S,
            bounds=(LO, HI), rays=(o, d, n), occ=occ)))
    from torch_dist_worker import run_cases

    return jax_out, comm.spawn(run_cases, 4, (cases,), timeout=600)


@pytest.mark.parametrize("mode,shape", SP_CASES)
def test_sp_render_matches_jax(sp_world4, mode, shape):
    jax_out, ranks = sp_world4
    want = jax_out[(mode, shape)]
    assert want.std() > 1e-3
    for r in ranks:                     # every rank gathers the whole frame
        np.testing.assert_allclose(r[(mode, shape)], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("mode", ["density", "sdf"])
def test_segments_combine_to_the_one_pass_render(mode, n):
    """The segments rendered one after another and combined give the
    one-pass render of the same rays and ladder (occupancy on; white
    background in density mode): within 1e-5."""
    cfg, jcfg = cfgs(mode)
    field = ckpt.from_jax_params(jax_params(jcfg), cfg)
    scene = nerf.scene_from_bounds(LO, HI)
    occ = occupancy.OccupancyGrid(*(torch.as_tensor(a) for a in ball_occ()))
    o, d, dn = (torch.as_tensor(a) for a in frame_rays())
    with torch.no_grad():
        want = nerf.render_rays(field, scene, o, d, dn, cfg, num_samples=S,
                                occ=occ)["fine"]
    got = sp.render_segments(field, scene, o, d, dn, cfg, S, n, occ=occ)
    assert float(want.std()) > 1e-3
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_combine_segments_is_the_prefix_algebra():
    """combine_segments on hand-made partials: transmittance exp(-prefix
    optical depth) weighting in density mode (plus the white background),
    the strict-prefix product in SDF mode."""
    cfg, _ = cfgs("density")
    tau = torch.tensor([[0.5], [1.0], [2.0]])
    color = torch.tensor([[[0.2, 0.0, 0.0]], [[0.0, 0.3, 0.0]],
                          [[0.0, 0.0, 0.4]]])
    acc = torch.tensor([[0.3], [0.5], [0.7]])
    t_pre = torch.exp(-torch.tensor([0.0, 0.5, 1.5]))
    want = (t_pre[:, None] * color[:, 0]).sum(0) + (
        1.0 - (t_pre * acc[:, 0]).sum())
    got = sp.combine_segments({"tau": tau, "color": color, "acc": acc}, cfg)
    torch.testing.assert_close(got[0], want)
    cfg, _ = cfgs("sdf")
    prod = torch.tensor([[0.5], [0.25], [0.9]])
    got = sp.combine_segments({"prod": prod, "color": color}, cfg)
    want = (torch.tensor([1.0, 0.5, 0.125])[:, None] * color[:, 0]).sum(0)
    torch.testing.assert_close(got[0], want)


def test_sp_render_refuses_a_split_the_samples_do_not_divide():
    cfg, _ = cfgs("density")
    mesh = comm.Mesh((1, 3), "sample", 0, 0, None, None)
    with pytest.raises(ValueError, match="not divisible"):
        sp.make_sp_render(cfg, mesh, num_samples=32)


# -- multi-scene -------------------------------------------------------------

SCENES, BATCH, MS_SAMPLES = 2, 64, 16


def ms_cfgs():
    return [mod.PipelineConfig(
        hash=mod.HashConfig(num_levels=4, log2_table_size=10, n_min=4,
                            n_max=64, init_scale=0.5),
        mlp=mod.MLPConfig(width=16),
        render=mod.RenderConfig(num_samples=MS_SAMPLES),
        train=mod.TrainConfig(ray_batch=BATCH, compute_dtype="float32"))
        for mod in (C, jC)]


def ms_data():
    """Per scene: images (3, 8, 8, 3), poses and K, from numpy."""
    rng = np.random.default_rng(1)
    images = rng.uniform(size=(SCENES, 3, 8, 8, 3)).astype(np.float32)
    c2ws = np.stack([synthetic.orbit_poses(3, radius=4.0, elevation=e)
                     for e in (0.35, 0.1)])
    K = np.array([[10.0, 0, 4.0], [0, 10.0, 4.0], [0, 0, 1]], np.float32)
    return images, c2ws, np.stack([K] * SCENES)


def ms_draws(keys, step_no, images):
    """Each scene's draws as the JAX step makes them from its key."""
    n, h, w = images.shape[1:4]
    out = []
    for s in range(SCENES):
        k_batch, k_render = jax.random.split(
            jax.random.fold_in(keys[s], step_no))
        k1, k2 = jax.random.split(k_batch)
        out.append((
            torch.tensor(np.asarray(jax.random.randint(k1, (BATCH,), 0, n))),
            torch.tensor(np.asarray(jax.random.randint(k2, (BATCH,), 0,
                                                       h * w))),
            {"u": torch.tensor(np.asarray(jax.random.uniform(
                jax.random.split(k_render, 4)[0], (BATCH, MS_SAMPLES))))}))
    return out


def recording_tx():
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


def field_grads(field):
    """{group: flat gradient}, the MLP in the JAX (sig, col; w, b) order."""
    return {"table": field.table.grad.numpy().reshape(-1),
            "mlp": np.concatenate([p.grad.numpy().reshape(-1)
                                   for p in field.mlp.parameters()])}


def jax_scene_grads(grads, s):
    return {"table": np.asarray(grads["table"][s]).reshape(-1),
            "mlp": np.concatenate(
                [np.asarray(g).reshape(-1) for branch in ("sig", "col")
                 for layer in grads["mlp"][branch]
                 for g in (np.asarray(layer["w"][s]).T, layer["b"][s])])}


@pytest.fixture(scope="module")
def multi():
    """JAX's multi-scene step (S = 2, recording its gradients) and the
    port's, from JAX's stacked params and its draws."""
    cfg, jcfg = ms_cfgs()
    images, c2ws, Ks = ms_data()
    params = jax.tree.map(np.array, jms.init_multi_params(
        jax.random.PRNGKey(0), jcfg, SCENES))
    scenes = [jrestore.scene_from_bounds(LO * (1 + 0.1 * s), HI)
              for s in range(SCENES)]
    jscenes = jax.tree.map(lambda *x: jnp.stack(x), *scenes)
    tx = recording_tx()
    jp = jax.tree.map(jnp.asarray, params)
    from human_body_reconstruction_tpu.train.state import TrainState

    state = TrainState(step=jnp.asarray(0, jnp.int32), params=jp,
                       opt_state=tx.init(jp), occ=None)
    keys = jax.random.split(jax.random.PRNGKey(1), SCENES)
    jstate, jm = jms.make_multi_train_step(jcfg, tx, BATCH)(
        state, jscenes, jnp.asarray(images), jnp.asarray(c2ws),
        jnp.asarray(Ks), keys)

    fields = [ckpt.from_jax_params(jax.tree.map(lambda x: x[s], params), cfg)
              for s in range(SCENES)]
    pstate = ms.create_multi_state(fields, cfg, 10)
    pscenes = [nerf.scene_from_bounds(LO * (1 + 0.1 * s), HI)
               for s in range(SCENES)]
    draws = ms_draws(keys, 0, images)
    tensors = [[torch.as_tensor(a[s]) for s in range(SCENES)]
               for a in (images, c2ws, Ks)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # one sum order for every step below
    pm = ms.make_multi_train_step(cfg, BATCH)(
        pstate, pscenes, *tensors, [None] * SCENES,
        batch_idx=[(img, pix) for img, pix, _ in draws],
        draws=[dr for _, _, dr in draws])
    singles = []                    # each scene's own single-scene step
    for s in range(SCENES):
        field = ckpt.from_jax_params(jax.tree.map(lambda x: x[s], params),
                                     cfg)
        st = state_lib.create_train_state(field, cfg.train, 10)
        batch = step.sample_ray_batch(*(t[s] for t in tensors), BATCH,
                                      img_idx=draws[s][0],
                                      pix_idx=draws[s][1])
        st.opt.zero_grad()
        loss, _ = step.loss_fn(field, pscenes[s], batch, cfg, step=0,
                               draws=draws[s][2])
        loss.backward()
        grads = field_grads(field)
        st.opt.step(0)
        singles.append((float(loss.detach()), grads,
                        ckpt.jax_leaves(field)))
    torch.set_num_threads(threads)
    return (jm, jstate.opt_state), (pm, pstate), (cfg, params, pscenes,
                                                  tensors, draws, singles)


def test_multi_scene_step_matches_jax(multi):
    (jm, jgrads), (pm, pstate), _ = multi
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(pm["psnr"]) == pytest.approx(float(jm["psnr"]), abs=1e-4)
    for s, field in enumerate(pstate.fields):
        got, want = field_grads(field), jax_scene_grads(jgrads, s)
        for g in want:
            err = float(np.linalg.norm(got[g] - want[g])
                        / np.linalg.norm(want[g]))
            assert err <= 1e-5, (s, g, err)
    assert pstate.step == 1


def test_multi_scene_equals_single_scene_steps(multi):
    """Each scene of the multi-scene step takes the step a single-scene
    train state of its own takes on the same draws: the same gradients, bit
    for bit, and the same update within a few f32 ulps (the optimizer is
    per element, but torch's vectorised loops round an element by where it
    falls in the tensors an update is handed: measured up to 2.7e-7 on
    values near 0.1)."""
    _, (pm, pstate), (_, _, _, _, _, singles) = multi
    for s, (loss, grads, leaves) in enumerate(singles):
        for g, want in grads.items():
            np.testing.assert_array_equal(field_grads(pstate.fields[s])[g],
                                          want)
        for a, b in zip(ckpt.jax_leaves(pstate.fields[s]), leaves):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert float(pm["loss"]) == pytest.approx(
        np.mean([loss for loss, _, _ in singles]), rel=1e-6)


def test_multi_scene_grids_refresh_per_scene():
    """Per-scene grids: one culling round each against its own field."""
    cfg, _ = ms_cfgs()
    gen = torch.Generator().manual_seed(0)
    fields = ms.init_multi_fields(cfg, SCENES, gen)
    with torch.no_grad():                       # a full and an empty scene
        fields[0].mlp.sig[-1].bias[0] += 50.0
        fields[1].mlp.sig[-1].bias[0] -= 50.0
    occs = ms.init_multi_occ(SCENES, 8, 0.01)
    scenes = [nerf.scene_from_bounds(LO, HI)] * SCENES
    new = ms.update_multi_occ(occs, fields, scenes, cfg,
                              [torch.Generator().manual_seed(s)
                               for s in range(SCENES)], num_cells=8 * 8 ** 3)
    fracs = [float(occupancy.occupied_fraction(g)) for g in new]
    # never-visited cells stay occupied: e^-8 of them on average
    assert fracs[0] == 1.0 and fracs[1] < 0.01
    assert ms.local_scenes(4, comm.Mesh((2, 1), "data", 1, 0, None,
                                        None)) == range(2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        ms.local_scenes(3, comm.Mesh((2, 1), "data", 0, 0, None, None))
