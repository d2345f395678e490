"""PyTorch port vs the JAX package: the rest of the trainer and CLI surface.

The onecycle schedule and three grouped optimizer updates on it against
optax; ``grad_norms`` and the ``--plot_grads`` record (the probe's batch
and draws handed to both sides) against JAX's; ``ClassicNeRF`` and
``MLP2D`` (forward and parameter gradients) from the JAX init, which the
port draws bit for bit (``utils/jax_prng.py``); one vanilla step from the
same pixels, image and sample positions; ``sphere_field``; the pytree
checkpoint both ways; and the CLIs on the CPU: ``train_vanilla``'s
checkpoint rendered by JAX, ``plot_psnr``'s curve, ``train_hash
--plot_grads --display``.  Tolerances: fp32 values 1e-5 (atol or rel),
gradients by relative norm 1e-4.  Test names avoid the words that
tests/conftest.py marks slow.
"""

import builtins
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from human_body_reconstruction_tpu.cli import plot_psnr as jplot_psnr
from human_body_reconstruction_tpu.data import synthetic as jsyn
from human_body_reconstruction_tpu.models import mlp as jmlp
from human_body_reconstruction_tpu.ops import compositing as jcomp
from human_body_reconstruction_tpu.ops import positional as jpos
from human_body_reconstruction_tpu.ops import rays as jrays
from human_body_reconstruction_tpu.ops import sampling as jsampling
from human_body_reconstruction_tpu.pipeline import restore as jrestore
from human_body_reconstruction_tpu.train import checkpoint as jckpt
from human_body_reconstruction_tpu.train import state as jstate
from human_body_reconstruction_tpu.train import step as jstep
from human_body_reconstruction_tpu.utils import config as jC
from human_body_reconstruction_tpu.utils import observability as jobs
from human_body_reconstruction_tpu_torch.cli import (
    plot_psnr, train_hash, train_vanilla)
from human_body_reconstruction_tpu_torch.data import png, synthetic
from human_body_reconstruction_tpu_torch.models import mlp
from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
from human_body_reconstruction_tpu_torch.train import state, step
from human_body_reconstruction_tpu_torch.train import trainer as trainer_lib
from human_body_reconstruction_tpu_torch.utils import config as C
from human_body_reconstruction_tpu_torch.utils import jax_prng
from human_body_reconstruction_tpu_torch.utils import observability as obs
from test_torch_train import (B, HI, LO, dataset, jax_batch, jax_params,
                              small_cfg)
from torch_threads import one_torch_thread  # noqa: F401

SMALL_NERF = dict(d_input=12, n_layers=4, d_filter=32, skip=(2,))


def rel_norm(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("horizon", [1, 7, 1000])
def test_onecycle_matches_optax_schedule(horizon):
    """Every step's rate, and flat past the horizon; optax's schedule is NaN
    at every step of a horizon whose warm-up leg is empty, which the port
    refuses."""
    ref = optax.cosine_onecycle_schedule(transition_steps=horizon,
                                         peak_value=0.05)
    steps = sorted({0, 1, 2, horizon // 3, horizon // 2, horizon - 1,
                    horizon, horizon + 5})
    if horizon < 4:
        assert all(np.isnan(float(ref(jnp.int32(s)))) for s in steps)
        with pytest.raises(ValueError, match="NaN"):
            state.onecycle(0.05, horizon)
        return
    port = state.onecycle(0.05, horizon)
    for s in steps:
        assert port(s) == pytest.approx(float(ref(jnp.int32(s))), rel=1e-5,
                                        abs=1e-9), s


def test_optimizer_onecycle_matches_optax_three_updates():
    """The same numpy gradients through optax's grouped transform and the
    port's optimizer with ``schedule="onecycle"`` (horizon 7): params atol
    1e-6 after each of three updates."""
    cfg = small_cfg(False)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, schedule="onecycle"))
    params = jax.tree.map(jnp.asarray, jax_params(cfg))
    field = ckpt.from_jax_params(jax_params(cfg), cfg)
    tx = jstate.make_optimizer(cfg.train, 7, params)
    opt_state = tx.init(params)
    opt = state.make_optimizer(cfg.train, 7, field)
    slots = ckpt._slots(field)
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    update = jax.jit(tx.update)
    for k in range(3):
        grads = [rng.normal(size=np.shape(x)).astype(np.float32)
                 for x in leaves]
        updates, opt_state = update(
            jax.tree_util.tree_unflatten(treedef, [jnp.asarray(g)
                                                   for g in grads]),
            opt_state, params)
        params = optax.apply_updates(params, updates)
        for (p, tr), g in zip(slots, grads):
            g = torch.tensor(g)
            p.grad = g.t().contiguous() if tr else g
        opt.step(k)
        opt.zero_grad()
        for a, b in zip(ckpt.jax_leaves(field),
                        jax.tree_util.tree_leaves(params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("variant", ["cp_dense", "corner_sdf"])
def test_grad_norms_match_jax(variant):
    """The port's groups are the JAX params dict's keys, and their norms
    equal ``grad_norms`` of the same gradients."""
    if variant == "cp_dense":
        cfg = small_cfg(False)
    else:
        cfg = C.PipelineConfig(
            hash=C.HashConfig(num_levels=3, log2_table_size=8, n_max=64),
            mlp=C.MLPConfig(width=16, density_activation="sdf"),
            render=C.RenderConfig(use_sdf=True))
    field = nerf.Field(cfg, generator=torch.Generator().manual_seed(0))
    groups = obs.param_groups(field)
    rng = np.random.default_rng(1)
    grads = {k: [rng.normal(size=tuple(p.shape)).astype(np.float32)
                 for p in ps] for k, ps in groups.items()}
    port = obs.grad_norms({k: [torch.tensor(g) for g in gs]
                           for k, gs in grads.items()})
    ref = jobs.grad_norms({k: [jnp.asarray(g) for g in gs]
                           for k, gs in grads.items()})
    jkeys = set(jax_params(cfg)) if variant == "cp_dense" else {
        "table", "mlp", "var"}
    assert set(groups) == jkeys and set(port) == set(ref)
    for k in ref:
        assert float(port[k]) == pytest.approx(float(ref[k]), rel=1e-6)


def test_plot_grads_record_matches_jax():
    """The ``--plot_grads`` norms of one state: the gradient of the loss on
    a probe batch (JAX ``_probe_loss``: f32, no step) through ``grad_norms``,
    the batch and the ladder's jitter handed to the port."""
    cfg = small_cfg(False)
    params = jax_params(cfg)
    field = ckpt.from_jax_params(params, cfg)
    images, c2ws, K = dataset()
    batch, img, pix = jax_batch(jax.random.PRNGKey(2), images, c2ws, K)
    key = jax.random.PRNGKey(3)
    draws = {"u": torch.tensor(np.asarray(jax.random.uniform(
        jax.random.split(key, 4)[0], (B, cfg.render.num_samples))))}

    def probe(p):
        return jstep.loss_fn(p, jrestore.scene_from_bounds(LO, HI), batch,
                             key, cfg, None, None)[0]

    ref = jobs.grad_norms(jax.jit(jax.grad(probe))(
        jax.tree.map(jnp.asarray, params)))
    tbatch = step.sample_ray_batch(torch.tensor(images), torch.tensor(c2ws),
                                   torch.tensor(K), B, img_idx=img,
                                   pix_idx=pix)
    port = trainer_lib.probe_grad_norms(
        field, nerf.scene_from_bounds(LO, HI), None, cfg, None,
        torch.Generator().manual_seed(0), batch=tbatch, draws=draws)
    assert set(port) == set(ref) == {"grad_norm/dense", "grad_norm/lines",
                                     "grad_norm/mlp"}
    for k in ref:
        assert float(port[k]) == pytest.approx(float(ref[k]), rel=1e-4), k
    assert all(p.grad is None for p in field.parameters())


def test_jax_prng_matches_jax_random():
    for seed in (0, 5, 2 ** 31 + 7):
        key = jax.random.PRNGKey(seed)
        kp = jax_prng.prng_key(seed)
        np.testing.assert_array_equal(np.asarray(key), kp)
        np.testing.assert_array_equal(np.asarray(jax.random.split(key, 5)),
                                      jax_prng.split(kp, 5))
        for shape, lo, hi in (((7,), 0.0, 1.0), ((3, 50, 2), -1e-4, 1e-4),
                              ((40, 9), -0.125, 0.125)):
            np.testing.assert_array_equal(
                np.asarray(jax.random.uniform(key, shape, minval=lo,
                                              maxval=hi)),
                jax_prng.uniform(kp, shape, lo, hi))


def _classic_cfgs(views: bool):
    kw = dict(SMALL_NERF, d_viewdirs=12 if views else None)
    return C.ClassicNeRFConfig(**kw), jC.ClassicNeRFConfig(**kw)


@pytest.mark.parametrize("views", [True, False], ids=["views", "no_views"])
def test_classic_nerf_matches_jax(views):
    """The init tree equal to JAX's bit for bit; forward (rgb, alpha) and
    every parameter's gradient from seeded cotangents."""
    cfg, jcfg = _classic_cfgs(views)
    tree = mlp.init_classic_nerf(jax_prng.prng_key(4), cfg)
    jtree = jmlp.init_classic_nerf(jax.random.PRNGKey(4), jcfg)
    for a, b in zip(ckpt.tree_leaves(tree), jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(a, np.asarray(b))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 12)).astype(np.float32)
    v = rng.normal(size=(300, 12)).astype(np.float32) if views else None
    g_rgb = rng.normal(size=(300, 3)).astype(np.float32)
    g_alpha = rng.normal(size=(300,)).astype(np.float32)
    (rgb_j, alpha_j), vjp = jax.vjp(
        lambda p: jmlp.apply_classic_nerf(p, jnp.asarray(x), jcfg,
                                          None if v is None
                                          else jnp.asarray(v)), jtree)
    (grads_j,) = vjp((jnp.asarray(g_rgb), jnp.asarray(g_alpha)))
    model = mlp.classic_nerf_from_jax(tree, cfg)
    rgb, alpha = model(torch.tensor(x),
                       viewdirs=None if v is None else torch.tensor(v))
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_j),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(alpha_j),
                               rtol=0, atol=1e-5)
    ((rgb * torch.tensor(g_rgb)).sum()
     + (alpha * torch.tensor(g_alpha)).sum()).backward()
    for a, b in zip(ckpt.tree_leaves(_grad_tree(model)),
                    jax.tree_util.tree_leaves(grads_j)):
        assert a.shape == np.shape(b)
        assert rel_norm(a, b) <= 1e-4


def _grad_tree(module):
    """The module's parameter gradients as a JAX params tree."""
    if isinstance(module, torch.nn.Linear):
        return {"b": module.bias.grad.numpy(),
                "w": module.weight.grad.numpy().T}
    if isinstance(module, torch.nn.ModuleList):
        return [_grad_tree(m) for m in module]
    return {k: _grad_tree(m) for k, m in module.named_children()}


def test_mlp2d_matches_jax():
    tree = mlp.init_mlp2d(jax_prng.prng_key(2), 32)
    jtree = jmlp.init_mlp2d(jax.random.PRNGKey(2), 32)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(500, 32)).astype(np.float32)
    g = rng.normal(size=(500, 3)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda p: jmlp.apply_mlp2d(p, jnp.asarray(x)), jtree)
    (grads_j,) = vjp(jnp.asarray(g))
    model = mlp.mlp2d_from_jax(tree)
    out = model(torch.tensor(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-5)
    (out * torch.tensor(g)).sum().backward()
    for a, b in zip(ckpt.tree_leaves(_grad_tree(model)),
                    jax.tree_util.tree_leaves(grads_j)):
        assert rel_norm(a, b) <= 1e-4


def _vanilla_args(*argv):
    return train_vanilla.build_parser().parse_args(
        ["--num_freq", "2", "--num_samples", "8", "--batch", "64",
         "--device", "cpu", *argv])


def _jax_render(params, o, d, n, t, args, jcfg):
    """The JAX CLI's ``render`` at given sample positions t."""
    B, S = t.shape
    pts = o[:, None, :] + d[:, None, :] * t[..., None]
    x = jpos.positional_encode(pts.reshape(-1, 3), args.num_freq,
                               args.pe_mode)
    v = jpos.positional_encode(d, args.num_freq, args.pe_mode)
    v = jnp.broadcast_to(v[:, None, :], (B, S, v.shape[-1])).reshape(B * S, -1)
    rgb, alpha = jmlp.apply_classic_nerf(params, x, jcfg, viewdirs=v)
    return jcomp.composite(t, rgb.reshape(B, S, 3), alpha.reshape(B, S), n)[0]


def test_vanilla_step_matches_jax():
    """One step of the vanilla trainer's loss and update (4 views of 8x8,
    64 pixels, 8 samples, 2 frequencies; a 4x32 ClassicNeRF from the JAX
    init), the image, pixels and sample positions handed over: the loss,
    every gradient, and the parameters after Adam at the schedule's first
    rate."""
    args = _vanilla_args()
    images, c2ws, K = dataset(n=4)
    rng = np.random.default_rng(3)
    img_idx, pix = 2, rng.integers(0, 64, args.batch)
    t = np.asarray(jsampling.stratified_ts(
        jax.random.PRNGKey(5), (args.batch,), args.near, args.far,
        args.num_samples))
    cfg, jcfg = _classic_cfgs(True)
    params = jmlp.init_classic_nerf(jax.random.PRNGKey(0), jcfg)

    def loss_fn(p):
        o, d, n = jrays.rays_for_pixels(
            jnp.asarray(pix % 8, jnp.float32), jnp.asarray(pix // 8,
                                                           jnp.float32),
            jnp.asarray(K), jnp.asarray(c2ws[img_idx]))
        C_ = _jax_render(p, o, d, n, jnp.asarray(t), args, jcfg)
        return jnp.mean((C_ - images[img_idx, pix // 8, pix % 8]) ** 2)

    tx = optax.adam(jstate.cosine_to_floor(args.lr, args.lr_final,
                                           args.num_iters))

    @jax.jit
    def reference(p):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, grads, optax.apply_updates(p, updates)

    loss_j, grads_j, ref = reference(params)

    ds = {"images": torch.tensor(images), "c2ws": torch.tensor(c2ws),
          "K": torch.tensor(K), "H": 8, "W": 8}
    model = mlp.classic_nerf_from_jax(
        mlp.init_classic_nerf(jax_prng.prng_key(0), cfg), cfg)
    loss = train_vanilla.batch_loss(model, ds, torch.tensor(img_idx),
                                    torch.tensor(pix), args,
                                    t=torch.tensor(t))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    for a, b in zip(ckpt.tree_leaves(_grad_tree(model)),
                    jax.tree_util.tree_leaves(grads_j)):
        assert rel_norm(a, b) <= 1e-4
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    opt.param_groups[0]["lr"] = state.cosine_to_floor(
        args.lr, args.lr_final, args.num_iters)(0)
    opt.step()
    for a, b in zip(ckpt.tree_leaves(mlp.to_jax_tree(model)),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


# Twenty steps of the vanilla trainer against JAX's loop (4 views of 8x8, 64
# pixels, 8 samples, 2 frequencies, the 4x32 ClassicNeRF from the JAX init,
# Adam on the cosine schedule of a 20-step horizon): the port's train_step
# handed the image index, pixels and sample depths that JAX's CLI draws from
# its keys at each step.  Measured over 40 such steps: the losses 1.2e-4
# apart at worst (relative), with no drift; so a longer run's different
# ending comes from the draws, not from the step.  Tolerance: rel 5e-4 per
# step, and the final parameters within 1e-3 of their norm.
VANILLA_STEPS, VANILLA_LOSS_RTOL = 20, 5e-4


def test_vanilla_twenty_steps_match_jax_with_its_draws():
    args = _vanilla_args("--num_iters", str(VANILLA_STEPS))
    images, c2ws, K = dataset(n=4)
    H = W = 8
    cfg, jcfg = _classic_cfgs(True)
    params = jmlp.init_classic_nerf(jax.random.PRNGKey(0), jcfg)
    tx = optax.adam(jstate.cosine_to_floor(args.lr, args.lr_final,
                                           args.num_iters))
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state, img_idx, pix, t):
        o, d, n = jrays.rays_for_pixels(
            (pix % W).astype(jnp.float32), (pix // W).astype(jnp.float32),
            jnp.asarray(K), jnp.asarray(c2ws)[img_idx])
        gt = jnp.asarray(images)[img_idx, pix // W, pix % W]
        loss, g = jax.value_and_grad(lambda p: jnp.mean(
            (_jax_render(p, o, d, n, t, args, jcfg) - gt) ** 2))(params)
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    ds = {"images": torch.tensor(images), "c2ws": torch.tensor(c2ws),
          "K": torch.tensor(K), "H": H, "W": W}
    model = mlp.classic_nerf_from_jax(
        mlp.init_classic_nerf(jax_prng.prng_key(0), cfg), cfg)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    sched = state.cosine_to_floor(args.lr, args.lr_final, args.num_iters)
    key, n_train = jax.random.PRNGKey(0), images.shape[0] - 1
    for it in range(VANILLA_STEPS):
        # the JAX CLI's draws: the image from k, then the pixels and the
        # jittered depths from split(k)
        key, k = jax.random.split(key)
        img_idx = jax.random.randint(k, (), 0, n_train)
        k1, k2 = jax.random.split(k)
        pix = jax.random.randint(k1, (args.batch,), 0, H * W)
        t = jsampling.stratified_ts(k2, (args.batch,), args.near, args.far,
                                    args.num_samples)
        params, opt_state, loss_j = jax_step(params, opt_state, img_idx, pix,
                                             t)
        loss = train_vanilla.train_step(
            model, opt, sched(it), ds, args, None,
            draws=tuple(torch.tensor(np.asarray(a))
                        for a in (img_idx, pix, t)))
        assert float(loss) == pytest.approx(float(loss_j),
                                            rel=VANILLA_LOSS_RTOL), it
    for a, b in zip(ckpt.tree_leaves(mlp.to_jax_tree(model)),
                    jax.tree_util.tree_leaves(params)):
        assert rel_norm(a, b) <= 1e-3


def test_sphere_field_matches_jax():
    pts = np.random.default_rng(0).uniform(-1, 1, (4000, 3)).astype(np.float32)
    rgb, sigma = synthetic.sphere_field(torch.tensor(pts))
    rgb_j, sigma_j = jsyn.sphere_field(jnp.asarray(pts))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(sigma_j), rtol=1e-5,
                               atol=1e-5)
    rgb, sigma = synthetic.sphere_field(torch.tensor(pts), radius=0.3)
    rgb_j, sigma_j = jsyn.sphere_field(jnp.asarray(pts), radius=0.3)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(sigma_j), rtol=1e-5,
                               atol=1e-5)


def test_pytree_checkpoint_both_ways(tmp_path):
    """A JAX ``save_pytree`` file read by the port, and the port's read by
    JAX, leaf for leaf, with extras; a wrong shape is refused."""
    tree = jmlp.init_classic_nerf(jax.random.PRNGKey(1),
                                  jC.ClassicNeRFConfig(**SMALL_NERF))
    jckpt.save_pytree(str(tmp_path / "j.npz"), tree, extra={"step": 3})
    template = mlp.init_classic_nerf(jax_prng.prng_key(9),
                                     C.ClassicNeRFConfig(**SMALL_NERF))
    got, extra = ckpt.load_pytree(str(tmp_path / "j.npz"), template,
                                  extra_keys=("step",))
    assert int(extra["step"]) == 3 and list(got) == list(template)
    for a, b in zip(ckpt.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b))
    ckpt.save_pytree(str(tmp_path / "p.npz"), got, extra={"step": 4})
    back, extra = jckpt.load_pytree(str(tmp_path / "p.npz"), tree,
                                    extra_keys=("step",))
    assert int(extra["step"]) == 4
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    template["output"]["b"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_pytree(str(tmp_path / "j.npz"), template)


def test_vanilla_cli_checkpoint_renders_same_in_jax(tmp_path, capsys):
    """``train_vanilla --write`` on the CPU: its ``.npz`` loads through the
    JAX ``load_pytree`` into the JAX model, which renders the test view as
    the port does (the unjittered ladder)."""
    out = str(tmp_path)
    res = train_vanilla.main([
        "--synthetic", "--num_iters", "4", "--batch", "64", "--num_samples",
        "8", "--num_freq", "3", "--log_every", "2", "--out_dir", out,
        "--model_name", "v", "--write", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "test view PSNR" in text and np.isfinite(res["test_psnr"])
    assert png.read_png(os.path.join(out, "v_test.png")).shape == (64, 64, 3)
    args = _vanilla_args("--num_freq", "3", "--synthetic")
    jcfg = jC.ClassicNeRFConfig(
        **dataclasses.asdict(train_vanilla.model_config(args)))
    params, _ = jckpt.load_pytree(
        res["path"], jmlp.init_classic_nerf(jax.random.PRNGKey(7), jcfg))
    ds = train_vanilla.load_data(args, torch.device("cpu"))
    o, d, n = jrays.full_image_rays(64, 64, jnp.asarray(ds["K"].numpy()),
                                    jnp.asarray(ds["c2ws"][9].numpy()))
    t = jsampling.stratified_ts(None, (o.shape[0],), args.near, args.far,
                                args.num_samples, jitter=False)
    ref = np.asarray(jax.jit(lambda p: _jax_render(p, o, d, n, t, args,
                                                   jcfg))(params))
    model = mlp.classic_nerf_from_jax(
        ckpt.load_pytree(res["path"], mlp.init_classic_nerf(
            jax_prng.prng_key(7), train_vanilla.model_config(args)))[0],
        train_vanilla.model_config(args))
    got = train_vanilla.render_view(model, ds, 9, args).numpy()
    np.testing.assert_allclose(got.reshape(-1, 3), ref, rtol=0, atol=1e-5)


def _noisy_pngs(tmp_path):
    pred, gt = tmp_path / "pred", tmp_path / "gt"
    pred.mkdir()
    gt.mkdir()
    rng = np.random.RandomState(0)
    base = (rng.rand(16, 16, 3) * 255).astype(np.uint8)
    png.write_png(str(gt / "gt.png"), base)
    png.write_png(str(gt / "gt2.png"), base[::-1].copy())
    for k, noise in enumerate([40, 20, 5]):
        img = np.clip(base.astype(int) + rng.randint(-noise, noise, base.shape),
                      0, 255).astype(np.uint8)
        png.write_png(str(pred / f"e{k}.png"), img)
    return str(pred), str(gt)


@pytest.mark.parametrize("per_frame", [False, True], ids=["first", "own"])
def test_plot_psnr_curve_matches_jax(tmp_path, capsys, per_frame):
    pred, gt = _noisy_pngs(tmp_path)
    port = plot_psnr.psnr_dir(pred, gt, per_frame_gt=per_frame)
    ref = jplot_psnr.psnr_dir(pred, gt, per_frame_gt=per_frame)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-4)
    assert len(port) == 3 and (per_frame or port[-1] > port[0])
    out = str(tmp_path / "psnr.png")
    argv = ["--pred_dirs", pred, "--gt_dirs", gt, "--out", out] + (
        ["--per_frame_gt"] if per_frame else [])
    curves = plot_psnr.main(argv + ["--device", "cpu"])
    np.testing.assert_allclose(curves[pred], ref, rtol=0, atol=1e-4)
    text = capsys.readouterr().out
    assert f"MEAN_PSNR for {pred}: {ref[-1]:.3f} (final)" in text
    assert os.path.exists(out)


def test_plot_psnr_without_matplotlib_prints_then_refuses(tmp_path, capsys,
                                                          monkeypatch):
    pred, gt = _noisy_pngs(tmp_path)
    real_import = builtins.__import__

    def no_mpl(name, *a, **k):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("no matplotlib here")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(SystemExit, match="matplotlib"):
        plot_psnr.main(["--pred_dirs", pred, "--gt_dirs", gt, "--out",
                        str(tmp_path / "x.png"), "--device", "cpu"])
    assert "MEAN_PSNR for" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "x.png")


def test_train_hash_cli_logs_grad_norms_and_writes_preview(tmp_path):
    """``--plot_grads --display`` on the CPU: every log record carries the
    JAX grad-norm keys, and each eval render also writes the preview PNG
    (no window without a display)."""
    tr = train_hash.main([
        "--synthetic", "--steps", "4", "--num_batch", "32", "--max_res", "64",
        "--num_levels", "3", "--cp_rank", "2", "--num_samples", "8",
        "--no_occupancy", "--log_every", "2", "--eval_every", "2",
        "--plot_grads", "--display", "--device", "cpu", "--out_dir",
        str(tmp_path), "--model_name", "pg"])
    assert len(tr.history) == 2
    for rec in tr.history:
        norms = {k: v for k, v in rec.items() if k.startswith("grad_norm/")}
        assert set(norms) == {"grad_norm/lines", "grad_norm/mlp"} or set(
            norms) == {"grad_norm/lines", "grad_norm/dense", "grad_norm/mlp"}
        assert all(np.isfinite(v) and v > 0 for v in norms.values())
    with open(tmp_path / "pg_metrics.jsonl") as f:
        assert "grad_norm/mlp" in json.loads(f.readline())
    img = png.read_png(str(tmp_path / "pg_preview.png"))
    assert img.shape[-1] == 3 and img.dtype == np.uint8
