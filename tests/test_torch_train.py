"""PyTorch port vs the JAX package: the training slice.

A small CP model (4 levels up to n_max 128, rank 4, 2 dense levels, MLP
width 16; 16-sample ladder, guided placement of 8 samples from 8 probes
with 5% exploration, mass dt; TV 1e-2 from step 5; density L1 1e-3) goes
through one training step on both sides: the same params (built by the
JAX ``init_params``, carried across by ``from_jax_params``), the same ray
batch and the same random draws (drawn with jax.random from the JAX keys
and handed to the port).  Also: the schedule and the optimizer in
isolation, the density branch, the synthetic ground truth, a few steps of
the port's fit loop, and its checkpoint restored and rendered by the JAX
package.  Test names avoid the words that tests/conftest.py marks slow.
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
from human_body_reconstruction_tpu.data import synthetic as jsyn
from human_body_reconstruction_tpu.models import nerf as jnerf
from human_body_reconstruction_tpu.ops import occupancy as jocc
from human_body_reconstruction_tpu.ops import sampling as jsampling
from human_body_reconstruction_tpu.pipeline import restore as jrestore
from human_body_reconstruction_tpu.train import state as jstate
from human_body_reconstruction_tpu.train import step as jstep
from human_body_reconstruction_tpu.train import trainer as jtrainer
from human_body_reconstruction_tpu_torch.cli import train_hash
from human_body_reconstruction_tpu_torch.data import synthetic
from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.ops import dense_grid, occupancy
from human_body_reconstruction_tpu_torch.pipeline import restore
from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
from human_body_reconstruction_tpu_torch.train import state, step
from human_body_reconstruction_tpu_torch.train import trainer as trainer_lib
from human_body_reconstruction_tpu_torch.utils import config as C
from test_torch_ops import _JnpWithTorchSums

LO = np.array([-1.5, -1.5, -1.5], np.float32)
HI = np.array([1.5, 1.5, 1.5], np.float32)
B = 64


def small_cfg(bf16: bool) -> C.PipelineConfig:
    """In bf16 the JAX side runs its dense Pallas kernel (interpreted), whose
    roundings the port's encoder follows; its XLA path rounds the dense
    gradient elsewhere and moves it by about 3e-2 of its norm.  The CP
    Pallas kernel is too slow interpreted: the JAX CP levels stay XLA."""
    h = C.HashConfig(num_levels=4, n_max=128, variant="cp", cp_rank=4,
                     dense_bf16=bf16, init_scale=0.5, cp_init_scale=0.6,
                     dense_impl="pallas" if bf16 else "xla")
    h = dataclasses.replace(h, dense_levels=dense_grid.auto_dense_levels(h))
    return C.PipelineConfig(
        hash=h, mlp=C.MLPConfig(width=16),
        render=C.RenderConfig(num_samples=16, occupancy=True,
                              occupancy_resolution=16, compact_samples=8,
                              occ_guided=True, occ_probes=8,
                              occ_explore=0.05, occ_dt="mass",
                              occ_stratified=True),
        train=C.TrainConfig(ray_batch=B, cp_tv_weight=1e-2, cp_tv_warmup=5,
                            sigma_l1_weight=1e-3,
                            compute_dtype="bfloat16" if bf16 else "float32"))


def jax_params(cfg):
    params = jax.tree.map(np.array, jtrainer.init_params(
        jax.random.PRNGKey(0), cfg))
    params["mlp"]["sig"][-1]["b"][0] += 1.0       # visibly opaque density
    return params


def ball_mask(g=16):
    c = (np.arange(g) + 0.5) / g * np.sqrt(3.0) * 3.0 - 1.5
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    return ((xx ** 2 + yy ** 2 + zz ** 2) < 1.0).astype(np.float32)


def both_occ(mask):
    return (jocc.OccupancyGrid(jnp.asarray(mask), jnp.asarray(mask),
                               jnp.float32(0.01)),
            occupancy.OccupancyGrid(torch.tensor(mask), torch.tensor(mask),
                                    torch.tensor(0.01)))


def dataset(seed=0, n=3, hw=8):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(n, hw, hw, 3)).astype(np.float32)
    c2ws = synthetic.orbit_poses(n, radius=4.0, elevation=0.35)
    K = np.array([[10.0, 0, hw / 2], [0, 10.0, hw / 2], [0, 0, 1]],
                 np.float32)
    return images, c2ws, K


def jax_batch(key, images, c2ws, K):
    """The JAX batch, and the indices it drew (for the port)."""
    k1, k2 = jax.random.split(key)
    n, h, w = images.shape[:3]
    img = np.asarray(jax.random.randint(k1, (B,), 0, n))
    pix = np.asarray(jax.random.randint(k2, (B,), 0, h * w))
    batch = jstep.sample_ray_batch(key, jnp.asarray(images),
                                   jnp.asarray(c2ws), jnp.asarray(K), B)
    return batch, torch.tensor(img), torch.tensor(pix)


def port_scene():
    return nerf.scene_from_bounds(LO, HI)


def group_grads(field):
    """Gradients per group in the JAX layout, flattened."""
    out = {}
    for name, params in (("dense", field.dense), ("lines", field.lines),
                         ("mlp", list(field.mlp.parameters()))):
        out[name] = np.concatenate([p.grad.numpy().reshape(-1)
                                    for p in params])
    return out


def rel_norm(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_sample_ray_batch_matches():
    images, c2ws, K = dataset()
    batch, img, pix = jax_batch(jax.random.PRNGKey(1), images, c2ws, K)
    port = step.sample_ray_batch(torch.tensor(images), torch.tensor(c2ws),
                                 torch.tensor(K), B, img_idx=img,
                                 pix_idx=pix)
    for a, b in zip(port, batch):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    drawn = step.sample_ray_batch(torch.tensor(images), torch.tensor(c2ws),
                                  torch.tensor(K), B,
                                  torch.Generator().manual_seed(0))
    assert all(tuple(t.shape[:1]) == (B,) for t in drawn)


def _one_step(cfg, guided: bool, bf16: bool, step_no: int, monkeypatch):
    """(JAX loss, aux, grads by group), (port loss, aux, grads by group)."""
    monkeypatch.setattr(jsampling, "jnp", _JnpWithTorchSums())
    params = jax_params(cfg)
    field = ckpt.from_jax_params(params, cfg)
    images, c2ws, K = dataset()
    batch, img, pix = jax_batch(jax.random.PRNGKey(2), images, c2ws, K)
    key = jax.random.PRNGKey(3)
    k_strat = jax.random.split(key, 4)[0]
    r = cfg.render
    if guided:
        draws = {"xi": torch.tensor(np.asarray(jax.random.uniform(
            k_strat, (B, r.compact_samples), maxval=1.0 - 1e-6)))}
        occ_j, occ_p = both_occ(ball_mask(r.occupancy_resolution))
    else:
        draws = {"u": torch.tensor(np.asarray(jax.random.uniform(
            k_strat, (B, r.num_samples))))}
        occ_j = occ_p = None
    (loss_j, aux_j), grads_j = jax.value_and_grad(jstep.loss_fn,
                                                  has_aux=True)(
        jax.tree.map(jnp.asarray, params),
        jrestore.scene_from_bounds(LO, HI), batch, key, cfg, occ_j,
        jnp.bfloat16 if bf16 else None, step=step_no)
    tbatch = step.sample_ray_batch(torch.tensor(images), torch.tensor(c2ws),
                                   torch.tensor(K), B, img_idx=img,
                                   pix_idx=pix)
    loss_p, aux_p = step.loss_fn(field, port_scene(), tbatch, cfg, occ_p,
                                 torch.bfloat16 if bf16 else None,
                                 step=step_no, draws=draws)
    loss_p.backward()
    gj = {k: np.concatenate([np.asarray(g).reshape(-1) for g in
                             jax.tree_util.tree_leaves(grads_j[k])])
          for k in ("dense", "lines")}
    # the MLP leaves in the port's parameter order and layout
    gj["mlp"] = np.concatenate(
        [np.asarray(g).reshape(-1) for branch in ("sig", "col")
         for layer in grads_j["mlp"][branch]
         for g in (np.asarray(layer["w"]).T, layer["b"])])
    aux_p = {k: v.detach() for k, v in aux_p.items()}
    return (float(loss_j), aux_j, gj), (float(loss_p.detach()), aux_p,
                                        group_grads(field))


# Tolerances (loss relative; gradients ||port - jax|| / ||jax|| per group):
# f32 compute (dense_bf16 off, f32 MLP): the same function, sums in other
# orders: 1e-5 both.  bf16: the JAX CP levels round where XLA rounds, the
# port's where the Pallas kernels round (a few bf16 ulps per feature,
# tests/test_torch_encoders.py), and the bf16 MLP rounds its cotangents on
# both sides; measured up to 7.1e-3 (dense, ladder): loss 1e-3, gradients
# 1e-2.
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("guided", [False, True], ids=["ladder", "guided"])
def test_step_loss_and_grads_match_jax(bf16, guided, monkeypatch):
    cfg = small_cfg(bf16)
    (lj, auxj, gj), (lp, auxp, gp) = _one_step(cfg, guided, bf16, 10,
                                               monkeypatch)
    assert np.isfinite(lp) and lp > 0
    assert lp == pytest.approx(lj, rel=1e-3 if bf16 else 1e-5)
    assert float(auxp["cp_tv"]) == pytest.approx(float(auxj["cp_tv"]),
                                                  rel=1e-5)
    assert float(auxp["psnr"]) == pytest.approx(float(auxj["psnr"]),
                                                abs=1e-2 if bf16 else 1e-4)
    for k in gj:
        assert gp[k].shape == gj[k].shape
        assert rel_norm(gp[k], gj[k]) <= (1e-2 if bf16 else 1e-5), k


def test_loss_tv_warmup_gating_matches_jax(monkeypatch):
    """Before cp_tv_warmup the TV term is computed but not added; from it
    on, loss grows by exactly cp_tv_weight * TV on both sides."""
    cfg = small_cfg(False)
    (lj3, auxj, _), (lp3, auxp, _) = _one_step(cfg, False, False, 3,
                                               monkeypatch)
    (lj10, _, _), (lp10, _, _) = _one_step(cfg, False, False, 10,
                                           monkeypatch)
    assert lp3 == pytest.approx(lj3, rel=1e-5)
    assert lp10 == pytest.approx(lj10, rel=1e-5)
    tv = float(auxp["cp_tv"])
    assert tv > 0 and lp10 - lp3 == pytest.approx(1e-2 * tv, rel=1e-3)
    assert lj10 - lj3 == pytest.approx(1e-2 * float(auxj["cp_tv"]),
                                       rel=1e-3)


def test_cosine_to_floor_matches_optax_schedule():
    for total in (1, 100, 7000):
        ref = jstate.cosine_to_floor(0.05, 1e-4, total)
        port = state.cosine_to_floor(0.05, 1e-4, total)
        for s in (0, 1, 37, total // 2, total - 1, total, total + 50):
            assert port(s) == pytest.approx(float(ref(jnp.int32(s))),
                                            rel=1e-6, abs=1e-9)


def test_optimizer_matches_optax_three_updates():
    """The same gradients, drawn with numpy, fed to optax's grouped
    transform and to the port's optimizer for three updates: Adam (eps
    1e-15) on the tables, AdamW on the MLP, learning rates from the
    schedule at the pre-update count.  Both compute Adam's formula in f32
    in different orders: params atol 1e-6."""
    cfg = small_cfg(False)
    params = jax.tree.map(jnp.asarray, jax_params(cfg))
    field = ckpt.from_jax_params(jax_params(cfg), cfg)
    total = 4
    tx = jstate.make_optimizer(cfg.train, total, params)
    opt_state = tx.init(params)
    opt = state.make_optimizer(cfg.train, total, field)
    slots = ckpt._slots(field)
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    for k in range(3):
        grads = [rng.normal(size=np.shape(x)).astype(np.float32)
                 for x in leaves]
        updates, opt_state = tx.update(
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


def test_density_only_and_refresh_match_jax():
    """The density branch (f32) at world points, and one occupancy refresh
    from the field with injected cells and jitter: the refreshed cells hold
    the JAX field's density there (atol 1e-5)."""
    cfg = small_cfg(False)
    params = jax_params(cfg)
    field = ckpt.from_jax_params(params, cfg)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1.5, 1.5, (300, 3)).astype(np.float32)
    scene_j = jrestore.scene_from_bounds(LO, HI)
    ref = np.asarray(jnerf.density_only(jax.tree.map(jnp.asarray, params),
                                        scene_j, jnp.asarray(pts), cfg))
    with torch.no_grad():
        port = nerf.density_only(field, port_scene(), torch.tensor(pts), cfg)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-5)

    g = 8
    cells = rng.choice(g ** 3, 100, replace=False)
    jit = rng.uniform(size=(100, 3)).astype(np.float32)
    grid = occupancy.init_grid(g, 0.01)
    out = occupancy.update_from_field(
        grid, field, port_scene(), cfg, num_cells=100,
        flat_idx=torch.tensor(cells), jitter=torch.tensor(jit))
    c = np.stack([cells // (g * g), (cells // g) % g, cells % g], -1)
    wpts = ((c + jit) / g * float(scene_j["sigma"]) + LO).astype(np.float32)
    want = np.maximum(np.asarray(jnerf.density_only(
        jax.tree.map(jnp.asarray, params), scene_j, jnp.asarray(wpts),
        cfg)), 0.0)
    np.testing.assert_allclose(out.density.reshape(-1)[cells].numpy(), want,
                               rtol=0, atol=1e-5)
    assert int(torch.isinf(out.density).sum()) == g ** 3 - 100


@pytest.mark.parametrize("subject", ["textured_field", "blob_field"])
def test_synthetic_ground_truth_matches_jax(subject):
    """Analytic field and its dense-sample render at 24x24, 384 samples:
    the same f32 math (transcendentals may differ by an ulp): atol 1e-5."""
    K = np.array([[30.0, 0, 12.0], [0, 30.0, 12.0], [0, 0, 1]], np.float32)
    c2w = synthetic.orbit_poses(5, radius=4.0, elevation=0.35)[2]
    port = synthetic.render_gt_image(24, 24, torch.tensor(K),
                                     torch.tensor(c2w),
                                     field=getattr(synthetic, subject),
                                     num_samples=384).numpy()
    ref = np.asarray(jsyn.render_gt_image(24, 24, jnp.asarray(K), c2w,
                                          field=getattr(jsyn, subject),
                                          num_samples=384))
    assert port.std() > 0.05
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-5)
    ds = synthetic.make_dataset(n_views=2, H=6, W=6, focal=8.0,
                                field=getattr(synthetic, subject),
                                gt_samples=32)
    jds = jsyn.make_dataset(n_views=2, H=6, W=6, focal=8.0,
                            field=getattr(jsyn, subject), gt_samples=32)
    for k in ("images", "c2ws", "K"):
        np.testing.assert_allclose(ds[k].numpy(), np.asarray(jds[k]),
                                   rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """Twelve steps of the port's fit loop on a tiny blob dataset: grid
    installed at step 4, refreshed every 3 steps, log every 4."""
    d = str(tmp_path_factory.mktemp("fit"))
    cfg = small_cfg(True)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, occ_warmup_steps=4, update_rate=3))
    ds = synthetic.make_dataset(n_views=3, H=12, W=12, focal=15.0,
                                gt_samples=64)
    logs = []
    refreshes = []
    orig = occupancy.update_from_field

    def counting(*a, **k):
        refreshes.append(1)
        return orig(*a, **k)

    trainer_lib.occupancy.update_from_field = counting
    try:
        tr = trainer_lib.Trainer(cfg=cfg, ds=ds, out_dir=d, model_name="m",
                                 total_steps=12, log_fn=logs.append)
        tr.run(12, log_every=4)
    finally:
        trainer_lib.occupancy.update_from_field = orig
    tr.save()
    return tr, d, logs, len(refreshes)


def test_fit_loop_installs_grid_and_refreshes(fitted):
    tr, d, logs, n_refresh = fitted
    assert tr.state.step == 12 and tr.state.occ is not None
    assert "occupancy culling engaged at step 4" in logs
    # install at 4, then the cadence crossings at 6, 9 and 12
    assert n_refresh == 4
    assert [r["step"] for r in tr.history] == [4, 8, 12]
    assert "occupied_frac" not in tr.history[0]
    assert 0.0 <= tr.history[-1]["occupied_frac"] <= 1.0
    assert all(np.isfinite(r["loss"]) for r in tr.history)
    for name in ("m_ckpt.npz", "m_config.json", "bounds_model.npy",
                 "m_metrics.jsonl", "m_metrics.csv"):
        assert os.path.exists(os.path.join(d, name)), name
    with np.load(os.path.join(d, "m_ckpt.npz")) as data:
        assert int(data["extra_step"]) == 12
        assert "extra_occ_mask" in data


def test_fit_loop_checkpoint_renders_same_in_jax(fitted):
    """The port-written checkpoint restores through the JAX
    pipeline/restore (positional params, the saved grid) and renders the
    same 16x16 ladder frame as the port: the port's encoder has the Pallas
    roundings, the JAX CPU path the XLA ones: atol 1e-3."""
    tr, d, _, _ = fitted
    jres = jrestore.restore(d, "m", with_occ=True, log_fn=lambda s: None)
    pres = restore.restore(d, "m", device="cpu", with_occ=True,
                           log_fn=lambda s: None)
    assert dataclasses.asdict(jres.cfg) == dataclasses.asdict(pres.cfg)
    np.testing.assert_array_equal(np.asarray(jres.occ.mask),
                                  pres.occ.mask.numpy())
    for a, b in zip(jax.tree_util.tree_leaves(jres.params),
                    ckpt.jax_leaves(tr.state.field)):
        np.testing.assert_array_equal(np.asarray(a), b)
    K = np.array([[20.0, 0, 8.0], [0, 20.0, 8.0], [0, 0, 1]], np.float32)
    c2w = synthetic.orbit_poses(4)[1]
    img = step.render_image(pres.field, pres.scene, 16, 16, torch.tensor(K),
                            torch.tensor(c2w), pres.cfg, occ=pres.occ,
                            num_samples=16).numpy()
    ref = np.asarray(jstep.render_image_fused(
        jres.params, jres.scene, 16, 16, jnp.asarray(K), jnp.asarray(c2w),
        jres.cfg, occ=jres.occ, num_samples=16, chunk=128))
    assert np.isfinite(img).all() and img.std() > 1e-3
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("argv", [
    [], ["--cp_rank", "8", "--num_levels", "5"], ["--occ_warmup", "64"],
    ["--no_occ_stratified", "--occ_probe_jitter"],
    ["--max_res", "512", "--dense_levels", "1"]])
def test_cli_config_matches_jax(argv):
    args = train_hash.build_parser().parse_args(argv)
    assert dataclasses.asdict(train_hash.make_config(args)) == \
        dataclasses.asdict(jcli.make_config(jcli.build_parser().parse_args(argv)))
    train_hash.check_supported(args, train_hash.make_config(args))


@pytest.mark.parametrize("argv", [
    ["--use_sdf"], ["--hierarchical"], ["--encoder_variant", "cell"],
    ["--data_parallel"], ["--steps_per_call", "4"], ["--load"],
    ["--occupancy", "--preset", "reference", "--compact", "8"],
    ["--stochastic", "--packed"], ["--packed_exact"],
    ["--stochastic", "--scatter_strategy", "sorted"]])
def test_cli_refuses_what_is_not_ported(argv):
    args = train_hash.build_parser().parse_args(argv)
    with pytest.raises(SystemExit):
        train_hash.check_supported(args, train_hash.make_config(args))


def test_cli_main_runs_a_few_steps(tmp_path):
    tr = train_hash.main([
        "--synthetic", "--steps", "3", "--num_batch", "32", "--max_res", "64",
        "--num_levels", "3", "--cp_rank", "2", "--num_samples", "8",
        "--compact", "4", "--occ_probes", "4", "--occ_warmup", "1",
        "--update_rate", "2", "--log_every", "1", "--device", "cpu",
        "--out_dir", str(tmp_path), "--model_name", "cli"])
    assert tr.state.step == 3 and tr.state.occ is not None
    assert len(tr.history) == 3
    assert os.path.exists(tmp_path / "cli_ckpt.npz")
