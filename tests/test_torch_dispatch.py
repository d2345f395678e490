"""PyTorch port vs the JAX package: the one-dispatch paths on the CPU.

The JAX package fuses n training steps into one dispatch
(``train_step_multi``, a ``lax.scan``) and a frame or a pose batch into one
(``render_image_fused``, ``render_poses_fused``).  The port's counterparts
replay captured CUDA graphs on the card; on the CPU they run their eager
loops, which these tests hold to JAX at a small size (a 3-level CP model,
rank 2, 32 rays, 8 samples): the window's mean metrics and the parameters
after it, the cadence of the trainer's install, refresh, log and eval under
a window, the device-side schedules, and the fused frames.  The graphs
themselves run only on the card (``chip_smoke.py`` and the ``cuda`` cases
of ``tests/test_torch_kernels.py``).  Test names avoid the words that
tests/conftest.py marks slow.
"""

import base64
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from human_body_reconstruction_tpu.ops import sampling as jsampling
from human_body_reconstruction_tpu.pipeline import restore as jrestore
from human_body_reconstruction_tpu.train import checkpoint as jckpt
from human_body_reconstruction_tpu.train import state as jstate
from human_body_reconstruction_tpu.train import step as jstep
from human_body_reconstruction_tpu.train import trainer as jtrainer
from human_body_reconstruction_tpu_torch.cli import render, serve, speedrun
from human_body_reconstruction_tpu_torch.cli import train_hash
from human_body_reconstruction_tpu_torch.data import synthetic
from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.ops import dense_grid
from human_body_reconstruction_tpu_torch.pipeline import restore
from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
from human_body_reconstruction_tpu_torch.train import state, step
from human_body_reconstruction_tpu_torch.train import trainer as trainer_lib
from human_body_reconstruction_tpu_torch.utils import config as C
from torch_threads import one_torch_thread  # noqa: F401

LO = np.array([-1.5, -1.5, -1.5], np.float32)
HI = np.array([1.5, 1.5, 1.5], np.float32)
B, HW, WINDOW = 32, 8, 4


def t(a):
    return torch.tensor(np.asarray(a))


def small_cfg(tv_warmup: int = 0, occupancy: bool = False) -> C.PipelineConfig:
    h = C.HashConfig(num_levels=3, n_max=64, variant="cp", cp_rank=2,
                     dense_bf16=False, dense_impl="xla", init_scale=0.5,
                     cp_init_scale=0.6)
    h = dataclasses.replace(h, dense_levels=dense_grid.auto_dense_levels(h))
    return C.PipelineConfig(
        hash=h, mlp=C.MLPConfig(width=16),
        render=C.RenderConfig(num_samples=8, occupancy=occupancy,
                              occupancy_resolution=8),
        train=C.TrainConfig(ray_batch=B, cp_tv_weight=1e-2,
                            cp_tv_warmup=tv_warmup, sigma_l1_weight=1e-3,
                            compute_dtype="float32"))


def jax_params(cfg):
    params = jax.tree.map(np.array, jtrainer.init_params(
        jax.random.PRNGKey(0), cfg))
    params["mlp"]["sig"][-1]["b"][0] += 1.0       # visibly opaque density
    return params


def dataset(n=3):
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(n, HW, HW, 3)).astype(np.float32)
    c2ws = synthetic.orbit_poses(n, radius=4.0, elevation=0.35)
    K = np.array([[10.0, 0, HW / 2], [0, 10.0, HW / 2], [0, 0, 1]],
                 np.float32)
    return images, c2ws, K


def jax_feed(key, i, n_images, cfg):
    """The draws of the JAX step at update count i (``_train_step_impl``'s
    key use): the batch's indices and the ladder's jittered samples."""
    r = cfg.render
    k_batch, k_render = jax.random.split(jax.random.fold_in(key, i))
    k1, k2 = jax.random.split(k_batch)
    img = jax.random.randint(k1, (B,), 0, n_images)
    pix = jax.random.randint(k2, (B,), 0, HW * HW)
    k_strat = jax.random.split(k_render, 4)[0]
    ts = jsampling.stratified_ts(k_strat, (B,), r.near, r.far, r.num_samples,
                                 per_ray_jitter=r.per_ray_jitter)
    return {"img_idx": t(img), "pix_idx": t(pix), "placement": (t(ts), None)}


# The window against JAX's scan: the same params, and every step handed
# JAX's batch and samples.  Limits: the window's mean metrics 1e-5
# relative, each parameter leaf 1.4e-5 of its norm; "tv_in_window" turns
# the TV on at update 2, inside the window of 4.
@pytest.mark.parametrize("tv_warmup", [0, 2], ids=["tv_on", "tv_in_window"])
def test_window_matches_jax_train_step_multi(tv_warmup):
    cfg = small_cfg(tv_warmup)
    params = jax_params(cfg)
    images, c2ws, K = dataset()
    data = tuple(jnp.asarray(a) for a in (images, c2ws, K))
    jscene = jrestore.scene_from_bounds(LO, HI)
    sj, tx = jstate.create_train_state(jax.tree.map(jnp.asarray, params),
                                       cfg.train, 10)
    key = jax.random.PRNGKey(1)
    feeds = [jax_feed(key, i, images.shape[0], cfg) for i in range(WINDOW)]
    sj, mj = jstep.train_step_multi(sj, jscene, *data, key, cfg=cfg, tx=tx,
                                    batch_size=B, n_steps=WINDOW)
    sp = state.create_train_state(ckpt.from_jax_params(params, cfg),
                                  cfg.train, 10)
    mp = step.train_step_multi(sp, nerf.scene_from_bounds(LO, HI),
                               t(images), t(c2ws), t(K), cfg, B, WINDOW,
                               feeds=feeds)
    assert sp.step == int(sj.step) == WINDOW
    assert int(sp.opt.count) == WINDOW
    assert set(mp) == set(mj)
    for k in mj:
        assert float(mp[k]) == pytest.approx(float(mj[k]), rel=1e-5), k
    for a, b in zip(ckpt.jax_leaves(sp.field),
                    jax.tree_util.tree_leaves(sj.params)):
        b = np.asarray(b)
        assert np.linalg.norm(a - b) <= 1.4e-5 * np.linalg.norm(b)


def test_window_mean_is_mean_of_its_steps():
    """The window's metrics are the mean of the same steps taken one at a
    time from the same state and generator, and it leaves the same
    parameters and count."""
    cfg = small_cfg(2)
    params = jax_params(cfg)
    images, c2ws, K = (t(a) for a in dataset())
    scene = nerf.scene_from_bounds(LO, HI)
    runs = []
    for multi in (False, True):
        sp = state.create_train_state(ckpt.from_jax_params(params, cfg),
                                      cfg.train, 10)
        gen = torch.Generator().manual_seed(3)
        if multi:
            m = step.train_step_multi(sp, scene, images, c2ws, K, cfg, B,
                                      WINDOW, gen)
        else:
            ms = [step.train_step(sp, scene, images, c2ws, K, cfg, B, gen)
                  for _ in range(WINDOW)]
            m = {k: sum(x[k] for x in ms) / WINDOW for k in ms[0]}
        runs.append((m, sp))
    (m1, s1), (m2, s2) = runs
    assert s1.step == s2.step == WINDOW
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for a, b in zip(s1.field.parameters(), s2.field.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="n_steps"):
        step.train_step_multi(s1, scene, images, c2ws, K, cfg, B, 0)


# ------------------------------------------------------------- event cadence

EVENTS = dict(steps=19, spc=4, warmup=6, update_rate=3, log=5, every=8)


def event_cfg() -> C.PipelineConfig:
    cfg = small_cfg(occupancy=True)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, occ_warmup_steps=EVENTS["warmup"],
        update_rate=EVENTS["update_rate"]))


def jax_events(tmp_path):
    """The JAX trainer's events with its step functions stubbed (the
    schedule depends on the loop alone): each window advances the count."""
    cfg = event_cfg()
    images, c2ws, K = dataset()
    ds = {"images": jnp.asarray(images), "c2ws": jnp.asarray(c2ws),
          "K": jnp.asarray(K), "H": HW, "W": HW}
    tr = jtrainer.Trainer(cfg=cfg, ds=ds, out_dir=str(tmp_path),
                          log_fn=lambda s: None, write_metrics=False,
                          total_steps=EVENTS["steps"],
                          steps_per_call=EVENTS["spc"])
    ev = {"install": [], "refresh": [], "windows": [], "eval": []}
    zero = {"loss": jnp.float32(0.0), "psnr": jnp.float32(0.0)}

    def window(state, *a, n_steps=1, **k):
        ev["windows"].append(n_steps)
        return state._replace(step=state.step + n_steps), zero

    tr._multi_fn = window
    tr._step_fn = lambda state, *a, **k: window(state)
    install = tr._install_occ
    tr._install_occ = lambda s: (ev["install"].append(s), install(s))
    tr.update_occupancy = lambda s=None: (
        tr.state.occ is not None and ev["refresh"].append(s))
    tr.eval_render = lambda *a, tag="", **k: ev["eval"].append(int(tag))
    tr.save = lambda: None
    tr.run(EVENTS["steps"], log_every=EVENTS["log"],
           eval_every=EVENTS["every"])
    ev["log"] = [r["step"] for r in tr.history]
    return ev


def test_window_events_match_jax(tmp_path):
    """steps_per_call 4 over 19 steps (windows 4, 4, 4, 4, 3), warmup 6,
    refresh every 3, log every 5, eval every 8: the port's trainer installs
    the grid, refreshes it, logs and evaluates at the steps the JAX
    trainer does."""
    cfg = event_cfg()
    images, c2ws, K = dataset()
    ds = {"images": t(images), "c2ws": t(c2ws), "K": t(K), "H": HW,
          "W": HW}
    tr = trainer_lib.Trainer(cfg=cfg, ds=ds, out_dir=str(tmp_path / "p"),
                             log_fn=lambda s: None,
                             total_steps=EVENTS["steps"],
                             steps_per_call=EVENTS["spc"])
    ev = {"install": [], "refresh": [], "eval": []}
    install, refresh = tr._install_occ, tr.update_occupancy
    tr._install_occ = lambda s: (ev["install"].append(s), install(s))
    tr.update_occupancy = lambda: (
        tr.state.occ is not None and ev["refresh"].append(tr.state.step),
        refresh())
    tr.eval_render = lambda tag="": ev["eval"].append(int(tag))
    tr.run(EVENTS["steps"], log_every=EVENTS["log"],
           eval_every=EVENTS["every"])
    ev["log"] = [r["step"] for r in tr.history]
    want = jax_events(tmp_path / "j")
    assert want["windows"] == [4, 4, 4, 4, 3]
    assert want["install"] == [8]           # the first boundary past 6
    assert ev == {k: v for k, v in want.items() if k != "windows"}
    assert tr.state.step == EVENTS["steps"] and tr.state.occ is not None
    assert all(np.isfinite(r["loss"]) for r in tr.history)


def test_window_refresh_writes_the_installed_grid(tmp_path):
    """A refresh writes into the installed grid's storage (which a captured
    step reads at the addresses it captured), and changes it."""
    cfg = event_cfg()
    images, c2ws, K = dataset()
    ds = {"images": t(images), "c2ws": t(c2ws), "K": t(K), "H": HW,
          "W": HW}
    tr = trainer_lib.Trainer(cfg=cfg, ds=ds, out_dir=str(tmp_path),
                             log_fn=lambda s: None, total_steps=12,
                             steps_per_call=4)
    tr.run(12, log_every=0)
    grid = tr.state.occ
    ptrs = [x.data_ptr() for x in grid]
    before = grid.density.clone()
    tr.update_occupancy()
    assert tr.state.occ is grid
    assert [x.data_ptr() for x in tr.state.occ] == ptrs
    assert not torch.equal(before, grid.density)


# ----------------------------------------------------------------- schedules

@pytest.mark.parametrize("kind", ["cosine", "onecycle"])
def test_device_schedules_match_optax_and_host(kind):
    """The device schedules, in f32 on an int32 count, against optax's and
    the host's closed forms, over the horizon and past it: within an f32
    ulp of the base rate from optax's (the two libraries' cos may round
    differently, and near a leg's end 1 + cos cancels, so the distance is
    measured on the rate's scale) and within 1e-6 of the base rate from
    the host's f64 closed form."""
    total = 40
    if kind == "cosine":
        dev = state.cosine_to_floor_t(0.05, 1e-4, total)
        host = state.cosine_to_floor(0.05, 1e-4, total)
        ref = jstate.cosine_to_floor(0.05, 1e-4, total)
    else:
        dev = state.onecycle_t(0.05, total)
        host = state.onecycle(0.05, total)
        ref = optax.cosine_onecycle_schedule(transition_steps=total,
                                             peak_value=0.05)
    counts = np.arange(total + 3, dtype=np.int32)
    got = dev(torch.tensor(counts)).numpy()
    want = np.array([np.asarray(ref(jnp.int32(c))) for c in counts],
                    np.float32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -23 * 0.05)
    np.testing.assert_allclose(got, [host(int(c)) for c in counts],
                               rtol=0, atol=1e-6 * 0.05)


def test_optimizer_count_and_rates_on_the_device():
    """The optimizer keeps optax's int32 count on the parameters' device,
    advances it once an update, and records each group's rate there."""
    cfg = small_cfg()
    field = ckpt.from_jax_params(jax_params(cfg), cfg)
    opt = state.make_optimizer(cfg.train, 10, field)
    assert opt.count.dtype == torch.int32 and int(opt.count) == 0
    for p in field.parameters():
        p.grad = torch.ones_like(p)
    opt.step(3)
    assert int(opt.count) == 4
    opt.step()
    assert int(opt.count) == 5
    rate = state.cosine_to_floor(cfg.train.lr_hash, cfg.train.lr_final, 10)
    assert float(opt.groups[0].lr) == pytest.approx(rate(4), rel=1e-6)


# -------------------------------------------------------------- the CLIs

def test_train_hash_cli_window_runs(tmp_path):
    """``train_hash --steps_per_call 4``: 10 steps as windows 4, 4, 2, the
    grid installed at the first boundary past its warmup, one log a
    crossing of 3."""
    tr = train_hash.main([
        "--synthetic", "--steps", "10", "--num_batch", "32", "--max_res",
        "64", "--num_levels", "3", "--cp_rank", "2", "--num_samples", "8",
        "--compact", "4", "--occ_probes", "4", "--occ_warmup", "2",
        "--update_rate", "2", "--log_every", "3", "--steps_per_call", "4",
        "--device", "cpu", "--out_dir", str(tmp_path), "--model_name", "w"])
    assert tr.state.step == 10 and tr.state.occ is not None
    assert [r["step"] for r in tr.history] == [4, 8, 10]
    assert os.path.exists(tmp_path / "w_ckpt.npz")


def test_time_to_db_window_runs(tmp_path):
    """The record's command, ``--steps_per_call 25 --eval_every 125``, at a
    small size: one gate at step 125, reached in five windows."""
    out = tmp_path / "s.json"
    res = speedrun.main(["--height", "12", "--views", "2", "--batch", "64",
                         "--max_steps", "125", "--eval_every", "125",
                         "--steps_per_call", "25", "--eval_after_train_db",
                         "0", "--target_db", "60", "--device", "cpu",
                         "--out", str(out)], log=lambda s: None)
    assert res["steps"] == 125 and res["crossed"] is None
    assert [e["steps"] for e in res["evals"]] == [125]
    assert np.isfinite(res["evals"][0]["gate_db"])
    assert "25 steps/dispatch" in res["protocol"]
    with open(out) as f:
        assert json.load(f) == res


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A JAX-written run: the small CP model, config, bounds and a ball of
    occupied cells."""
    d = tmp_path_factory.mktemp("fused_run")
    cfg = dataclasses.replace(small_cfg(occupancy=True),
                              mlp=C.MLPConfig(width=32))
    params = jax.tree.map(np.array, jtrainer.init_params(
        jax.random.PRNGKey(0), cfg))
    params["mlp"]["sig"][-1]["b"][0] += 2.0
    g = cfg.render.occupancy_resolution
    c = (np.arange(g) + 0.5) / g * np.sqrt(3.0) * 3.0 - 1.5
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    mask = ((xx ** 2 + yy ** 2 + zz ** 2) < 1.0).astype(np.float32)
    jckpt.save_pytree(str(d / "m_ckpt.npz"), params,
                      extra={"occ_density": mask, "occ_mask": mask,
                             "occ_threshold": np.float32(0.01)})
    C.to_json(cfg, str(d / "m_config.json"))
    jckpt.save_bounds(str(d / "bounds_model.npy"), LO, HI)
    return d


def read_png(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("extra", [[], ["--use_occ", "--eval_guided", "4"]],
                         ids=["ladder", "guided"])
def test_render_cli_fused_writes_eager_frames(run_dir, tmp_path, extra):
    """``render --fused --device cpu`` writes the PNGs that ``render``
    writes without it (a chunk of 24 rays: several chunks a frame)."""
    base = ["--ckpt_dir", str(run_dir), "--model_name", "m", "--height",
            "8", "--width", "8", "--num_samples", "16", "--chunk", "24",
            "--orbit", "2", "--device", "cpu"] + extra
    eager = render.main(base + ["--out_dir", str(tmp_path / "e")])
    fused = render.main(base + ["--fused", "--out_dir", str(tmp_path / "f")])
    assert set(fused) == set(eager) and fused["num_views"] == 2
    for a, b in zip(fused["views"], eager["views"]):
        np.testing.assert_array_equal(read_png(a["path"]),
                                      read_png(b["path"]))


def test_fused_frame_matches_jax_render_image_fused(run_dir):
    """The fused frame (guided, f32, chunks of 24 rays) against JAX's
    ``render_image_fused`` of the same run: the same function on two
    frameworks, atol 1e-5; and equal to ``render_image`` bit for bit."""
    res = restore.restore(str(run_dir), "m", device="cpu", with_occ=True,
                          log_fn=lambda s: None)
    jres = jrestore.restore(str(run_dir), "m", with_occ=True,
                            log_fn=lambda s: None)
    cfg = dataclasses.replace(res.cfg, render=dataclasses.replace(
        res.cfg.render, eval_guided=4))
    jcfg = dataclasses.replace(jres.cfg, render=dataclasses.replace(
        jres.cfg.render, eval_guided=4))
    K = np.array([[10.0, 0, 4.0], [0, 10.0, 4.0], [0, 0, 1]], np.float32)
    c2w = synthetic.orbit_poses(3)[1]
    img = step.render_image_fused(res.field, res.scene, 8, 8, t(K), t(c2w),
                                  cfg, occ=res.occ, num_samples=16,
                                  chunk=24).numpy()
    eager = step.render_image(res.field, res.scene, 8, 8, t(K), t(c2w), cfg,
                              occ=res.occ, num_samples=16, chunk=24).numpy()
    ref = np.asarray(jstep.render_image_fused(
        jres.params, jres.scene, 8, 8, jnp.asarray(K), jnp.asarray(c2w),
        jcfg, occ=jres.occ, num_samples=16, chunk=24))
    assert img.shape == (8, 8, 3) and img.std() > 1e-3
    np.testing.assert_array_equal(img, eager)
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-5)
    poses = synthetic.orbit_poses(3)
    imgs = step.render_poses_fused(res.field, res.scene, 8, 8, t(K),
                                   t(poses), cfg, occ=res.occ,
                                   num_samples=16, chunk=24).numpy()
    jimgs = np.asarray(jstep.render_poses_fused(
        jres.params, jres.scene, 8, 8, jnp.asarray(K), jnp.asarray(poses),
        jcfg, occ=jres.occ, num_samples=16, chunk=24))
    np.testing.assert_allclose(imgs, jimgs, rtol=0, atol=1e-5)


def test_serve_batch_equals_single_frames(run_dir):
    """The server's default (fused) batch of three orbit poses returns the
    frames its single requests return, and ``--no_fused`` the same."""
    def frames(resp):
        return [np.asarray(Image.open(io.BytesIO(base64.b64decode(b)))
                           .convert("RGB"))
                for b in resp.get("images_b64") or [resp["image_b64"]]]

    out = {}
    for flag in ([], ["--no_fused"]):
        server = serve.RenderServer(serve.build_parser().parse_args([
            "--ckpt_dir", str(run_dir), "--model_name", "m", "--use_occ",
            "--height", "8", "--width", "8", "--num_samples", "16",
            "--device", "cpu"] + flag))
        orbit = {"count": 3, "radius": 4.0, "elevation": 0.3}
        batch = server.handle({"batch": True, "orbit": orbit,
                               "eval_guided": 4})
        assert batch["ok"] and batch["frames"] == 3, batch
        singles = [server.handle({"orbit": dict(orbit, index=i),
                                  "eval_guided": 4}) for i in range(3)]
        assert all(r["ok"] for r in singles)
        got = frames(batch)
        for i, r in enumerate(singles):
            np.testing.assert_array_equal(got[i], frames(r)[0])
        out[bool(flag)] = got
        assert server.health()["fused"] is not bool(flag)
    for a, b in zip(out[False], out[True]):
        np.testing.assert_array_equal(a, b)
