"""The TPU's own trained SDF weights in the port, and the SDF and
hierarchical paths through the port's CLIs, against the JAX package on the
CPU (tests/test_torch_sdf.py holds the modules themselves)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu.train import checkpoint as jckpt
from human_body_reconstruction_tpu.train import step as jstep
from human_body_reconstruction_tpu.train import trainer as jtrainer
from human_body_reconstruction_tpu.pipeline import restore as jrestore
from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
from human_body_reconstruction_tpu_torch.train import step
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def npz_path(mode):
    return os.path.join(REPO, f"qm_params_{mode}.npz")


@pytest.mark.parametrize("mode", ["cp_r21_sdf_guided_es16k",
                                  "cp_r21_sdf_guided_xla_es16k"])
def test_tpu_trained_weights_render_as_in_jax(mode):
    """The TPU's trained SDF weights, loaded into JAX (``load_pytree``) and
    into the port, render 256 rays of each holdout pose at 128 samples the
    same way in f32 (the mode's config with ``dense_bf16`` off): the scene
    is the protocol's (20 training views, 400x400), 21 parameter leaves, the
    sharpness the last and 0-d.  Measured: 99% of the colours within
    5.6e-6, the largest 1.06e-5 (the top pose of the es16k weights, whose
    field is the sharper of the two): atol 2e-5."""
    from human_body_reconstruction_tpu.ops import dense_grid as jdense
    from human_body_reconstruction_tpu.ops import rays as jrays
    from human_body_reconstruction_tpu.utils import config as jC
    from human_body_reconstruction_tpu_torch.cli import quality_holdout as qh
    from human_body_reconstruction_tpu_torch.ops import rays as prays
    from test_torch_quality import QM

    cfg = qh.make_modes()[mode]
    cfg = dataclasses.replace(cfg, hash=dataclasses.replace(
        cfg.hash, dense_bf16=False))
    jcfg = QM.make_modes(jC, jdense)[mode]
    jcfg = dataclasses.replace(jcfg, hash=dataclasses.replace(
        jcfg.hash, dense_bf16=False, cp_impl="xla", dense_impl="xla"))
    template = jtrainer.init_params(jax.random.PRNGKey(0), jcfg)
    jp, _ = jckpt.load_pytree(npz_path(mode), template)
    with np.load(npz_path(mode)) as data:
        assert "leaf_21" not in data and data["leaf_20"].shape == ()
    field = ckpt.load_params(npz_path(mode), nerf.Field(cfg))
    assert float(field.var_b.detach()) == float(jp["var"]["b"]) != 0.5
    H = 400
    train, hold = qh.protocol_poses(20)
    K = np.array([[1.1 * H, 0, H / 2], [0, 1.1 * H, H / 2], [0, 0, 1]],
                 np.float32)
    lo, hi = prays.scene_bounds(H, H, torch.tensor(K), torch.tensor(train),
                                2.0, 6.0)
    jlo, jhi = jrays.scene_bounds(H, H, jnp.asarray(K), jnp.asarray(train),
                                  2.0, 6.0)
    np.testing.assert_allclose(lo.numpy(), np.asarray(jlo), atol=1e-6)
    np.testing.assert_allclose(hi.numpy(), np.asarray(jhi), atol=1e-6)
    scene = nerf.scene_from_bounds(lo, hi)
    jscene = jrestore.scene_from_bounds(np.asarray(jlo), np.asarray(jhi))
    pix = np.random.default_rng(3).choice(H * H, 256, replace=False)
    eval_cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, occupancy=False, compact_samples=0, occ_guided=False))
    jeval = dataclasses.replace(jcfg, render=dataclasses.replace(
        jcfg.render, occupancy=False, compact_samples=0, occ_guided=False))
    for pose in hold:
        o, d, n = (a.reshape(-1, a.shape[-1])[pix] for a in
                   prays.full_image_rays(H, H, torch.tensor(K),
                                         torch.tensor(pose)))
        img = step.render_chunk(field, scene, o, d, n, eval_cfg,
                                num_samples=128).numpy()
        ref = np.asarray(jstep.render_chunk(
            jp, jscene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
            jnp.asarray(n.numpy()), jax.random.PRNGKey(0), cfg=jeval,
            num_samples=128))
        assert img.std() > 0.05
        np.testing.assert_allclose(img, ref, rtol=0, atol=2e-5)


@pytest.fixture(scope="module")
def sdf_run(tmp_path_factory):
    """A run directory of a tiny SDF + hierarchical model, written by the
    port's CLI in 3 steps."""
    from human_body_reconstruction_tpu_torch.cli import train_hash

    d = str(tmp_path_factory.mktemp("sdf_run"))
    train_hash.main([
        "--synthetic", "--steps", "3", "--num_batch", "32", "--max_res", "64",
        "--num_levels", "3", "--cp_rank", "2", "--num_samples", "8",
        "--no_occupancy", "--use_sdf", "--hierarchical", "--eikonal_subsample",
        "64", "--log_every", "1", "--device", "cpu", "--out_dir", d,
        "--model_name", "s"])
    return d


def test_cli_trains_sdf_hierarchical_and_renders(sdf_run, tmp_path):
    """``train_hash --use_sdf --hierarchical`` trains the sharpness and
    restores with it; the render CLI's ``--hierarchical`` frame equals
    ``render_image(hierarchical=True)``, and differs from the first pass
    alone."""
    from human_body_reconstruction_tpu_torch.cli import render
    from human_body_reconstruction_tpu_torch.pipeline import restore

    res = restore.restore(sdf_run, "s", device="cpu", hierarchical=True,
                          log_fn=lambda s: None)
    assert res.cfg.render.use_sdf and res.cfg.render.hierarchical
    assert res.field.var_b is not None and float(res.field.var_b.detach()) != 0.5
    summary = render.main([
        "--ckpt_dir", sdf_run, "--model_name", "s", "--orbit", "1",
        "--height", "12", "--width", "12", "--num_samples", "8",
        "--hierarchical", "--use_sdf", "--out_dir", str(tmp_path),
        "--device", "cpu"])
    from test_torch_render_cli import read_png

    got = read_png(summary["views"][0]["path"])
    args = render.build_parser().parse_args([
        "--orbit", "1", "--height", "12", "--width", "12"])
    c2ws, K, H, W, _ = render.cameras_from_args(args)
    imgs = [step.render_image(res.field, res.scene, H, W, torch.tensor(K),
                              torch.tensor(c2ws[0]), res.cfg, num_samples=8,
                              hierarchical=h).numpy() for h in (True, False)]
    want = (np.clip(imgs[0], 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    assert np.abs(imgs[0] - imgs[1]).max() > 0


def test_nerf2mesh_sdf_run_matches_jax(sdf_run, tmp_path):
    """``nerf2mesh --use_sdf --hierarchical`` on the SDF run directory: the
    port's sweep of the 2*sigmoid-1 head and its mesh at a level inside the
    field's range, against the JAX CLI on the same directory (the sweep
    runs the MLP in bf16 on both sides: the vertex counts within 2%)."""
    from human_body_reconstruction_tpu.cli import nerf2mesh as jn2m
    from human_body_reconstruction_tpu_torch.cli import nerf2mesh

    cache = str(tmp_path / "cache.npy")
    common = ["--ckpt_dir", sdf_run, "--model_name", "s", "--resolution",
              "24", "--use_sdf", "--hierarchical"]
    nerf2mesh.main(common + ["--iso", "0", "--cache", cache, "--out",
                             str(tmp_path / "probe.ply"), "--device", "cpu"])
    sigma = np.load(cache)[..., 3]
    assert -1.0 <= sigma.min() < sigma.max() <= 1.0
    level = float(np.round(0.5 * (np.median(sigma) + sigma.min()), 3))
    stats = nerf2mesh.main(common + ["--iso", str(level), "--cache", "",
                                     "--out", str(tmp_path / "port.ply"),
                                     "--device", "cpu"])
    jn2m.main(common + ["--iso", str(level), "--cache", "", "--out",
                        str(tmp_path / "jax.ply")])
    with open(tmp_path / "jax.ply", "rb") as f:
        head = f.read(400).decode("latin-1")
    n_jax = int(head.split("element vertex ")[1].split()[0])
    assert stats["num_verts"] > 20
    assert abs(stats["num_verts"] - n_jax) <= 0.02 * n_jax
