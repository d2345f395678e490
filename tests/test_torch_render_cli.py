"""The port's render CLI (cli/render.py) against the JAX one on the CPU.

Both CLIs render the same JAX-written run directory (a small CP model with
an occupancy grid) from each camera source, in f32: the frames agree to
about 1e-6 (tests/test_torch_slice.py holds ``render_image`` to 1e-5), so
the PNGs are held to one uchar level and the per-view PSNR to 1e-3 dB.  The
summaries carry the same keys.  A frame the CLI writes equals
``render_image`` of the same pose and config bit for bit.
"""

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from human_body_reconstruction_tpu.cli import render as jrender
from human_body_reconstruction_tpu.train import checkpoint as jckpt
from human_body_reconstruction_tpu.train import trainer as jtrainer
from human_body_reconstruction_tpu_torch.cli import render
from human_body_reconstruction_tpu_torch.data import synthetic
from human_body_reconstruction_tpu_torch.ops import dense_grid
from human_body_reconstruction_tpu_torch.pipeline import restore
from human_body_reconstruction_tpu_torch.train import step
from human_body_reconstruction_tpu_torch.utils import config as C

H = W = 8
LO = np.array([-1.5, -1.5, -1.5], np.float32)
HI = np.array([1.5, 1.5, 1.5], np.float32)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A JAX-written run: small CP model, config, bounds, a ball of
    occupied cells; and a two-frame transforms.json of its own renders'
    size."""
    d = tmp_path_factory.mktemp("render_run")
    h = C.HashConfig(num_levels=4, n_max=128, variant="cp", cp_rank=8,
                     init_scale=0.5, cp_init_scale=0.6)
    h = dataclasses.replace(h, dense_levels=dense_grid.auto_dense_levels(h))
    cfg = C.PipelineConfig(hash=h, mlp=C.MLPConfig(width=32),
                           render=C.RenderConfig(occupancy=True,
                                                 occupancy_resolution=16))
    params = jax.tree.map(np.array, jtrainer.init_params(
        jax.random.PRNGKey(0), cfg))
    params["mlp"]["sig"][-1]["b"][0] += 2.0
    c = (np.arange(16) + 0.5) / 16 * np.sqrt(3.0) * 3.0 - 1.5
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    mask = ((xx ** 2 + yy ** 2 + zz ** 2) < 1.0).astype(np.float32)
    jckpt.save_pytree(str(d / "m_ckpt.npz"), params,
                      extra={"occ_density": mask, "occ_mask": mask,
                             "occ_threshold": np.float32(0.01)})
    C.to_json(cfg, str(d / "m_config.json"))
    jckpt.save_bounds(str(d / "bounds_model.npy"), LO, HI)
    poses = synthetic.orbit_poses(3, radius=4.0, elevation=0.3)
    np.save(d / "poses.npy", poses)
    rng = np.random.default_rng(0)
    frames = []
    os.makedirs(d / "train", exist_ok=True)
    for i in range(2):
        Image.fromarray((rng.uniform(size=(H, W, 3)) * 255).astype(np.uint8)
                        ).save(d / "train" / f"r_{i}.png")
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": poses[i].tolist()})
    with open(d / "transforms.json", "w") as f:
        json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
    return d


def base_argv(d, out):
    return ["--ckpt_dir", str(d), "--model_name", "m", "--height", str(H),
            "--width", str(W), "--num_samples", "16", "--out_dir", str(out)]


def read_png(path):
    return np.asarray(Image.open(path).convert("RGB")).astype(int)


@pytest.mark.parametrize("source", ["orbit", "poses", "data_path"])
def test_render_cli_matches_jax(run_dir, source, tmp_path):
    cams = {"orbit": ["--orbit", "3", "--stride", "2"],
            "poses": ["--poses", str(run_dir / "poses.npy"), "--max_views",
                      "2", "--use_occ"],
            "data_path": ["--data_path", str(run_dir / "transforms.json")]
            }[source]
    port = render.main(base_argv(run_dir, tmp_path / "port") + cams
                       + ["--device", "cpu"])
    ref = jrender.main(base_argv(run_dir, tmp_path / "jax") + cams)
    assert set(port) == set(ref)
    assert [v["view"] for v in port["views"]] == [v["view"] for v in
                                                  ref["views"]]
    for key in ("num_views", "H", "W", "num_samples", "eval_guided",
                "use_occ"):
        assert port[key] == ref[key]
    for pv, rv in zip(port["views"], ref["views"]):
        assert set(pv) == set(rv)
        got, want = read_png(pv["path"]), read_png(rv["path"])
        assert got.shape == (H, W, 3) and got.std() > 0
        assert np.abs(got - want).max() <= 1
        if "psnr" in rv:
            assert abs(pv["psnr"] - rv["psnr"]) < 1e-3
    with open(tmp_path / "port" / "m_render.json") as f:
        assert json.load(f)["num_views"] == port["num_views"]


def test_render_cli_frame_equals_render_image(run_dir, tmp_path):
    """Guided bf16 frames from the saved grid: frame 0 is ``render_image``
    of pose 0 at the same config, bit for bit after the uint8 cast."""
    argv = base_argv(run_dir, tmp_path) + [
        "--orbit", "2", "--use_occ", "--eval_guided", "8", "--bf16",
        "--device", "cpu"]
    summary = render.main(argv)
    assert summary["use_occ"] and summary["eval_guided"] == 8
    res = restore.restore(str(run_dir), "m", device="cpu", with_occ=True,
                          log_fn=lambda s: None)
    cfg = dataclasses.replace(res.cfg, render=dataclasses.replace(
        res.cfg.render, eval_guided=8))
    args = render.build_parser().parse_args(argv)
    c2ws, K, *_ = render.cameras_from_args(args)
    img = step.render_image(res.field, res.scene, H, W, torch.tensor(K),
                            torch.tensor(c2ws[0]), cfg, occ=res.occ,
                            num_samples=16, bf16=True).numpy()
    want = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(read_png(summary["views"][0]["path"]), want)


def test_render_cli_gif(run_dir, tmp_path):
    summary = render.main(base_argv(run_dir, tmp_path) + [
        "--orbit", "2", "--gif", "--device", "cpu"])
    with Image.open(summary["gif"]) as gif:
        assert gif.n_frames == 2


@pytest.mark.parametrize("extra,match", [
    (["--orbit", "2", "--fused", "--aot_cache", "x"], "--aot_cache"),
    (["--orbit", "2", "--aot_cache", "x"], "--aot_cache"),
    (["--orbit", "2", "--poses", "p.npy"], "exactly one"),
    ([], "exactly one"),
    (["--orbit", "2", "--eval_guided", "8"], "--use_occ"),
    (["--orbit", "2", "--gif"], "Pillow"),
], ids=["fused", "aot_cache", "two_sources", "no_source", "guided_no_occ",
        "gif_without_pil"])
def test_render_cli_refusals(run_dir, extra, match, tmp_path, monkeypatch):
    if "--gif" in extra:
        monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(SystemExit, match=match):
        render.main(base_argv(run_dir, tmp_path) + extra + ["--device", "cpu"])


def test_serve_use_sdf_matches_jax_without_config(tmp_path):
    """A JAX-written SDF run with no config JSON (the flags rebuild it):
    ``cli/serve.py --use_sdf`` serves the same frame as the JAX server, in
    f32, to one uchar level; without the flag the port serves a density
    model, whose frame differs."""
    import base64

    from human_body_reconstruction_tpu.cli import serve as jserve
    from human_body_reconstruction_tpu.utils import config as jC
    from human_body_reconstruction_tpu_torch.cli import serve
    from human_body_reconstruction_tpu_torch.data import png

    cfg = jC.PipelineConfig(
        hash=jC.HashConfig(n_max=64, log2_table_size=8, variant="corner"),
        mlp=jC.MLPConfig(density_activation="sdf"),
        render=jC.RenderConfig(use_sdf=True))
    params = jax.tree.map(np.array, jtrainer.init_params(
        jax.random.PRNGKey(3), cfg))
    params["table"] *= 1e4          # U(-1e-4, 1e-4) -> U(-1, 1): a visible field
    jckpt.save_pytree(str(tmp_path / "s_ckpt.npz"), params)
    jckpt.save_bounds(str(tmp_path / "bounds_model.npy"), LO, HI)
    assert not os.path.exists(tmp_path / "s_config.json")
    argv = ["--ckpt_dir", str(tmp_path), "--model_name", "s", "--max_res",
            "64", "--hash_size", "8", "--height", str(H), "--width", str(W),
            "--num_samples", "16", "--fp32", "--no_fused"]
    req = {"orbit": {"index": 1, "count": 4}}

    def frame(resp):
        assert resp["ok"], resp
        return png.decode_png(base64.b64decode(resp["image_b64"])).astype(int)

    ref = frame(jserve.RenderServer(jserve.build_parser().parse_args(
        argv + ["--use_sdf"])).handle(req))
    sdf = serve.RenderServer(serve.build_parser().parse_args(
        argv + ["--use_sdf", "--device", "cpu"]))
    assert sdf.base_cfg.render.use_sdf
    got = frame(sdf.handle(req))
    assert got.shape == (H, W, 3) and got.std() > 0
    assert np.abs(got - ref).max() <= 1
    density = frame(serve.RenderServer(serve.build_parser().parse_args(
        argv + ["--device", "cpu"])).handle(req))
    assert np.abs(density - ref).max() > 1
