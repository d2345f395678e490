"""PyTorch port vs the JAX package: the one-command ``reconstruct`` CLI on
the CPU.

The argv each package's ``reconstruct`` hands its ``train_hash`` and
``nerf2mesh`` (both packages' ``main`` replaced by recorders, so nothing
trains) are equal but for the port's ``--device``; a tiny run of the port
(40x40 PNG capture, 120 steps, as tests/test_reconstruct.py runs the JAX
one) goes through segmentation, training and mesh export after
``--skip_poses`` with cv2 and Pillow refused, as on the card's machine.
Test names avoid the words that tests/conftest.py marks slow.
"""

import json
import os
import sys

import numpy as np
import pytest

from human_body_reconstruction_tpu.cli import nerf2mesh as jnerf2mesh
from human_body_reconstruction_tpu.cli import reconstruct as jreconstruct
from human_body_reconstruction_tpu.cli import train_hash as jtrain_hash
from human_body_reconstruction_tpu.data import datasets as jdatasets
from human_body_reconstruction_tpu_torch.cli import nerf2mesh, reconstruct
from human_body_reconstruction_tpu_torch.cli import train_hash
from human_body_reconstruction_tpu_torch.data import datasets, png, synthetic
from torch_threads import one_torch_thread  # noqa: F401


def write_capture(workdir, n=5, H=40, W=40):
    """A synthetic capture as PNG frames and a transforms.json (the port's
    encoder: no Pillow needed).  Returns the uint8 frames."""
    ds = synthetic.make_dataset(n_views=n, H=H, W=W)
    os.makedirs(os.path.join(workdir, "images"), exist_ok=True)
    frames, imgs = [], []
    for k in range(n):
        name = f"{k:04d}.png"
        img = (ds["images"][k].numpy() * 255).astype(np.uint8)
        png.write_png(os.path.join(workdir, "images", name), img)
        imgs.append(img)
        frames.append({"file_path": f"./images/{name}",
                       "transform_matrix": ds["c2ws"][k].tolist(),
                       "sharpness": 10.0})
    K = ds["K"].numpy()
    meta = {"camera_angle_x": float(2 * np.arctan(W / (2 * K[0, 0]))),
            "fl_x": float(K[0, 0]), "fl_y": float(K[1, 1]),
            "cx": float(K[0, 2]), "cy": float(K[1, 2]), "w": W, "h": H,
            "frames": frames}
    with open(os.path.join(workdir, "transforms.json"), "w") as f:
        json.dump(meta, f)
    return imgs


@pytest.mark.parametrize("extra", [
    [], ["--stochastic", "--packed", "--occupancy"],
    ["--segment_backend", "none", "--normalization", "unit_box", "--iso", "7",
     "--resolution", "64", "--steps", "9", "--num_batch", "128", "--near",
     "1.5", "--far", "5"]], ids=["defaults", "hash_flags", "overrides"])
def test_stage_argv_matches_jax(extra, tmp_path, monkeypatch):
    """Each package's reconstruct, stages replaced by recorders, from the
    same relative work directory: the same argv for training and meshing,
    the port's followed by --device."""
    calls = {}
    for pkg, mods in (("jax", (jtrain_hash, jnerf2mesh)),
                      ("port", (train_hash, nerf2mesh))):
        for mod in mods:
            monkeypatch.setattr(mod, "main", lambda argv, pkg=pkg, mod=mod:
                                calls.setdefault(pkg, []).append(list(argv)))
    argv = ["--workdir", "run", "--skip_poses", "--segment_backend",
            "threshold"] + extra
    for pkg, mod, dev in (("jax", jreconstruct, []),
                          ("port", reconstruct, ["--device", "cpu"])):
        os.makedirs(tmp_path / pkg)
        monkeypatch.chdir(tmp_path / pkg)
        write_capture("run", n=2, H=8, W=8)
        mod.main(argv + dev)
    assert len(calls["jax"]) == len(calls["port"]) == 2
    for ref, got in zip(calls["jax"], calls["port"]):
        assert got == ref + ["--device", "cpu"]
    assert calls["jax"][0][:2] == ["--data_path", "run"]


def test_reconstruct_segment_train_mesh_without_cv2_or_pillow(
        tmp_path, monkeypatch):
    """All four stages after --skip_poses at 40x40 and 120 steps, as the
    JAX package's test runs them, with cv2 and Pillow refused: the masked
    frames, the masked transforms, the checkpoint and a mesh inside the
    run's bounds.  So ``train_hash --data_path`` read a PNG dataset without
    Pillow; the frames it read equal JAX's reader's (Pillow) on the same
    files."""
    imgs = write_capture(str(tmp_path / "run"))
    monkeypatch.chdir(tmp_path)
    for name in ("cv2", "PIL"):
        monkeypatch.setitem(sys.modules, name, None)
    out = reconstruct.main([
        "--workdir", "run", "--skip_poses", "--segment_backend", "threshold",
        "--steps", "120", "--num_batch", "512", "--num_samples", "16",
        "--near", "2.0", "--far", "6.0", "--iso", "0.5", "--resolution", "40",
        "--device", "cpu"])
    monkeypatch.undo()
    work = tmp_path / "run"
    assert set(out["seconds"]) == {"segment", "train", "mesh"}
    masked = png.read_png(str(work / "SegmentedImages" / "THRESHOLD"
                              / "0000.png"))
    assert masked.shape == imgs[0].shape
    assert (masked == imgs[0]).any() and (masked == 0).any()
    assert (work / "transforms_masked.json").exists()
    assert (work / "results" / "recon_ckpt.npz").exists()
    assert out["trainer"].history[-1]["psnr"] > 20.0   # logged at step 100
    mesh = out["mesh"]
    assert mesh["num_verts"] > 0 and os.path.getsize(work / "mesh.ply") > 100
    lo, hi = np.load(work / "results" / "bounds_model.npy")
    assert (mesh["verts"] >= lo - 1e-5).all() and (mesh["verts"] <= hi + 1e-5).all()
    path = str(work / "transforms_train.json")
    port = datasets.load_nerf_json(path)
    ref = jdatasets.load_nerf_json(path)
    for k in port:
        np.testing.assert_array_equal(np.asarray(port[k]), np.asarray(ref[k]))

