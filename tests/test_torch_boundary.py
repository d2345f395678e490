"""The port stands alone: it imports nothing of the JAX package, and what it
copied from there (the config dataclasses and their JSON round trip, the
trainer's flag surface and preset resolution, the dataset reader, the
native marching-cubes source and the pose math, the quality protocol's
constants and the render, mesh-export, capture, segmentation and
reconstruct flags) agrees with the original.  Its entry points run on the card unless given
``--device cpu``.  Test names avoid the words that tests/conftest.py marks
slow.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu.cli import train_hash as jcli
from human_body_reconstruction_tpu.data import datasets as jdatasets
from human_body_reconstruction_tpu.utils import config as jC
from human_body_reconstruction_tpu_torch.cli import (
    colmap2nerf, image_fit, nerf2mesh, occ_report, plot_psnr, quality_holdout,
    reconstruct, render, segment, serve, train_hash, train_vanilla)
from human_body_reconstruction_tpu_torch.data import datasets
from human_body_reconstruction_tpu_torch.utils import config as C

import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTIONS = ("HashConfig", "PosEncConfig", "MLPConfig", "RenderConfig",
            "TrainConfig", "ClassicNeRFConfig", "PipelineConfig")
HASH_ARGV = ["--stochastic", "--hw_rng"]
PRESET_ARGVS = [[], ["--stochastic"], HASH_ARGV,
                ["--encoder_variant", "corner"], ["--preset", "reference"],
                ["--num_levels", "8", "--max_res", "512", "--num_samples", "32",
                 "--occupancy", "--compact", "16", "--cp_rank", "4",
                 "--dense_levels", "2", "--occ_probes", "8", "--cp_tv", "0.1",
                 "--cp_tv_warmup", "7", "--eikonal_subsample", "9",
                 "--no_occ_stratified"]]


# The port's own choices of a JAX flag: (cli, dest) -> the added choices.
PORT_CHOICES = {("train_hash", "preset"): ("neuralangelo",)}


def _props(obj) -> dict:
    return {name: getattr(obj, name) for name, v in vars(type(obj)).items()
            if isinstance(v, property)}


@pytest.mark.parametrize("name", SECTIONS)
def test_config_dataclasses_match_jax(name):
    """Field names, types and defaults, and every property's value, of each
    dataclass at its defaults (and the flagship's sections)."""
    port, ref = getattr(C, name), getattr(jC, name)
    fields = [(f.name, str(f.type)) for f in dataclasses.fields(port)]
    n = len(dataclasses.fields(ref))
    assert fields[:n] == [(f.name, str(f.type))
                          for f in dataclasses.fields(ref)]
    assert tuple(k for k, _ in fields[n:]) == \
        port_config.PORT_FIELDS.get(name, ())
    assert port_config.jax_part(name, dataclasses.asdict(port())) == \
        dataclasses.asdict(ref())
    assert _props(port()) == _props(ref())
    assert port.__dataclass_params__.frozen and ref.__dataclass_params__.frozen
    if name == "PipelineConfig":
        flag = C.flagship_config()
        jflag = jcli.make_config(jcli.build_parser().parse_args([]))
        assert port_config.jax_part(name, dataclasses.asdict(flag)) == \
            dataclasses.asdict(jflag)
        assert _props(flag.hash) == _props(jflag.hash)


@pytest.mark.parametrize("argv", [[], HASH_ARGV], ids=["flagship", "hash"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_config_json_round_trips_across_packages(argv, writer, tmp_path):
    """A config JSON written by either package reads back equal in the
    other (and in itself)."""
    path = str(tmp_path / "c.json")
    port_cfg = train_hash.make_config(train_hash.build_parser().parse_args(argv))
    jax_cfg = jcli.make_config(jcli.build_parser().parse_args(argv))
    (C if writer == "port" else jC).to_json(
        port_cfg if writer == "port" else jax_cfg, path)
    for mod, cfg in ((C, port_cfg), (jC, jax_cfg)):
        back = mod.from_json(path)
        assert type(back) is type(cfg) and back == cfg
    with open(path) as f:
        assert set(json.load(f)) == {"hash", "dir_enc", "mlp", "render",
                                     "train"}


@pytest.mark.parametrize("bad", [
    dict(hash=dict(variant="cp", stochastic_train=True)),
    dict(hash=dict(variant="cp", packed=True)),
    dict(hash=dict(grad_level_subsample=True)),
    dict(hash=dict(packed=True, pack_format="int8", grad_subsample=True,
                   grad_level_pair=True, num_levels=5)),
    dict(hash=dict(packed=True, pack_format="int8", grad_subsample=True,
                   grad_level_pair=True, grad_level_subsample=True)),
    dict(hash=dict(grad_level_pair=True)),
    dict(hash=dict(packed_exact_train=True)),
    dict(hash=dict(scatter_strategy="bitonic")),
    dict(train=dict(cp_tv_weight=0.1))])
def test_config_post_init_errors_match_jax(bad):
    """The same ValueError (message and all) from ``__post_init__``."""
    def build(mod):
        h = mod.HashConfig(**bad.get("hash", {}))
        return mod.PipelineConfig(hash=h,
                                  train=mod.TrainConfig(**bad.get("train", {})))

    with pytest.raises(ValueError) as ref:
        build(jC)
    with pytest.raises(ValueError) as port:
        build(C)
    assert str(port.value) == str(ref.value)


# Each CLI of both packages: the port's module, its flags beyond JAX's
# (--device, default cuda, on the CLIs that use the card), and the flags it
# takes and refuses by name, each with an argv that sets it (render's
# --aot_cache beside --fused, which JAX refuses as a pair).
PARSER_CLIS = {
    "train_hash": (train_hash, {"device"},
                   {"aot_cache": ["--aot_cache", "x"]}),
    "train_vanilla": (train_vanilla, {"device"}, {}),
    "image_fit": (image_fit, {"device"}, {}),
    "plot_psnr": (plot_psnr, {"device"}, {}),
    "serve": (serve, {"device"}, {"aot_cache": ["--aot_cache", "x"]}),
    "render": (render, {"device"}, {"aot_cache": ["--fused", "--aot_cache",
                                                  "x"]}),
    "nerf2mesh": (nerf2mesh, {"device"}, {"aot_cache": ["--aot_cache", "x"]}),
    "reconstruct": (reconstruct, {"device"}, {}),
    "colmap2nerf": (colmap2nerf, set(), {}),
    "segment": (segment, set(), {}),
}


@pytest.mark.parametrize("cli", sorted(PARSER_CLIS))
def test_parsers_match_jax(cli):
    """Every flag of the JAX CLI, with the same default, type, choices,
    action and nargs; the port adds only --device (default cuda) where it
    uses the card, and each flag it refuses stops it before any work with a
    message naming the flag."""
    import importlib

    def flags(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         tuple(a.choices or ()), type(a).__name__, a.nargs)
                for a in p._actions if a.dest != "help"}

    mod, extra, refused = PARSER_CLIS[cli]
    ref = flags(importlib.import_module(
        f"human_body_reconstruction_tpu.cli.{cli}").build_parser())
    port = flags(mod.build_parser())
    assert set(port) - set(ref) == extra
    for (c, dest), added in PORT_CHOICES.items():
        if c == cli:
            opts, default, typ, choices, kind, nargs = port[dest]
            assert choices[len(choices) - len(added):] == added
            port[dest] = (opts, default, typ, choices[:-len(added)], kind,
                          nargs)
    assert {k: port[k] for k in ref} == ref
    if extra:
        assert port["device"][1] == "cuda"
    for flag, argv in refused.items():
        args = mod.build_parser().parse_args(argv)
        with pytest.raises(SystemExit, match=f"--{flag}"):
            if cli == "train_hash":
                mod.check_supported(args, mod.make_config(args))
            else:
                mod.check_supported(args)


@pytest.mark.parametrize("argv", PRESET_ARGVS,
                         ids=["zero", "stochastic", "stochastic_hw_rng",
                              "corner", "reference", "overrides"])
def test_resolve_preset_matches_jax(argv):
    port = train_hash.resolve_preset(train_hash.build_parser().parse_args(argv))
    ref = jcli.resolve_preset(jcli.build_parser().parse_args(argv))
    assert port == ref


def test_hash_flags_resolve_to_reference_hash_grid():
    """``--stochastic --hw_rng`` trains the reference repo's own model: the
    corner hash grid, L 16, F 2, T 2^16, n_max 2048, no dense levels, 64
    samples, no occupancy grid, 16,000 rays a step."""
    args = train_hash.build_parser().parse_args(HASH_ARGV)
    cfg = train_hash.make_config(args)
    h = cfg.hash
    assert (h.variant, h.num_levels, h.features_per_level, h.table_size,
            h.n_max, h.dense_levels, h.stochastic_train, h.hw_rng) == \
        ("corner", 16, 2, 2 ** 16, 2048, 0, True, True)
    assert (cfg.render.num_samples, cfg.render.occupancy,
            cfg.train.ray_batch, cfg.train.cp_tv_weight) == (64, False, 16000, 0.0)
    train_hash.check_supported(args, cfg)


def _write_dataset(root, fmt: str):
    from PIL import Image

    rng = np.random.default_rng(0)
    frames = []
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    for i in range(3):
        img = (rng.uniform(size=(6, 8, 4)) * 255).astype(np.uint8)
        Image.fromarray(img, "RGBA").save(os.path.join(root, "train",
                                                       f"r_{i}.png"))
        frames.append({"file_path": f"./train/r_{i}" if fmt == "blender"
                       else f"train/r_{i}.png",
                       "transform_matrix": rng.normal(size=(4, 4)).tolist(),
                       "rotation": 0.1 * i})
    meta = {"frames": frames}
    if fmt == "blender":
        meta["camera_angle_x"] = 0.69
    else:
        meta.update(fl_x=5.0, fl_y=6.0, cx=4.0, cy=3.0, w=8, h=6)
    path = os.path.join(root, "transforms.json")
    with open(path, "w") as f:
        json.dump(meta, f)
    return path


@pytest.mark.parametrize("fmt", ["blender", "ngp"])
@pytest.mark.parametrize("white,down", [(False, 1), (True, 2)])
def test_load_nerf_json_matches_jax(tmp_path, fmt, white, down):
    path = _write_dataset(str(tmp_path), fmt)
    port = datasets.load_nerf_json(path, white_background=white,
                                   downscale=down, max_frames=2)
    ref = jdatasets.load_nerf_json(path, white_background=white,
                                   downscale=down, max_frames=2)
    assert set(port) == set(ref)
    for k in port:
        np.testing.assert_array_equal(np.asarray(port[k]), np.asarray(ref[k]))
    dev = datasets.to_device(port, "cpu")
    assert dev["images"].dtype == torch.float32 and dev["K"].shape == (3, 3)


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch, tmp_path):
    """Without a card, train_hash, serve, train_vanilla, image_fit and
    plot_psnr exit with a message naming --device cpu; with it they run on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train_hash.main(["--synthetic", "--steps", "1"])
    with pytest.raises(SystemExit, match="--device cpu"):
        train_vanilla.main(["--synthetic", "--num_iters", "1"])
    with pytest.raises(SystemExit, match="--device cpu"):
        image_fit.main(["--synthetic", "--steps", "1"])
    with pytest.raises(SystemExit, match="--device cpu"):
        plot_psnr.main(["--pred_dirs", str(tmp_path), "--gt_dirs",
                        str(tmp_path)])
    out = str(tmp_path / "cpu")
    res = image_fit.main(["--synthetic", "--steps", "1", "--batch", "64",
                          "--hash_size", "8", "--levels", "2", "--n_max",
                          "32", "--out_dir", out, "--device", "cpu"])
    assert res["steps"] == 1 and os.path.exists(f"{out}/imagefit_final.png")
    with pytest.raises(SystemExit, match="--device cpu"):
        serve.RenderServer(serve.build_parser().parse_args(
            ["--ckpt_dir", str(tmp_path)]))
    assert serve.build_parser().parse_args([]).device == "cuda"
    assert train_hash.build_parser().parse_args([]).device == "cuda"


def test_port_imports_nothing_of_the_jax_package():
    """In a fresh interpreter whose import system refuses jax, jaxlib and
    human_body_reconstruction_tpu (and their submodules), every module of
    the port and chip_smoke.py import."""
    code = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys

        BANNED = ("jax", "jaxlib", "human_body_reconstruction_tpu")

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BANNED):
                    raise ImportError(f"the port imported {{name}}")
                return None

        sys.meta_path.insert(0, Refuse())
        for b in BANNED:
            assert not any(m == b or m.startswith(b + ".") for m in sys.modules)
        import human_body_reconstruction_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        assert {{pkg.__name__ + ".parallel." + m for m in (
            "comm", "data_parallel", "level_parallel", "sample_parallel",
            "multi_scene", "dryrun")}} <= set(names), names
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", {os.path.join(REPO, "chip_smoke.py")!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        print("imported", len(names), "modules and chip_smoke")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(proc.stdout.split()[1])
    assert n >= 25, proc.stdout


def _read(pkg, path):
    with open(os.path.join(REPO, pkg, path), "rb") as f:
        return f.read()


def test_native_marching_source_is_a_copy():
    """native/marching.cpp byte for byte the JAX package's."""
    path = os.path.join("native", "marching.cpp")
    assert _read("human_body_reconstruction_tpu_torch", path) == _read(
        "human_body_reconstruction_tpu", path)


def test_pose_math_is_a_copy():
    """pipeline/poses.py (numpy only) byte for byte the JAX package's."""
    path = os.path.join("pipeline", "poses.py")
    assert _read("human_body_reconstruction_tpu_torch", path) == _read(
        "human_body_reconstruction_tpu", path)


def test_quality_constants_match_jax():
    """The holdout eyes, their names and the scenes of
    scripts/quality_matrix.py, the held-back tangle's included."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "quality_matrix", os.path.join(REPO, "scripts", "quality_matrix.py"))
    qm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qm)
    assert quality_holdout.HOLDOUT_EYES == qm.HOLDOUT_EYES
    assert quality_holdout.HOLDOUT_NAMES == qm.HOLDOUT_NAMES
    assert quality_holdout.SCENES == qm.SCENES
    assert quality_holdout.SCENES["tangle"] == "tangle_field"


@pytest.mark.parametrize("cli", ["render", "nerf2mesh", "colmap2nerf",
                                 "segment", "reconstruct"])
def test_render_and_mesh_flags_match_jax(cli):
    """The JAX CLI's flags, with the same defaults, types and choices; the
    port adds only --device (default cuda), and the capture front end's
    CLIs (colmap2nerf, segment), which use no card, not even that."""
    import importlib

    ref = importlib.import_module(
        f"human_body_reconstruction_tpu.cli.{cli}").build_parser()
    port = {"render": render, "nerf2mesh": nerf2mesh,
            "colmap2nerf": colmap2nerf, "segment": segment,
            "reconstruct": reconstruct}[cli].build_parser()

    def flags(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         tuple(a.choices or ()), type(a).__name__)
                for a in p._actions if a.dest != "help"}

    got, want = flags(port), flags(ref)
    if cli in ("colmap2nerf", "segment"):
        assert got == want
        return
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want
    assert got["device"][1] == "cuda"


@pytest.mark.parametrize("cli", ["quality_holdout", "render", "nerf2mesh",
                                 "occ_report", "reconstruct"])
def test_new_entry_points_need_a_card(cli, monkeypatch, tmp_path):
    """Without a card the new CLIs exit with a message naming --device
    cpu; each defaults to the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"quality_holdout": quality_holdout, "render": render,
           "nerf2mesh": nerf2mesh, "occ_report": occ_report,
           "reconstruct": reconstruct}[cli]
    argv = {"quality_holdout": ["--out", str(tmp_path / "q.json")],
            "render": ["--orbit", "1", "--out_dir", str(tmp_path)],
            "nerf2mesh": ["--ckpt_dir", str(tmp_path)],
            "occ_report": ["--run_dir", str(tmp_path)],
            "reconstruct": ["--workdir", str(tmp_path / "w"),
                            "--skip_poses"]}[cli]
    assert mod.build_parser().parse_args(argv).device == "cuda"
    with pytest.raises(SystemExit, match="--device cpu"):
        mod.main(argv)
