"""Mesh export of the port (ops/marching_cubes.py, pipeline/mesh_export.py,
cli/nerf2mesh.py) against the JAX package on the CPU.

The native extractor is the same source built twice, so verts, faces and
edge keys must be identical, and identical after welding; the writers must
give the same bytes.  ``grid_interp`` sums in numpy where JAX sums in XLA:
within 1e-6, so a vertex colour may differ by one uchar level.  The density sweep is held to the JAX sweep at R = 20
on a small CP model: both run the MLP in bf16, the JAX CPU encoder with the
XLA roundings and the port's with the Pallas kernels' (a few bf16 ulps
apart a feature, tests/test_torch_encoders.py), so rgb8 may differ by one
level where a value sits at a rounding boundary, and sigma16 by the bf16
MLP's rounding: 2^-6 of |sigma| plus 2^-6 (a few bf16 ulps of the output).
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu.cli import nerf2mesh as jn2m
from human_body_reconstruction_tpu.ops import marching_cubes as jmc
from human_body_reconstruction_tpu.pipeline import mesh_export as jme
from human_body_reconstruction_tpu.pipeline import restore as jrestore
from human_body_reconstruction_tpu.train import checkpoint as jckpt
from human_body_reconstruction_tpu.train import trainer as jtrainer
from human_body_reconstruction_tpu_torch.cli import nerf2mesh
from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.ops import dense_grid
from human_body_reconstruction_tpu_torch.ops import marching_cubes as mc
from human_body_reconstruction_tpu_torch.pipeline import mesh_export
from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
from human_body_reconstruction_tpu_torch.utils import config as C

LO = np.array([-1.5, -1.2, -1.0], np.float32)
HI = np.array([1.5, 1.3, 1.1], np.float32)
SIGMA_RTOL = SIGMA_ATOL = 2.0 ** -6


def sphere_grid(n=40, r=0.35):
    ax = np.linspace(0, 1, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (r - np.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2 + (Z - 0.5) ** 2)
            ).astype(np.float32)


def noise_grid(shape=(23, 17, 29)):
    return np.random.default_rng(0).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("grid,iso", [(sphere_grid(), 0.0),
                                      (noise_grid(), 0.3)],
                         ids=["sphere", "noise"])
def test_marching_cubes_matches_jax(grid, iso):
    v, f, k = mc.marching_cubes(grid, iso, return_keys=True)
    jv, jf, jk = jmc.marching_cubes(grid, iso, return_keys=True)
    assert len(v) > 100 and f.max() < len(v)
    for a, b in ((v, jv), (f, jf), (k, jk)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for keys in (k, None):
        wv, wf = mc.weld_vertices(v, f, keys=keys)
        jwv, jwf = jmc.weld_vertices(jv, jf, keys=None if keys is None else jk)
        assert len(wv) < len(v)
        np.testing.assert_array_equal(wv, jwv)
        np.testing.assert_array_equal(wf, jwf)


def test_empty_grid_and_library_key():
    v, f = mc.marching_cubes(np.zeros((8, 8, 8), np.float32), 0.5)
    assert len(v) == 0 and len(f) == 0
    assert mc.weld_vertices(v, f)[0] is v
    path = mc.library_path()
    assert path.parent == mc.BUILD_DIR and path.exists()
    assert path.name.startswith("libmarching_")


def test_grid_interp_and_verts_to_world_match_jax():
    rng = np.random.default_rng(1)
    grid = rng.random((7, 9, 11, 3), dtype=np.float32)
    verts = rng.uniform(-0.5, 11.5, (500, 3)).astype(np.float32)
    np.testing.assert_allclose(mc.grid_interp(grid, verts),
                               jmc.grid_interp(grid, verts), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(
        mc.verts_to_world(verts, LO, HI, 20),
        jmc.verts_to_world(verts, LO, HI, 20))


@pytest.mark.parametrize("iso", [30.0, "auto", "flat"])
def test_resolve_iso_matches_jax(iso):
    rng = np.random.default_rng(2)
    field = -0.55 + 0.01 * rng.standard_normal((16, 16, 16))
    field[5:9, 5:9, 5:9] = -0.93
    if iso == "flat":
        field, iso = np.full((4, 4, 4), 2.0), "auto"
    assert mesh_export.resolve_iso(field, iso) == jme.resolve_iso(field, iso)


def test_resolve_iso_refuses_other_strings():
    with pytest.raises(ValueError, match="auto"):
        mesh_export.resolve_iso(np.zeros(3), "otsu")


@pytest.mark.parametrize("fmt", ["ply_rgb", "ply", "obj"])
def test_mesh_files_byte_identical(fmt, tmp_path):
    v, f, k = mc.marching_cubes(sphere_grid(24), 0.0, return_keys=True)
    v, f = mc.weld_vertices(v, f, keys=k)
    v = mc.verts_to_world(v, LO, HI, 24)
    colors = np.random.default_rng(3).random((len(v), 3), dtype=np.float32)
    out, ref = str(tmp_path / f"port.{fmt[:3]}"), str(tmp_path / f"jax.{fmt[:3]}")
    if fmt == "obj":
        mc.write_obj(out, v, f)
        jmc.write_obj(ref, v, f)
    else:
        c = colors if fmt == "ply_rgb" else None
        mc.write_ply(out, v, f, c)
        jmc.write_ply(ref, v, f, c)
    assert os.path.getsize(out) > 1000
    assert filecmp.cmp(out, ref, shallow=False)


def small_cfg() -> C.PipelineConfig:
    h = C.HashConfig(num_levels=4, n_max=128, variant="cp", cp_rank=8,
                     init_scale=0.5, cp_init_scale=0.6)
    h = dataclasses.replace(h, dense_levels=dense_grid.auto_dense_levels(h))
    return C.PipelineConfig(hash=h, mlp=C.MLPConfig(width=32))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A small CP model written by the JAX package: run dir, params, cfg."""
    d = str(tmp_path_factory.mktemp("mesh_run"))
    cfg = small_cfg()
    params = jax.tree.map(np.array, jtrainer.init_params(
        jax.random.PRNGKey(0), cfg))
    for layer in params["mlp"]["sig"]:          # density that varies
        layer["w"] *= 4.0
    params["mlp"]["sig"][-1]["b"][0] += 3.0
    jckpt.save_pytree(os.path.join(d, "m_ckpt.npz"), params)
    C.to_json(cfg, os.path.join(d, "m_config.json"))
    jckpt.save_bounds(os.path.join(d, "bounds_model.npy"), LO, HI)
    return d, params, cfg


@pytest.mark.parametrize("chunk", [8000, 3000], ids=["one_chunk", "padded"])
def test_density_rgb_grid_matches_jax(jax_run, chunk, tmp_path):
    """R = 20 (8000 points): one exact chunk, and chunks of 3000 whose last
    one is padded past R^3.  The cache holds the JAX layout."""
    _, params, cfg = jax_run
    R = 20
    field = ckpt.from_jax_params(params, cfg)
    scene = nerf.scene_from_bounds(LO, HI)
    cache = str(tmp_path / "grid.npy")
    grid = mesh_export.density_rgb_grid(field, scene, cfg, resolution=R,
                                        chunk=chunk, cache_path=cache)
    ref = jme.density_rgb_grid(jax.tree.map(jnp.asarray, params),
                               jrestore.scene_from_bounds(LO, HI), cfg,
                               resolution=R, chunk=chunk)
    assert grid.shape == ref.shape == (R, R, R, 4)
    assert grid.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(np.load(cache), grid)
    rgb8, jrgb8 = (np.rint(g[..., :3] * 255).astype(int) for g in (grid, ref))
    assert np.abs(rgb8 - jrgb8).max() <= 1
    np.testing.assert_allclose(grid[..., 3], ref[..., 3], rtol=SIGMA_RTOL,
                               atol=SIGMA_ATOL)
    assert grid[..., 3].max() > 1.0 and grid[..., 3].std() > 0.1


def test_sweep_points_walk_k_fastest():
    lo, span = torch.tensor(LO), torch.tensor(HI - LO)
    pts = mesh_export.sweep_points(5, 4, 7, lo, span)
    flat = np.arange(5, 12)
    ijk = np.stack([flat // 16, (flat // 4) % 4, flat % 4], -1)
    np.testing.assert_allclose(pts.numpy(), LO + ijk / 3 * (HI - LO),
                               rtol=1e-6)
    rgb8, sig16 = mesh_export.quantise(
        torch.tensor([[0.5 / 255, 1.5 / 255, 2.0]]), torch.tensor([7e4]))
    assert rgb8.tolist() == [[0, 2, 255]] and sig16.item() == 60000.0


def read_ply(path):
    """(header, vertex records, face bytes) of a coloured binary PLY."""
    raw = open(path, "rb").read()
    header, _, body = raw.partition(b"end_header\n")
    n = int(header.split(b"element vertex ")[1].split(b"\n")[0])
    rec = np.frombuffer(body[:15 * n], dtype=[("xyz", "<f4", 3),
                                              ("rgb", "u1", 3)])
    return header, rec, body[15 * n:]


def test_port_cache_exports_the_same_mesh_in_both_clis(jax_run, tmp_path):
    """A density cache written by the port's sweep, exported by the port's
    nerf2mesh and by the JAX one from the same run dir: the same PLY."""
    d, _, _ = jax_run
    cache = str(tmp_path / "cache.npy")
    common = ["--ckpt_dir", d, "--model_name", "m", "--bound_pth",
              os.path.join(d, "bounds_model.npy"), "--resolution", "20",
              "--iso", "3.0", "--cache", cache]
    stats = nerf2mesh.main(common + ["--out", str(tmp_path / "port.ply"),
                                     "--device", "cpu"])
    assert os.path.exists(cache) and stats["num_faces"] > 50
    jn2m.main(common + ["--out", str(tmp_path / "jax.ply")])
    port, ref = (read_ply(tmp_path / f"{n}.ply") for n in ("port", "jax"))
    assert port[0] == ref[0]                     # header: the counts
    np.testing.assert_array_equal(port[1]["xyz"], ref[1]["xyz"])
    assert port[2] == ref[2]                     # the faces' bytes
    # colours: grid_interp's f32 sums in numpy and in XLA differ by ~2e-7,
    # which can move a colour across a uchar boundary
    assert np.abs(port[1]["rgb"].astype(int) - ref[1]["rgb"]).max() <= 1
    lo, hi = stats["verts"].min(0), stats["verts"].max(0)
    assert (lo >= LO - 1e-5).all() and (hi <= HI + 1e-5).all()


@pytest.mark.parametrize("flag,match", [
    (["--aot_cache", "x"], "--aot_cache is not ported")],
    ids=["aot_cache"])
def test_nerf2mesh_refusals(flag, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        nerf2mesh.main(["--ckpt_dir", str(tmp_path), "--device", "cpu"] + flag)
