"""Mesh export (counterpart of the JAX pipeline/mesh_export.py): a chunked
density sweep of the field on the device -> marching cubes -> PLY/OBJ.

``density_rgb_grid`` evaluates the field at the R^3 lattice over the scene
bounds, in chunks of ``chunk`` points addressed by their flat start index
(k fastest: grid[i, j, k] is the field at (x_i, y_j, z_k)), with view
direction (0, 0, 1) and the MLP in bf16 compute (the neuralangelo head: its
f and the colour at its six-tap normals, f32).  rgb comes back as uint8
(rounded half to even, as ``jnp.round``) and sigma as float16 clipped to
+-6e4 (the iso level needs ~1e-3 relative precision; an SDF model's
2·sigmoid−1 head keeps its (-1, 1) range to fp16 precision).  The last chunk is
padded to the chunk size, as in JAX, and the points past R^3 are dropped.
Every chunk is launched before any is copied back: device-to-host copies
into pinned buffers, one synchronise.  The ``.npy`` cache holds the JAX
layout, (R, R, R, 4) float32 of (r, g, b, sigma), so either package reads
the other's.  ``export_mesh`` has no ``aot_cache``: the JAX compile cache
is not ported.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.ops import marching_cubes as mc
from human_body_reconstruction_tpu_torch.ops import positional
from human_body_reconstruction_tpu_torch.utils.config import PipelineConfig


def sweep_points(start: int, R: int, chunk: int, lo, span):
    """(chunk, 3) world points of the lattice at flat indices start,
    start + 1, ... (k fastest); ``lo`` and ``span`` (3,) on the device."""
    flat = start + torch.arange(chunk, dtype=torch.int32, device=lo.device)
    ijk = torch.stack([flat // (R * R), (flat // R) % R, flat % R], dim=-1)
    return lo + ijk.to(torch.float32) / (R - 1) * span


def quantise(rgb, sigma):
    """(rgb uint8, sigma float16) as the sweep hands them to the host."""
    rgb8 = torch.clamp(torch.round(rgb * 255.0), 0, 255).to(torch.uint8)
    return rgb8, torch.clamp(sigma, -6.0e4, 6.0e4).to(torch.float16)


def view_encoding(cfg: PipelineConfig, device):
    """The (1, dv) encoding of the sweep's view direction (0, 0, 1)."""
    view = torch.tensor([[0.0, 0.0, 1.0]], device=device)
    return positional.positional_encode(view, cfg.dir_enc.num_freq,
                                        cfg.dir_enc.mode)


@torch.no_grad()
def sweep_chunk(field, scene, cfg: PipelineConfig, start: int, R: int,
                chunk: int):
    """One sweep chunk on the field's device: (rgb8 (chunk, 3), sigma16
    (chunk,))."""
    lo = scene["min_bound"]
    pts = sweep_points(start, R, chunk, lo, scene["max_bound"] - lo)
    if field.mlp.renders:
        return quantise(*field.mlp.sweep(field, scene, pts, cfg))
    dirs_enc = view_encoding(cfg, lo.device)
    rgb, sigma = nerf.field_forward(
        field, scene, pts, dirs_enc.expand(chunk, dirs_enc.shape[-1]), cfg,
        compute_dtype=torch.bfloat16)
    return quantise(rgb, sigma)


@torch.no_grad()
def density_rgb_grid(field, scene, cfg: PipelineConfig, *,
                     resolution: int = 256, chunk: int = 262144,
                     cache_path: Optional[str] = None) -> np.ndarray:
    """(R, R, R, 4) float32 grid of (r, g, b, sigma) over the scene bounds,
    read from ``cache_path`` when it holds one of this resolution."""
    R = resolution
    if cache_path and os.path.exists(cache_path):
        arr = np.load(cache_path)
        if arr.shape == (R,) * 3 + (4,):
            return arr
    device = scene["min_bound"].device
    total = R * R * R
    starts = range(0, total + (-total) % chunk, chunk)
    pin = device.type == "cuda"
    rgb8 = torch.empty((len(starts) * chunk, 3), dtype=torch.uint8,
                       pin_memory=pin)
    sig16 = torch.empty((len(starts) * chunk,), dtype=torch.float16,
                        pin_memory=pin)
    for s in starts:
        c_rgb, c_sig = sweep_chunk(field, scene, cfg, s, R, chunk)
        rgb8[s:s + chunk].copy_(c_rgb, non_blocking=pin)
        sig16[s:s + chunk].copy_(c_sig, non_blocking=pin)
    if pin:
        torch.cuda.synchronize(device)
    rgb = rgb8[:total].numpy().astype(np.float32) / 255.0
    sigma = sig16[:total].numpy().astype(np.float32)
    grid = np.concatenate([rgb, sigma[:, None]], axis=-1).reshape(R, R, R, 4)
    if cache_path:
        np.save(cache_path, grid)
    return grid


def resolve_iso(field: np.ndarray, iso) -> float:
    """A numeric iso passes through; ``"auto"`` takes the midpoint of the
    field's bulk (the median: empty space) and its interior tail (the 0.1th
    percentile), which brackets the surface of a pseudo-SDF whose zero
    level drifted."""
    if not isinstance(iso, str):
        return float(iso)
    if iso != "auto":
        raise ValueError(f"iso must be a number or 'auto', got {iso!r}")
    bulk = float(np.median(field))
    tail = float(np.percentile(field, 0.1))
    if tail == bulk:            # degenerate/untrained field
        return bulk
    level = 0.5 * (bulk + tail)
    print(f"auto iso: bulk {bulk:.4f}, interior tail {tail:.4f} "
          f"-> level {level:.4f}")
    return level


def export_mesh(field, scene, cfg: PipelineConfig, *,
                resolution: int = 256, iso: float = 30.0,
                chunk: int = 262144, cache_path: Optional[str] = None,
                out_path: str = "mesh.ply", color_mode: str = "rgb",
                weld: bool = True, verbose: bool = True) -> dict:
    """Sweep, extract, colour (the field's rgb, or the normalised grid
    coordinate with ``color_mode="xyz"``) and write the mesh.  Returns the
    counts, stage timings and arrays."""
    t0 = time.perf_counter()
    grid = density_rgb_grid(field, scene, cfg, resolution=resolution,
                            chunk=chunk, cache_path=cache_path)
    t_sweep = time.perf_counter() - t0

    t0 = time.perf_counter()
    density = np.ascontiguousarray(grid[..., 3])
    iso = resolve_iso(density, iso)
    verts, faces, keys = mc.marching_cubes(density, iso, return_keys=True)
    if weld:
        verts, faces = mc.weld_vertices(verts, faces, keys=keys)
    t_mc = time.perf_counter() - t0

    if len(verts):
        if color_mode == "xyz":
            colors = verts / (resolution - 1)
        else:
            colors = np.clip(mc.grid_interp(grid[..., :3], verts), 0.0, 1.0)
    else:
        colors = np.zeros((0, 3), np.float32)

    world_verts = mc.verts_to_world(
        verts, scene["min_bound"].cpu().numpy(),
        scene["max_bound"].cpu().numpy(), resolution)
    if out_path.endswith(".obj"):
        mc.write_obj(out_path, world_verts, faces)
    else:
        mc.write_ply(out_path, world_verts, faces, colors)

    stats = {"num_verts": int(len(verts)), "num_faces": int(len(faces)),
             "sweep_seconds": t_sweep, "marching_seconds": t_mc,
             "out_path": out_path, "verts": world_verts, "faces": faces,
             "colors": colors}
    if verbose:
        print(f"density sweep {resolution}^3: {t_sweep:.2f}s; "
              f"marching tets: {t_mc:.2f}s; "
              f"{stats['num_verts']} verts / {stats['num_faces']} faces "
              f"-> {out_path}")
    return stats


def view_mesh(verts, faces, colors=None):
    """An interactive open3d window with the mesh and its wireframe.  Needs
    open3d and a display; raises ImportError without open3d."""
    import open3d as o3d  # optional dependency

    mesh = o3d.geometry.TriangleMesh(
        o3d.utility.Vector3dVector(np.asarray(verts, np.float64)),
        o3d.utility.Vector3iVector(np.asarray(faces, np.int32)))
    if colors is not None and len(colors) == len(verts):
        mesh.vertex_colors = o3d.utility.Vector3dVector(
            np.asarray(colors, np.float64))
    mesh.compute_vertex_normals()
    wire = o3d.geometry.LineSet.create_from_triangle_mesh(mesh)
    o3d.visualization.draw_geometries([mesh, wire])
