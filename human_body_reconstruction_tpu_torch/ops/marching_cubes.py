"""Iso-surface extraction (counterpart of the JAX ops/marching_cubes.py):
the ctypes bridge to the native C++ marching-tetrahedra extension,
trilinear colour sampling of a grid, and the mesh file writers.

``native/marching.cpp`` is a byte-for-byte copy of the JAX package's
(tests/test_torch_boundary.py holds it equal).  It is built with ``g++`` at
first use into ``human_body_reconstruction_tpu_torch/build/`` (git-ignored)
under a name keyed on a hash of the source, so a checkout builds exactly
what it holds; nothing is built at import time.  ``grid_interp`` is numpy
where the JAX module uses jnp; everything else computes what the JAX module
computes, to the same arrays and file bytes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "native" / "marching.cpp"
BUILD_DIR = PKG_DIR / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    """The shared object's path, keyed on the source and the flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmarching_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile native/marching.cpp unless this exact source is built
    already; a temporary name and a rename keep concurrent builds apart."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded extension (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    lib.mc_extract.restype = ctypes.c_int64
    lib.mc_extract.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
    ]
    lib.mc_free.restype = None
    lib.mc_free.argtypes = [ctypes.c_void_p]
    return lib


def marching_cubes(density: np.ndarray, iso: float, return_keys: bool = False):
    """Extract the iso-surface of a (nx, ny, nz) float32 density grid.

    Returns (verts (V, 3) float32 in grid-index coordinates, faces (F, 3)
    int32), the vertices unwelded (one per triangle corner); with
    ``return_keys`` also the (V,) int64 canonical grid-edge id of each
    vertex, which ``weld_vertices`` dedups on."""
    lib = library()
    density = np.ascontiguousarray(density, np.float32)
    if density.ndim != 3:
        raise ValueError(f"density must be (nx, ny, nz), got {density.shape}")
    nx, ny, nz = density.shape
    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int32)()
    keys_p = ctypes.POINTER(ctypes.c_int64)()
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    rc = lib.mc_extract(
        density.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nx, ny, nz, float(iso),
        ctypes.byref(verts_p), ctypes.byref(nv),
        ctypes.byref(tris_p), ctypes.byref(nt),
        ctypes.byref(keys_p))
    if rc != 0:
        raise RuntimeError(f"mc_extract failed with code {rc}")
    try:
        verts = np.ctypeslib.as_array(verts_p, (nv.value, 3)).copy()
        faces = np.ctypeslib.as_array(tris_p, (nt.value, 3)).copy()
        keys = np.ctypeslib.as_array(keys_p, (nv.value,)).copy()
    finally:
        lib.mc_free(verts_p)
        lib.mc_free(tris_p)
        lib.mc_free(keys_p)
    if return_keys:
        return verts, faces, keys
    return verts, faces


def weld_vertices(verts: np.ndarray, faces: np.ndarray, decimals: int = 5,
                  keys: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge duplicate vertices: by the extractor's edge ids when ``keys``
    is given (equal key <=> bit-identical position; a 1-D int64 unique),
    else by positions rounded to ``decimals``."""
    if len(verts) == 0:
        return verts, faces
    if keys is not None:
        _, first, inverse = np.unique(keys, return_index=True,
                                      return_inverse=True)
        return (verts[first].astype(np.float32),
                inverse[faces].astype(np.int32))
    key = np.round(verts, decimals)
    uniq, inverse = np.unique(key, axis=0, return_inverse=True)
    return uniq.astype(np.float32), inverse.reshape(-1)[faces].astype(np.int32)


def grid_interp(grid: np.ndarray, verts: np.ndarray) -> np.ndarray:
    """Trilinearly sample a (nx, ny, nz, C) grid at (V, 3) grid-index
    coordinates (clipped into the grid); (V, C) float32."""
    g = np.asarray(grid, np.float32)
    v = np.asarray(verts, np.float32)
    nx, ny, nz = g.shape[:3]
    v = np.clip(v, 0.0, np.asarray([nx - 1, ny - 1, nz - 1], np.float32))
    v0 = np.minimum(np.floor(v).astype(np.int32),
                    np.asarray([nx - 2, ny - 2, nz - 2], np.int32))
    f = v - v0
    out = np.zeros((v.shape[0], g.shape[3]), np.float32)
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                w = ((f[:, 0] if cx else 1 - f[:, 0])
                     * (f[:, 1] if cy else 1 - f[:, 1])
                     * (f[:, 2] if cz else 1 - f[:, 2]))
                out = out + w[:, None] * g[v0[:, 0] + cx, v0[:, 1] + cy,
                                           v0[:, 2] + cz]
    return out


def verts_to_world(verts: np.ndarray, min_bound, max_bound,
                   resolution: int) -> np.ndarray:
    """Grid-index coordinates -> world coordinates over the scene bounds."""
    lo = np.asarray(min_bound, np.float32)
    hi = np.asarray(max_bound, np.float32)
    return lo + verts / (resolution - 1) * (hi - lo)


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: Optional[np.ndarray] = None):
    """Binary little-endian PLY with optional per-vertex uchar colours."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {len(verts)}",
               "property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {len(faces)}",
                "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        if colors is not None:
            c8 = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
            rec = np.zeros(len(verts),
                           dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = verts
            rec["rgb"] = c8
            f.write(rec.tobytes())
        else:
            f.write(verts.tobytes())
        frec = np.zeros(len(faces), dtype=[("n", np.uint8), ("idx", np.int32, 3)])
        frec["n"] = 3
        frec["idx"] = faces
        f.write(frec.tobytes())


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in faces:
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")
