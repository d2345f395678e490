"""NeRF-style datasets (counterpart of the JAX data/datasets.py).

Both JSON camera formats of the reference: NeRF-synthetic / Blender
(intrinsics from ``camera_angle_x``, frame paths like ``./train/r_0`` with an
implicit ``.png``) and instant-ngp / COLMAP (explicit ``fl_x, fl_y, cx, cy``
and full file names).  ``load_nerf_json`` is a copy of the JAX package's
numpy-only reader (tests/test_torch_boundary.py holds the two equal); its
frames are read as that reader reads them, PNGs through ``data/png.py``
(whether or not Pillow is installed), other formats through Pillow.
``to_device`` puts the arrays on a torch device.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.data import png


def _read_image(path: str) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) samples: a ``.png`` through ``data/png.py``
    (no Pillow needed), any other format through Pillow."""
    if path.lower().endswith(".png"):
        arr = png.read_png(path)
        return arr[..., 0] if arr.shape[-1] == 1 else arr
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: reading this format needs Pillow, which "
                           "is not installed (PNG frames need nothing)") from None
    return np.asarray(Image.open(path))


def _imread_rgb(path: str, white_background: bool = False) -> np.ndarray:
    """Load an image as float32 RGB in [0, 1]; alpha composited if present."""
    arr = _read_image(path).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 4:
        rgb, a = arr[..., :3], arr[..., 3:4]
        bg = 1.0 if white_background else 0.0
        arr = rgb * a + bg * (1.0 - a)
    return arr[..., :3]


def _frame_path(json_path: str, file_path: str) -> str:
    base = os.path.dirname(json_path)
    rel = file_path[2:] if file_path.startswith("./") else file_path
    p = os.path.join(base, rel)
    if not os.path.splitext(p)[1]:
        p = p + ".png"
    return p


def load_nerf_json(json_path: str, *, white_background: bool = False,
                   downscale: int = 1, max_frames: Optional[int] = None):
    """Load a transforms*.json dataset (either camera format).

    Returns a dict: images (N, H, W, 3) float32, c2ws (N, 4, 4) float32,
    K (3, 3), H, W, and per-frame aux (rotation/sharpness when present).
    """
    if not os.path.exists(json_path):
        raise FileNotFoundError(f"The path {json_path} does not exist")
    with open(json_path) as f:
        meta = json.load(f)
    frames = meta["frames"]
    if max_frames is not None:
        frames = frames[:max_frames]

    images, c2ws, aux = [], [], []
    for fr in frames:
        img = _imread_rgb(_frame_path(json_path, fr["file_path"]),
                          white_background)
        if downscale > 1:
            img = img[::downscale, ::downscale]
        images.append(img)
        c2ws.append(np.asarray(fr["transform_matrix"], np.float32))
        aux.append(fr.get("rotation", fr.get("sharpness", 0.0)))
    images = np.stack(images)
    c2ws = np.stack(c2ws)
    H, W = images.shape[1:3]

    if "fl_x" in meta:           # instant-ngp format
        s = 1.0 / downscale
        K = np.array([[meta["fl_x"] * s, 0, meta["cx"] * s],
                      [0, meta["fl_y"] * s, meta["cy"] * s],
                      [0, 0, 1]], np.float32)
    else:                         # blender format
        focal = W / (2.0 * np.tan(float(meta["camera_angle_x"]) / 2.0))
        K = np.array([[focal, 0, W / 2.0],
                      [0, focal, H / 2.0],
                      [0, 0, 1]], np.float32)
    return {"images": images, "c2ws": c2ws, "K": K, "H": H, "W": W,
            "aux": np.asarray(aux, np.float32)}


def to_device(ds: dict, device) -> dict:
    """The dataset with images, poses and intrinsics as f32 tensors on
    ``device``."""
    out = dict(ds)
    for k in ("images", "c2ws", "K"):
        out[k] = torch.as_tensor(ds[k], dtype=torch.float32, device=device)
    return out
