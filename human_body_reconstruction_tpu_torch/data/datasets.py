"""NeRF-style datasets (counterpart of the JAX data/datasets.py).

``load_nerf_json`` is the JAX package's own: it is numpy-only.  The JAX
``to_device`` imports ``jax.numpy``, so this module has its own."""

from __future__ import annotations

import torch

from human_body_reconstruction_tpu.data.datasets import load_nerf_json  # noqa: F401


def to_device(ds: dict, device) -> dict:
    """The dataset with images, poses and intrinsics as f32 tensors on
    ``device``."""
    out = dict(ds)
    for k in ("images", "c2ws", "K"):
        out[k] = torch.as_tensor(ds[k], dtype=torch.float32, device=device)
    return out
