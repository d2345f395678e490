"""Command-line entry points of the port: ``train_hash``, ``serve``,
``quality_holdout``, ``render``, ``nerf2mesh``, ``occ_report``, the capture
front end (``colmap2nerf``, ``segment``) and ``reconstruct``, which chains
capture, segmentation, training and mesh export; ``train_vanilla`` (the
classic positional-encoding NeRF), ``image_fit`` (the 2-D hash-grid image
fit) and ``plot_psnr`` (PSNR curves of rendered frames); and their shared
helpers."""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def device_from_flag(name: str) -> torch.device:
    """The torch device a CLI's ``--device`` names.  The entry points run on
    the card unless asked for the CPU: a CUDA device on a machine without
    one ends the program with a message that names ``--device cpu``."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    return device


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" on
    the CPU)."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True).stdout.strip()


def psnr(img, ref) -> float:
    """10·log10(1 / mse) of two numpy images in [0, 1]."""
    mse = float(np.mean((img - ref) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))
