"""Command-line entry points of the port: ``train_hash`` and ``serve``."""

from __future__ import annotations

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
