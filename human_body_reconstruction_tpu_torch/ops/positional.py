"""Frequency positional encodings (counterpart of the JAX ops/positional.py).

``mode='linear'``: sin(2*x*k), cos(2*x*k) for k = 0..num_freq-1 (the
reference's view-direction encoder); ``mode='nerf'``: sin(2**k * x),
cos(2**k * x).  Per input channel, num_freq sin features then num_freq cos
features: (..., D) -> (..., D * num_freq * 2).
"""

from __future__ import annotations

import torch


def positional_encode(x, num_freq: int, mode: str = "linear"):
    if mode == "linear":
        k = torch.arange(num_freq, dtype=x.dtype, device=x.device)
        phase = 2.0 * x[..., None] * k                    # (..., D, K)
    elif mode == "nerf":
        k = 2.0 ** torch.arange(num_freq, dtype=x.dtype, device=x.device)
        phase = x[..., None] * k
    else:
        raise ValueError(f"unknown positional encoding mode: {mode}")
    out = torch.cat([torch.sin(phase), torch.cos(phase)], dim=-1)
    return out.reshape(out.shape[:-2] + (x.shape[-1] * num_freq * 2,))
