"""The hash-NeRF MLP head (counterpart of MLP_3D in the JAX models/mlp.py).

Density branch: Linear(in, width) -> ReLU -> ... -> (1 + geo_feat_dim);
colour branch: Linear(geo_feat_dim + d_view, width) -> ... -> 3.  Density
activation LeakyReLU (or 2*sigmoid - 1 for SDF), colour sigmoid (or ELU).

Compute dtype: the JAX ``_linear`` casts input, weight and bias to bf16 and
keeps the product in f32 (``preferred_element_type=float32``).  A torch bf16
matmul rounds its output to bf16, which is a different result, so the port
rounds the operands to bf16, upcasts them to f32 and multiplies in f32.
Products of bf16 values are exact in f32, so with TF32 off (PyTorch's
default for matmul) this is bf16 x bf16 with f32 accumulation.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from human_body_reconstruction_tpu_torch.utils.config import MLPConfig


def _round(x, compute_dtype):
    if compute_dtype is None:
        return x
    return x.to(compute_dtype).to(torch.float32)


def _linear(layer: nn.Linear, x, compute_dtype=None):
    w = _round(layer.weight, compute_dtype)
    b = _round(layer.bias, compute_dtype)
    return _round(x, compute_dtype) @ w.t() + b


def apply_density_activation(raw, cfg: MLPConfig):
    if cfg.density_activation == "sdf":
        return 2.0 * torch.sigmoid(raw) - 1.0
    return F.leaky_relu(raw, negative_slope=0.01)


class MLP3D(nn.Module):
    """Layers are ``nn.Linear`` (weight (d_out, d_in), the transpose of the
    JAX (d_in, d_out) layout).  With a ``generator`` they are initialised
    like torch's default U(-1/sqrt(d_in), 1/sqrt(d_in)); without one they
    are zeros, to be loaded.  The global RNG is never used."""

    def __init__(self, cfg: MLPConfig, in_dim: int, d_view: int, *,
                 device=None, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        sig = [(in_dim, cfg.width)]
        for i in range(cfg.num_sig):
            sig.append((cfg.width, (1 + cfg.geo_feat_dim)
                        if i == cfg.num_sig - 1 else cfg.width))
        col = [(cfg.geo_feat_dim + d_view, cfg.width)]
        for i in range(cfg.num_col):
            col.append((cfg.width, 3 if i == cfg.num_col - 1 else cfg.width))
        self.sig = nn.ModuleList(self._layer(a, b, generator) for a, b in sig)
        self.col = nn.ModuleList(self._layer(a, b, generator) for a, b in col)
        if device is not None:
            self.to(device)

    @staticmethod
    def _layer(d_in: int, d_out: int, generator):
        layer = nn.utils.skip_init(nn.Linear, d_in, d_out,
                                   device="cpu" if generator is None
                                   else generator.device)
        with torch.no_grad():
            for p in (layer.weight, layer.bias):
                if generator is None:
                    p.zero_()
                else:
                    bound = 1.0 / d_in ** 0.5
                    p.uniform_(-bound, bound, generator=generator)
        return layer

    def density(self, feats, compute_dtype=None):
        """-> (raw density (N, 1), geo features (N, geo_feat_dim))."""
        h = feats
        for i, layer in enumerate(self.sig):
            h = _linear(layer, h, compute_dtype)
            if i < len(self.sig) - 1:
                h = torch.relu(h)
        return h[..., :1], h[..., 1:]

    def color(self, geo_feat, viewdirs_enc, compute_dtype=None):
        h = torch.cat([geo_feat, viewdirs_enc.to(geo_feat.dtype)], dim=-1)
        for i, layer in enumerate(self.col):
            h = _linear(layer, h, compute_dtype)
            if i < len(self.col) - 1:
                h = torch.relu(h)
        if self.cfg.rgb_activation == "elu":
            return F.elu(h)
        return torch.sigmoid(h)

    def forward(self, feats, viewdirs_enc, compute_dtype=None):
        """-> (rgb (N, 3), density (N,))."""
        raw, geo = self.density(feats, compute_dtype)
        density = apply_density_activation(raw, self.cfg)[..., 0]
        return self.color(geo, viewdirs_enc, compute_dtype), density


def mlp3d_density(mlp: MLP3D, feats, compute_dtype=None):
    """Density branch only -> (raw density (N, 1), geo features)."""
    return mlp.density(feats, compute_dtype)
