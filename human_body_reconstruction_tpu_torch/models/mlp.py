"""The MLP heads (counterparts of the JAX models/mlp.py): ``MLP3D``, the
hash-NeRF head; ``ClassicNeRF``, the vanilla positional-encoding NeRF; and
``MLP2D``, the 2-D image fit's head.

MLP3D: density branch Linear(in, width) -> ReLU -> ... -> (1 +
geo_feat_dim); colour branch Linear(geo_feat_dim + d_view, width) -> ... ->
3.  Density activation LeakyReLU (or 2*sigmoid - 1 for SDF), colour sigmoid
(or ELU).

ClassicNeRF and MLP2D compute in f32 (the JAX package calls ``_linear``
with no compute dtype there); with TF32 off, PyTorch's default for matmul,
their products are full f32.  ``to_jax_tree`` and ``load_jax_tree`` carry
any of these modules to and from the JAX params tree (layers as {"b",
"w"} with w (d_in, d_out), the transpose of ``nn.Linear.weight``);
``init_classic_nerf`` and ``init_mlp2d`` build the very trees the JAX
functions of those names draw from a key (``utils/jax_prng.py``), so the
port's vanilla trainer and image fit start where the JAX CLIs start.

Compute dtype: the JAX ``_linear`` casts input, weight and bias to bf16 and
keeps the product in f32 (``preferred_element_type=float32``).  A torch bf16
matmul rounds its output to bf16, which is a different result, so the port
rounds the operands to bf16, upcasts them to f32 and multiplies in f32.
Products of bf16 values are exact in f32, so with TF32 off (PyTorch's
default for matmul) this is bf16 x bf16 with f32 accumulation.  ``MLP3D``
takes the fused kernels of ``ops/mlp_kernel.py`` (csrc/mlp.cu) instead, for
CUDA tensors with bf16 compute and the kernels' layer list
(``mlp_kernel.takes``); ``_linear`` stays the plain version beside them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from human_body_reconstruction_tpu_torch.ops import mlp_kernel
from human_body_reconstruction_tpu_torch.utils.config import (
    ClassicNeRFConfig, MLPConfig)


def _round(x, compute_dtype):
    if compute_dtype is None:
        return x
    return x.to(compute_dtype).to(torch.float32)


def _linear(layer: nn.Linear, x, compute_dtype=None):
    w = _round(layer.weight, compute_dtype)
    b = _round(layer.bias, compute_dtype)
    return _round(x, compute_dtype) @ w.t() + b


def _init_linear(d_in: int, d_out: int, generator):
    """nn.Linear(d_in, d_out): U(-1/sqrt(d_in), 1/sqrt(d_in)) from the
    generator, on its device, or zeros (to be loaded) without one."""
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
        self.sig = nn.ModuleList(_init_linear(a, b, generator) for a, b in sig)
        self.col = nn.ModuleList(_init_linear(a, b, generator) for a, b in col)
        if device is not None:
            self.to(device)

    renders = False         # models/nerf.py renders an MLP3D field

    def stage_key(self, cfg, step: int):
        """None: an MLP3D field trains on no schedule of stages."""
        return None

    def stage_record(self, cfg, step: int, horizon: int, scene) -> dict:
        return {}

    def density(self, feats, compute_dtype=None):
        """-> (raw density (N, 1), geo features (N, geo_feat_dim))."""
        if mlp_kernel.takes(self, feats, compute_dtype):
            return mlp_kernel.density(self, feats)
        mlp_kernel.note_composed(feats, compute_dtype)
        return self._density(feats, compute_dtype)

    def _density(self, feats, compute_dtype=None):
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
        if mlp_kernel.takes(self, feats, compute_dtype, viewdirs_enc):
            return mlp_kernel.mlp3d(self, feats, viewdirs_enc)
        mlp_kernel.note_composed(feats, compute_dtype)
        raw, geo = self._density(feats, compute_dtype)
        density = apply_density_activation(raw, self.cfg)[..., 0]
        return self.color(geo, viewdirs_enc, compute_dtype), density


def mlp3d_density(mlp: MLP3D, feats, compute_dtype=None):
    """Density branch only -> (raw density (N, 1), geo features)."""
    return mlp.density(feats, compute_dtype)


class ClassicNeRF(nn.Module):
    """Vanilla NeRF (JAX ``init_classic_nerf``/``apply_classic_nerf``):
    ``cfg.n_layers`` ReLU layers of ``cfg.d_filter`` with the input
    concatenated after each layer in ``cfg.skip``; with view directions a
    sigmoid alpha, an rgb filter, a view branch of d_filter / 2 and a ReLU
    rgb, without them one 4-wide output (rgb, alpha) with no activation.
    Zeros, to be loaded (``classic_nerf_from_jax``)."""

    def __init__(self, cfg: ClassicNeRFConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_filter
        layers = [_init_linear(cfg.d_input, d, None)]
        for i in range(cfg.n_layers - 1):
            layers.append(_init_linear(
                d + cfg.d_input if i in cfg.skip else d, d, None))
        self.layers = nn.ModuleList(layers)
        if cfg.d_viewdirs is not None:
            self.alpha_out = _init_linear(d, 1, None)
            self.rgb_filters = _init_linear(d, d, None)
            self.branch = _init_linear(d + cfg.d_viewdirs, d // 2, None)
            self.output = _init_linear(d // 2, 3, None)
        else:
            self.output = _init_linear(d, 4, None)

    def forward(self, x, viewdirs=None):
        """-> (rgb (N, 3), alpha (N,))."""
        h = x
        for i, layer in enumerate(self.layers):
            h = torch.relu(layer(h))
            if i in self.cfg.skip:
                h = torch.cat([h, x], dim=-1)
        if self.cfg.d_viewdirs is None:
            out = self.output(h)
            return out[..., :3], out[..., 3]
        alpha = torch.sigmoid(self.alpha_out(h))
        h = torch.cat([self.rgb_filters(h), viewdirs.to(h.dtype)], dim=-1)
        h = torch.relu(self.branch(h))
        return torch.relu(self.output(h)), alpha[..., 0]


class MLP2D(nn.Module):
    """The image fit's head (JAX ``init_mlp2d``/``apply_mlp2d``):
    Linear(in_dim, width) -> ReLU -> Linear(width, 3) -> ReLU.  Zeros, to
    be loaded (``mlp2d_from_jax``)."""

    def __init__(self, in_dim: int, width: int = 64):
        super().__init__()
        self.l1 = _init_linear(in_dim, width, None)
        self.l2 = _init_linear(width, 3, None)

    def forward(self, x):
        return torch.relu(self.l2(torch.relu(self.l1(x))))


def to_jax_tree(module: nn.Module):
    """The module's parameters as the JAX params tree, numpy leaves: a
    Linear is {"b", "w" (d_in, d_out)}, a ModuleList a list, any other
    module a dict of its children."""
    if isinstance(module, nn.Linear):
        return {"b": module.bias.detach().cpu().numpy(),
                "w": module.weight.detach().t().cpu().numpy()}
    if isinstance(module, nn.ModuleList):
        return [to_jax_tree(m) for m in module]
    return {k: to_jax_tree(m) for k, m in module.named_children()}


def load_jax_tree(module: nn.Module, tree):
    """Copy a JAX params tree (numpy or array-like leaves) into the module,
    checking every shape; returns the module."""
    if isinstance(module, nn.Linear):
        with torch.no_grad():
            for p, arr, t in ((module.weight, tree["w"], True),
                              (module.bias, tree["b"], False)):
                v = torch.tensor(np.asarray(arr, np.float32))
                v = v.t() if t else v
                if v.shape != p.shape:
                    raise ValueError(f"JAX leaf of shape {tuple(np.shape(arr))}"
                                     f" for a layer of {tuple(p.shape)}")
                p.copy_(v)
        return module
    children = (list(enumerate(module)) if isinstance(module, nn.ModuleList)
                else list(module.named_children()))
    keys = range(len(tree)) if isinstance(module, nn.ModuleList) else tree
    if sorted(k for k, _ in children) != sorted(keys):
        raise ValueError(f"JAX tree {list(keys)} does not match the "
                         f"module's {[k for k, _ in children]}")
    for k, child in children:
        load_jax_tree(child, tree[k])
    return module


def init_linear(key, d_in: int, d_out: int) -> dict:
    """JAX ``_init_linear``: {"w" (d_in, d_out), "b"}, U(-1/sqrt(d_in),
    1/sqrt(d_in)) in f32, numpy."""
    from human_body_reconstruction_tpu_torch.utils import jax_prng

    kw, kb = jax_prng.split(key)
    bound = np.float32(1.0) / np.sqrt(np.float32(d_in))
    return {"w": jax_prng.uniform(kw, (d_in, d_out), -bound, bound),
            "b": jax_prng.uniform(kb, (d_out,), -bound, bound)}


def init_classic_nerf(key, cfg: ClassicNeRFConfig) -> dict:
    """The JAX ``init_classic_nerf(key, cfg)`` tree, numpy leaves."""
    from human_body_reconstruction_tpu_torch.utils import jax_prng

    n_extra = 4 if cfg.d_viewdirs is not None else 1
    keys = jax_prng.split(key, cfg.n_layers + n_extra)
    layers = [init_linear(keys[0], cfg.d_input, cfg.d_filter)]
    for i in range(cfg.n_layers - 1):
        d_in = cfg.d_filter + cfg.d_input if i in cfg.skip else cfg.d_filter
        layers.append(init_linear(keys[i + 1], d_in, cfg.d_filter))
    tree = {"layers": layers}
    k = cfg.n_layers
    if cfg.d_viewdirs is not None:
        tree["alpha_out"] = init_linear(keys[k], cfg.d_filter, 1)
        tree["rgb_filters"] = init_linear(keys[k + 1], cfg.d_filter,
                                          cfg.d_filter)
        tree["branch"] = init_linear(keys[k + 2],
                                     cfg.d_filter + cfg.d_viewdirs,
                                     cfg.d_filter // 2)
        tree["output"] = init_linear(keys[k + 3], cfg.d_filter // 2, 3)
    else:
        tree["output"] = init_linear(keys[k], cfg.d_filter, 4)
    return tree


def init_mlp2d(key, in_dim: int, width: int = 64) -> dict:
    """The JAX ``init_mlp2d(key, in_dim, width)`` tree, numpy leaves."""
    from human_body_reconstruction_tpu_torch.utils import jax_prng

    k1, k2 = jax_prng.split(key)
    return {"l1": init_linear(k1, in_dim, width),
            "l2": init_linear(k2, width, 3)}


def classic_nerf_from_jax(tree, cfg: ClassicNeRFConfig, device=None):
    """A ClassicNeRF on ``device`` holding the JAX ``init_classic_nerf``
    tree ``tree``."""
    return load_jax_tree(ClassicNeRF(cfg), tree).to(device)


def mlp2d_from_jax(tree, device=None):
    """An MLP2D on ``device`` holding the JAX ``init_mlp2d`` tree."""
    w1 = np.shape(tree["l1"]["w"])
    return load_jax_tree(MLP2D(w1[0], w1[1]), tree).to(device)
