"""The MLP3D head as one fused CUDA kernel pair, forward and backward
(csrc/mlp.cu, whose note says what bounds it and why it splits three
cotangent columns), and the rule that decides which calls take it.

The kernels compute ``models/mlp.py``'s composed ``_linear`` path with bf16
compute: z = f32sum(bf16(x) . bf16(W)^T) + bf16(b) layer by layer, ReLU
between layers, the colour input bf16(cat(geo, dirs)).  A forward that a
gradient follows sums in cuBLAS's order, so its outputs equal the composed
path's bit for bit at the training path's shapes; one that none follows
(serving, the occupancy refresh) takes its products on the bf16 tensor cores
(the same terms, summed in another order).  The backward's products run on
the tensor cores, the gradient rounded to bf16 wherever autograd rounds it
on the composed path (every layer input's dx, every dW and db).  ``mlp3d`` is the full head (rgb (N, 3),
activated density (N,)), ``density`` the density branch alone (z3 (N, 16):
raw density and the geometry features), each a ``torch.autograd.Function``
whose backward is the backward kernel and a reduction of its per-CTA
weight-gradient partials; when a gradient will be taken, the forward saves
its bf16 activations (``SAVED_WIDTH`` a point, 544 bytes in the full form)
and f32 pre-activations for the backward, which recomputes nothing.
``plain_backward`` is the backward's plain version (the composed path's
gradients, evaluated in f64), which the card tests and ``chip_smoke.py``
hold the kernel's to.

``takes`` is the rule: a call takes the kernels when its features lie on a
CUDA device, the compute dtype is bf16 and the module has the layer list the
kernels are built for (width ``WIDTH``, ``num_sig`` and ``num_col`` 2,
``geo_feat_dim`` 15, f32 parameters on the features' device), its input
width is at most ``MAX_IN_DIM`` and its view encoding at most
``MAX_VIEW_DIM`` wide (the backward's shared memory).  Every other call, f32
compute, the other heads and CPU tensors, keeps ``_linear``.  The choice is
made from those shapes and types alone.  ``launches`` counts the host calls
that launched the forward or the backward (under a CUDA graph only the
warm-up and the capture); ``composed_calls`` counts the CUDA calls of
``MLP3D`` with bf16 compute that took ``_linear`` because of their shapes.
"""

from __future__ import annotations

import ctypes

import torch

from human_body_reconstruction_tpu_torch.ops import cuda_lib

WIDTH = 64                 # csrc/mlp.cu WIDTH
GEO_FEAT_DIM = 15          # csrc/mlp.cu GEO
MAX_IN_DIM = 143           # csrc/mlp.cu MAX_IN
MAX_VIEW_DIM = 32          # csrc/mlp.cu MAX_VIEW
DENSITY_ONLY, RGB_ELU, DENSITY_SDF, EXACT_ORDER = 1, 2, 4, 8  # csrc/mlp.cu
# bf16 a point the forward saves for the backward, full and density-only
# form (csrc/mlp.cu AS_FULL, AS_DENSITY), beside 4 f32 (full form)
SAVED_WIDTH = (4 * WIDTH + 16, 2 * WIDTH)

launches = 0
composed_calls = 0


def split_bf16(x):
    """(hi, mid, lo), bf16 values as f32, with hi + mid + lo == x exactly:
    the kernels' split of an f32 cotangent (csrc/mlp.cu split3)."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    mid = (x - hi).to(torch.bfloat16).to(torch.float32)
    lo = (x - hi - mid).to(torch.bfloat16).to(torch.float32)
    return hi, mid, lo


def fits(mlp, in_dim: int, d_view: int, compute_dtype) -> bool:
    """Whether a module's layer list and widths are the kernels' (the part
    of ``takes`` that does not look at the device)."""
    cfg = getattr(mlp, "cfg", None)
    return (compute_dtype == torch.bfloat16
            and hasattr(mlp, "sig") and hasattr(mlp, "col")
            and getattr(cfg, "width", None) == WIDTH
            and cfg.num_sig == 2 and cfg.num_col == 2
            and cfg.geo_feat_dim == GEO_FEAT_DIM
            and cfg.density_activation in ("leaky_relu", "sdf")
            and cfg.rgb_activation in ("sigmoid", "elu")
            and 1 <= in_dim <= MAX_IN_DIM and 0 <= d_view <= MAX_VIEW_DIM)


def takes(mlp, feats, compute_dtype, viewdirs_enc=None) -> bool:
    """Whether this call goes through the kernels: CUDA f32 (N, in) features
    (and (N, d_view) view encodings), parameters f32 on their device, and a
    layer list the kernels are built for."""
    if not feats.is_cuda or feats.dim() != 2 or feats.dtype != torch.float32:
        return False
    d_view = 0
    if viewdirs_enc is not None:
        if (viewdirs_enc.dim() != 2 or viewdirs_enc.shape[0] != feats.shape[0]
                or viewdirs_enc.device != feats.device):
            return False
        d_view = viewdirs_enc.shape[1]
    if not fits(mlp, feats.shape[1], d_view, compute_dtype):
        return False
    return all(p.dtype == torch.float32 and p.device == feats.device
               for p in mlp.parameters())


def note_composed(feats, compute_dtype):
    """Count a CUDA call of ``MLP3D`` with bf16 compute that takes
    ``_linear`` (its shapes or types are not the kernels'); f32 compute,
    such as the occupancy refresh's, is another function and not counted,
    and so are the neuralangelo head's 256-wide weight-normed layers
    (models/sdf_head.py: f32 ``F.linear`` calls that never reach
    ``MLP3D``)."""
    global composed_calls
    if feats.is_cuda and compute_dtype == torch.bfloat16:
        composed_calls += 1


def _mode(cfg, density_only: bool) -> int:
    return ((DENSITY_ONLY if density_only else 0)
            | (RGB_ELU if cfg.rgb_activation == "elu" else 0)
            | (DENSITY_SDF if cfg.density_activation == "sdf" else 0))


def _weights(params) -> cuda_lib.HbrMlpWeights:
    """The six layers' (weight, bias) pointers; density-only passes three."""
    w = cuda_lib.HbrMlpWeights()
    for l in range(len(params) // 2):
        w.w[l] = params[2 * l].data_ptr()
        w.b[l] = params[2 * l + 1].data_ptr()
    return w


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(feats, dirs, mode: int, params, outs, save: bool):
    """Launch the forward into ``outs``.  With ``save`` (a gradient follows)
    it sums in cuBLAS's order and returns what the backward reads: (the
    bf16 activations, the f32 stash or None); without, on the tensor
    cores."""
    global launches
    n, in_dim = feats.shape
    d_view = 0 if dirs is None else dirs.shape[1]
    acts = zsave = None
    if save:
        mode |= EXACT_ORDER
        density_only = bool(mode & DENSITY_ONLY)
        acts = torch.empty((n, SAVED_WIDTH[density_only]), dtype=torch.bfloat16,
                           device=feats.device)
        if not density_only:
            zsave = torch.empty((n, 4), dtype=torch.float32, device=feats.device)
    if n == 0:
        return acts, zsave
    w = _weights(params)
    code = cuda_lib.library().hbr_mlp_forward(
        feats.data_ptr(), _ptr(dirs), n, in_dim, d_view, mode,
        ctypes.byref(w), outs[0].data_ptr(), _ptr(outs[1]), _ptr(acts),
        _ptr(zsave), cuda_lib.stream_handle(feats.device))
    launches += 1
    cuda_lib.check(code, "hbr_mlp_forward")
    return acts, zsave


def _backward(feats, dirs, saved, mode: int, params, g0, g1,
              want_feats: bool, want_dirs: bool):
    """(dfeats or None, ddirs or None, [dW, db per layer]) from the
    forward's ``saved`` (activations, stash)."""
    global launches
    n, in_dim = feats.shape
    d_view = 0 if dirs is None else dirs.shape[1]
    dfeats = torch.empty_like(feats) if want_feats else None
    ddirs = torch.empty_like(dirs) if want_dirs else None
    if n == 0:
        return dfeats, ddirs, [torch.zeros_like(p) for p in params]
    # the reduction writes every entry of each layer's weight and bias
    grads = [torch.empty_like(p) for p in params]
    lib = cuda_lib.library()
    blocks, floats = ctypes.c_int(), ctypes.c_longlong()
    cuda_lib.check(lib.hbr_mlp_backward_plan(
        n, in_dim, d_view, ctypes.byref(blocks), ctypes.byref(floats)),
        "hbr_mlp_backward_plan")
    partials = torch.empty(blocks.value * floats.value, dtype=torch.float32,
                           device=feats.device)
    gw = cuda_lib.HbrMlpGrads()
    for l in range(len(params) // 2):
        gw.w[l] = grads[2 * l].data_ptr()
        gw.b[l] = grads[2 * l + 1].data_ptr()
    w = _weights(params)
    code = lib.hbr_mlp_backward(
        feats.data_ptr(), _ptr(dirs), n, in_dim, d_view, mode,
        ctypes.byref(w), _ptr(saved[0]), _ptr(saved[1]), g0.data_ptr(),
        _ptr(g1), _ptr(dfeats), _ptr(ddirs), partials.data_ptr(),
        blocks.value, ctypes.byref(gw), cuda_lib.stream_handle(feats.device))
    launches += 1
    cuda_lib.check(code, "hbr_mlp_backward")
    return dfeats, ddirs, grads


class _Head(torch.autograd.Function):
    """The full head: (feats, dirs, mode, save, w0, b0, ..., w5, b5) ->
    (rgb, density).  With ``save`` (a gradient follows) the forward sums in
    cuBLAS's order and saves its bf16 activations and f32 pre-activations
    for the backward."""

    @staticmethod
    def forward(ctx, feats, dirs, mode, save, *params):
        n = feats.shape[0]
        rgb = torch.empty((n, 3), dtype=torch.float32, device=feats.device)
        density = torch.empty((n,), dtype=torch.float32, device=feats.device)
        saved = _forward(feats, dirs, mode, params, (rgb, density), save)
        ctx.mode = mode
        ctx.save_for_backward(feats, dirs, *saved, *params)
        return rgb, density

    @staticmethod
    def backward(ctx, drgb, ddensity):
        feats, dirs, acts, zsave, *params = ctx.saved_tensors
        dfeats, ddirs, grads = _backward(
            feats, dirs, (acts, zsave), ctx.mode, params, drgb.contiguous(),
            ddensity.contiguous(), ctx.needs_input_grad[0],
            ctx.needs_input_grad[1])
        return (dfeats, ddirs, None, None, *grads)


class _Density(torch.autograd.Function):
    """The density branch: (feats, mode, save, w0, b0, w1, b1, w2, b2) ->
    z3 (N, 16), raw density in column 0."""

    @staticmethod
    def forward(ctx, feats, mode, save, *params):
        z3 = torch.empty((feats.shape[0], 1 + GEO_FEAT_DIM),
                         dtype=torch.float32, device=feats.device)
        acts, _ = _forward(feats, None, mode, params, (z3, None), save)
        ctx.mode = mode
        ctx.save_for_backward(feats, acts, *params)
        return z3

    @staticmethod
    def backward(ctx, dz3):
        feats, acts, *params = ctx.saved_tensors
        dfeats, _, grads = _backward(feats, None, (acts, None), ctx.mode,
                                     params, dz3.contiguous(), None,
                                     ctx.needs_input_grad[0], False)
        return (dfeats, None, None, *grads)


def _params(layers):
    return [p for layer in layers for p in (layer.weight, layer.bias)]


def plain_backward(mlp, feats, dirs, cot, density_only=False):
    """The gradients of the composed path (``models/mlp.py`` ``_linear`` with
    bf16 compute), the plain version the backward kernel is held to: the
    composed forward layer by layer in f32 (a gradient-following forward of
    the kernels equals it bit for bit), then its backward in f64 with the
    roundings where autograd rounds: dW = bf16(dz^T x), db = bf16(sum dz),
    dx = bf16(dz W) masked by the ReLU, the output activations' derivatives
    taken in f32 as autograd takes them.  ``cot`` is (rgb's, density's)
    cotangent, or (z3's,) with ``density_only``.  Returns (dfeats, [dW, db
    per layer], [S of each], S of dfeats), each S the sum of the absolute
    values of the terms summed (``cuda_lib.sum_order_tolerance``'s)."""
    cfg = mlp.cfg
    mods = list(mlp.sig) if density_only else list(mlp.sig) + list(mlp.col)

    def rnd(x):
        return x.to(torch.bfloat16).to(x.dtype)

    with torch.no_grad():
        xs, zs, h = [], [], feats
        for l, layer in enumerate(mods):
            if l == 3:
                h = torch.cat([zs[2][:, 1:], dirs.to(torch.float32)], dim=-1)
            xs.append(rnd(h))
            zs.append(xs[-1] @ rnd(layer.weight).t() + rnd(layer.bias))
            h = torch.relu(zs[-1])
        dz = [None] * len(mods)
        if density_only:
            dz[2] = cot[0]
        elif cfg.rgb_activation == "elu":
            dz[5] = torch.where(zs[5] > 0, cot[0], cot[0] * torch.exp(zs[5]))
        else:
            y = torch.sigmoid(zs[5])
            dz[5] = cot[0] * (1.0 - y) * y
        grads, sums = [None] * (2 * len(mods)), [None] * (2 * len(mods))
        for l in reversed(range(len(mods))):
            if dz[l] is None:              # the density branch's output
                raw, g = zs[2][:, :1], cot[1][:, None]
                if cfg.density_activation == "sdf":
                    sg = torch.sigmoid(raw)
                    draw = (2.0 * g) * (1.0 - sg) * sg
                else:
                    draw = torch.where(raw > 0, g, g * 0.01)
                dz[l] = torch.cat([draw, dgeo], dim=-1)
            d, x = dz[l].double(), xs[l].double()
            grads[2 * l] = rnd((d.t() @ x).float())
            grads[2 * l + 1] = rnd(d.sum(0).float())
            sums[2 * l] = (d.abs().t() @ x.abs()).float()
            sums[2 * l + 1] = d.abs().sum(0).float()
            w = rnd(mods[l].weight).double()
            dx = rnd((d @ w).float())
            if l == 0:
                dfeats, s_f = dx, (d.abs() @ w.abs()).float()
            elif l == 3:
                dgeo = dx[:, :GEO_FEAT_DIM]
            else:
                dz[l - 1] = torch.where(zs[l - 1] > 0, dx, torch.zeros_like(dx))
    return dfeats, grads, sums, s_f


def _gradient_follows(*tensors) -> bool:
    """Whether autograd will record this call (decided before ``apply``:
    inside a Function's forward the grad mode is off)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def mlp3d(mlp, feats, viewdirs_enc):
    """(rgb (N, 3), density (N,)) of an ``MLP3D`` for which ``takes``
    holds."""
    params = _params(list(mlp.sig) + list(mlp.col))
    dirs = viewdirs_enc.to(torch.float32).contiguous()
    return _Head.apply(feats.contiguous(), dirs, _mode(mlp.cfg, False),
                       _gradient_follows(feats, dirs, *params), *params)


def density(mlp, feats):
    """(raw density (N, 1), geo features (N, 15)) of an ``MLP3D`` for which
    ``takes`` holds."""
    params = _params(mlp.sig)
    z3 = _Density.apply(feats.contiguous(), _mode(mlp.cfg, True),
                        _gradient_follows(feats, *params), *params)
    return z3[:, :1], z3[:, 1:]
