"""PyTorch port vs the JAX package: the MLP_3D head in f32 and bf16 compute.

The JAX parameters (init_mlp3d, numpy) are loaded into the port's MLP3D;
features and encoded view directions are numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu.models import mlp as jmlp
from human_body_reconstruction_tpu_torch.models import mlp
from human_body_reconstruction_tpu_torch.utils import config as C

IN_DIM, D_VIEW = 20, 24


def load(cfg, jparams):
    m = mlp.MLP3D(cfg, IN_DIM, D_VIEW)
    with torch.no_grad():
        for branch, jb in ((m.sig, jparams["sig"]), (m.col, jparams["col"])):
            for layer, p in zip(branch, jb):
                layer.weight.copy_(torch.tensor(np.asarray(p["w"])).t())
                layer.bias.copy_(torch.tensor(np.asarray(p["b"])))
    return m


@pytest.mark.parametrize("rgb_act", ["sigmoid", "elu"])
@pytest.mark.parametrize("bf16", [False, True])
def test_mlp3d_matches(bf16, rgb_act):
    """f32: atol 1e-5.  bf16: both sides round input, weight and bias to
    bf16 and accumulate in f32; an f32 order difference could still move a
    hidden activation across a bf16 rounding boundary (2**-8 relative).
    Measured 6e-8 at width 32: atol 1e-4."""
    cfg = C.MLPConfig(width=32, rgb_activation=rgb_act)
    jparams = jmlp.init_mlp3d(jax.random.PRNGKey(0), cfg, IN_DIM, D_VIEW)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(257, IN_DIM)).astype(np.float32)
    dirs = rng.normal(size=(257, D_VIEW)).astype(np.float32)
    m = load(cfg, jparams)
    dt_t = torch.bfloat16 if bf16 else None
    dt_j = jnp.bfloat16 if bf16 else None
    rgb, dens = m(torch.tensor(feats), torch.tensor(dirs), dt_t)
    rgb_j, dens_j = jmlp.apply_mlp3d(jparams, jnp.asarray(feats),
                                     jnp.asarray(dirs), cfg, dt_j)
    atol = 1e-4 if bf16 else 1e-5
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_j),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(dens.detach().numpy(), np.asarray(dens_j),
                               rtol=0, atol=atol)
    raw, geo = mlp.mlp3d_density(m, torch.tensor(feats), dt_t)
    raw_j, geo_j = jmlp.mlp3d_density(jparams, jnp.asarray(feats), cfg, dt_j)
    np.testing.assert_allclose(geo.detach().numpy(), np.asarray(geo_j),
                               rtol=0, atol=atol)


def test_mlp3d_init_uses_generator_only():
    cfg = C.MLPConfig(width=16)
    state = torch.random.get_rng_state()
    a = mlp.MLP3D(cfg, 8, 4, generator=torch.Generator().manual_seed(3))
    b = mlp.MLP3D(cfg, 8, 4, generator=torch.Generator().manual_seed(3))
    assert torch.equal(torch.random.get_rng_state(), state)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
        bound = 1.0 / pa.shape[-1] ** 0.5 if pa.dim() == 2 else 1.0
        assert float(pa.detach().abs().max()) <= bound
    assert all(float(p.detach().abs().sum()) == 0
               for p in mlp.MLP3D(cfg, 8, 4).parameters())


def _kernel_head(**kw):
    return mlp.MLP3D(C.MLPConfig(**kw), 129, 24)


@pytest.mark.parametrize("case", [
    "cp_shape", "hash_shape", "sdf_elu", "f32_compute", "width_32",
    "num_sig_3", "num_col_1", "geo_16", "in_too_wide", "view_too_wide",
    "classic_nerf", "mlp2d"])
def test_mlp_kernel_dispatch_rule(case):
    """Which heads and shapes the fused kernels take (``fits``: the rule
    without the device); any CPU call keeps ``_linear``."""
    from human_body_reconstruction_tpu_torch.ops import mlp_kernel

    bf16 = torch.bfloat16
    mod, in_dim, d_view, dtype = _kernel_head(), 129, 24, bf16
    expect = False
    if case == "cp_shape":
        expect = True
    elif case == "hash_shape":
        mod, in_dim, expect = mlp.MLP3D(C.MLPConfig(), 32, 24), 32, True
    elif case == "sdf_elu":
        mod, expect = _kernel_head(density_activation="sdf",
                                   rgb_activation="elu"), True
    elif case == "f32_compute":
        dtype = None
    elif case == "width_32":
        mod = _kernel_head(width=32)
    elif case == "num_sig_3":
        mod = _kernel_head(num_sig=3)
    elif case == "num_col_1":
        mod = _kernel_head(num_col=1)
    elif case == "geo_16":
        mod = _kernel_head(geo_feat_dim=16)
    elif case == "in_too_wide":
        in_dim = mlp_kernel.MAX_IN_DIM + 1
        mod = mlp.MLP3D(C.MLPConfig(), in_dim, 24)
    elif case == "view_too_wide":
        d_view = mlp_kernel.MAX_VIEW_DIM + 1
        mod = mlp.MLP3D(C.MLPConfig(), 129, d_view)
    elif case == "classic_nerf":
        mod = mlp.ClassicNeRF(C.ClassicNeRFConfig())
    elif case == "mlp2d":
        mod = mlp.MLP2D(129)
    assert mlp_kernel.fits(mod, in_dim, d_view, dtype) is expect
    feats = torch.zeros((4, in_dim))
    dirs = torch.zeros((4, d_view))
    assert not mlp_kernel.takes(mod, feats, dtype, dirs)


def test_mlp_kernel_module_needs_no_toolkit():
    """CPU calls of MLP3D run ``_linear`` without building or loading the
    kernel library and count no composed call (only CUDA calls count)."""
    from human_body_reconstruction_tpu_torch.ops import cuda_lib, mlp_kernel

    m = mlp.MLP3D(C.MLPConfig(), 129, 24,
                  generator=torch.Generator().manual_seed(0))
    feats = torch.randn((70, 129), requires_grad=True)
    before = (mlp_kernel.launches, mlp_kernel.composed_calls)
    rgb, dens = m(feats, torch.randn((70, 24)), torch.bfloat16)
    m.density(feats, torch.bfloat16)
    (rgb.sum() + dens.sum()).backward()
    assert (mlp_kernel.launches, mlp_kernel.composed_calls) == before
    assert cuda_lib.library.cache_info().currsize == 0
    assert torch.equal(feats.grad, feats.grad.to(torch.bfloat16).float())


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 3e4, 1e30])
def test_mlp_kernel_split_is_exact(scale):
    """hi + mid + lo, each bf16, sums back to the f32 value exactly (the
    kernels' split of the full-f32 cotangent columns) wherever lo is a
    normal number (|x| above about 2^-110; below it lo loses bits as a
    subnormal); a bf16 value splits into itself and two zeros."""
    from human_body_reconstruction_tpu_torch.ops import mlp_kernel

    x = torch.tensor(np.random.default_rng(0).normal(size=10_000) * scale,
                     dtype=torch.float32)
    parts = mlp_kernel.split_bf16(x)
    for p in parts:
        assert torch.equal(p, p.to(torch.bfloat16).float())
    total = sum(p.double() for p in parts)
    assert torch.equal(total, x.double())
    b = x.to(torch.bfloat16).float()
    hi, mid, lo = mlp_kernel.split_bf16(b)
    assert torch.equal(hi, b) and not mid.any() and not lo.any()


@pytest.mark.parametrize("acts,density_only", [
    (("sigmoid", "leaky_relu"), False), (("elu", "sdf"), False),
    (("sigmoid", "leaky_relu"), True), (("elu", "sdf"), True)])
def test_mlp_kernel_plain_backward_is_autograds(acts, density_only):
    """``mlp_kernel.plain_backward``, the backward kernel's plain version,
    gives autograd's gradients of the composed path (bf16 compute) within
    the order tolerance: the same bf16-rounded terms summed in f64 against
    f32, rounded where autograd rounds, bf16-exact."""
    from human_body_reconstruction_tpu_torch.ops import cuda_lib, mlp_kernel

    cfg = C.MLPConfig(rgb_activation=acts[0], density_activation=acts[1])
    m = mlp.MLP3D(cfg, 40, 24, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    n = 300
    feats = torch.tensor(rng.normal(0, 0.3, (n, 40)), dtype=torch.float32,
                         requires_grad=True)
    dirs = torch.tensor(rng.uniform(-1, 1, (n, 24)), dtype=torch.float32)
    if density_only:
        cot = (torch.tensor(rng.normal(0, 1, (n, 16)), dtype=torch.float32),)
        outs = (torch.cat(m.density(feats, torch.bfloat16), dim=-1),)
        layers = list(m.sig)
    else:
        cot = (torch.tensor(rng.normal(0, 1, (n, 3)), dtype=torch.float32),
               torch.tensor(rng.normal(0, 1, (n,)), dtype=torch.float32))
        outs = m(feats, dirs, torch.bfloat16)
        layers = list(m.sig) + list(m.col)
    torch.autograd.backward(outs, cot)
    dfeats, grads, sums, s_f = mlp_kernel.plain_backward(
        m, feats.detach(), dirs, cot, density_only)
    params = [p for layer in layers for p in (layer.weight, layer.bias)]
    assert len(grads) == len(params)
    for got, ref, s in zip([*(p.grad for p in params), feats.grad],
                           [*grads, dfeats], [*sums, s_f]):
        assert torch.equal(ref, ref.to(torch.bfloat16).float())
        tol = cuda_lib.sum_order_tolerance(ref, s, True)
        assert bool(((got - ref).abs() <= tol).all())
