"""The fused MLP3D kernels (csrc/mlp.cu) against the composed ``_linear``
path on the card.

The ``cuda``-marked tests need the card and skip elsewhere; this file imports
no JAX, so on the card's machine it runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_mlp_kernel.py

A forward that a gradient follows sums every layer as cuBLAS's f32 GEMM
does at these shapes (one rounded add a term, ascending k), so its outputs,
and every ReLU gate, equal the composed path's bit for bit.  One that no
gradient follows takes its products on the tensor cores: its outputs are
held to the composed path's to 1e-5 on all but ``FLIP_SHARE`` of their
entries and to ``OUT_MAX`` everywhere (where the two orders round a hidden
activation of about 0.5 to two neighbouring bf16 values, 2^-9 apart, the
next weights' 1/8 and the activations' slopes carry about 1e-3 of it to an
output at worst; measured: 2e-4 and 0.08%).  The backward's products run on the tensor
cores: both paths take bf16 x bf16 products into f32 sums, in other orders,
and round every backward dx to bf16; where two orders put an f32 sum on
either side of a bf16 rounding boundary (about 2^-16 of the values) the
rounded value moves by one bf16 ulp and the move runs on through the lower
layers.  The gradients are held to ``mlp_kernel.plain_backward``, the
composed path's backward evaluated in f64 from its own f32 forward (so from
the kernel's activations and gates, bit for bit), with the roundings kept
where autograd rounds, within ``cuda_lib.sum_order_tolerance`` (bf16) on
all but ``GRAD_SHARE`` of their entries.  A flip moves a gradient past that
tolerance, which prices only the f32 order of one sum: a term t moved by
one bf16 ulp moves its entry by about 2^-8 |t|, 2^10 |t| / S times the
tolerance's 2^-18 S (S the entry's sum of |terms|), so an entry that one
term dominates, or that cancels to far below S, reads a large multiple of
it.  The composed path's own autograd
backward (cuBLAS's f32 sums) reads that too against the same plain
backward on the card: up to 4.1 times the tolerance on a weight or bias
gradient and 34 on the feature gradient (sums of 64 terms a point), against
the kernel's 2.5 and 69 (seeds 10-15 and the tests' cases, 20,011 and 9,999
points; H100).  So each entry of a weight or bias gradient is held to
``GRAD_MAX`` times the tolerance and of the feature gradient to
``FEAT_MAX`` times it: a row dropped, or another row's, reads an error of
its own size, 128 to 256 bf16 ulps of it, on nearly every entry.  With a cotangent on the
last, partial tile alone (27 points) no flip occurs, and every entry of
every gradient is held to the tolerance itself.  Every gradient is
bf16-exact, as the composed path's are.
"""

import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu_torch.models import mlp
from human_body_reconstruction_tpu_torch.ops import cuda_lib, mlp_kernel
from human_body_reconstruction_tpu_torch.utils import config as C

BF16 = torch.bfloat16
FLIP_SHARE = 1e-2
OUT_MAX = 1e-2
GRAD_SHARE = 1e-2
GRAD_MAX = 8.0
FEAT_MAX = 128.0
SHAPES = {"cp": (129, 24), "hash": (32, 24)}     # (in_dim, d_view)
GEO = 15


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rnd(x):
    return x.to(BF16).to(x.dtype)


def make(cfg, in_dim, d_view, n, device, seed=0):
    m = mlp.MLP3D(cfg, in_dim, d_view,
                  generator=torch.Generator().manual_seed(seed)).to(device)
    rng = np.random.default_rng(seed)
    feats = torch.tensor(rng.normal(0, 0.3, (n, in_dim)), dtype=torch.float32,
                         device=device)
    dirs = torch.tensor(rng.uniform(-1, 1, (n, d_view)), dtype=torch.float32,
                        device=device)
    return m, feats, dirs


def is_bf16(x):
    return bool(torch.equal(x, rnd(x)))


def grad_ratios(got, dfeats, plain):
    """|kernel - plain| over the tolerance (bf16), entry by entry: each
    layer's weight and bias gradient, then the feature gradient; every
    gradient bf16-exact."""
    ref_f, refs, sums, s_f = plain
    ratios = []
    for g, ref, s in zip([*got, dfeats], [*refs, ref_f], [*sums, s_f]):
        assert is_bf16(g)
        ratios.append((g - ref).abs()
                      / cuda_lib.sum_order_tolerance(ref, s, True))
    return ratios


def check_grads(got, dfeats, plain):
    """The kernel's parameter and feature gradients against ``plain``."""
    ratios = grad_ratios(got, dfeats, plain)
    for i, ratio in enumerate(ratios):
        worst = GRAD_MAX if i < len(ratios) - 1 else FEAT_MAX
        assert float((ratio > 1).float().mean()) <= GRAD_SHARE, i
        assert float(ratio.max()) <= worst, (i, float(ratio.max()))


def kernel_grads(m, feats, dirs, cot, density_only=False):
    """The kernel path's outputs and (dfeats, [param grads])."""
    f = feats.detach().clone().requires_grad_(True)
    for p in m.parameters():
        p.grad = None
    if density_only:
        raw, geo = m.density(f, BF16)
        outs = (torch.cat([raw, geo], dim=-1),)
    else:
        outs = m(f, dirs, BF16)
    torch.autograd.backward(outs, cot)
    params = [p for layer in (list(m.sig) if density_only
                              else list(m.sig) + list(m.col))
              for p in (layer.weight, layer.bias)]
    # detached, so that no graph keeps the parameters' accumulators (bound
    # to this stream) alive for a later capture
    return ([o.detach() for o in outs], f.grad,
            [p.grad.clone() for p in params], params)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("acts", [("sigmoid", "leaky_relu"), ("elu", "sdf")])
def test_kernel_matches_composed(cuda_device, shape, acts):
    in_dim, d_view = SHAPES[shape]
    cfg = C.MLPConfig(rgb_activation=acts[0], density_activation=acts[1])
    n = 20_011                               # not a multiple of the tile
    m, feats, dirs = make(cfg, in_dim, d_view, n, cuda_device)
    rng = np.random.default_rng(1)
    cot = (torch.tensor(rng.normal(0, 1, (n, 3)), dtype=torch.float32,
                        device=cuda_device),
           torch.tensor(rng.normal(0, 1, (n,)), dtype=torch.float32,
                        device=cuda_device))
    launches, composed_calls = mlp_kernel.launches, mlp_kernel.composed_calls
    outs, dfeats, got, _ = kernel_grads(m, feats, dirs, cot)
    torch.cuda.synchronize()
    assert mlp_kernel.launches == launches + 2
    assert mlp_kernel.composed_calls == composed_calls
    with torch.no_grad():
        raw, geo = m._density(feats, BF16)          # MLP3D's composed path
        ref = (m.color(geo, dirs, BF16),
               mlp.apply_density_activation(raw, cfg)[..., 0])
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)
    check_grads(got, dfeats, mlp_kernel.plain_backward(m, feats, dirs, cot))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_no_grad_forward_matches_composed(cuda_device, shape):
    """Serving's and the refresh's forward (no gradient follows), full and
    density-only form, on the tensor cores."""
    in_dim, d_view = SHAPES[shape]
    cfg = C.MLPConfig(rgb_activation="elu", density_activation="sdf")
    m, feats, dirs = make(cfg, in_dim, d_view, 20_011, cuda_device, seed=4)
    with torch.no_grad():
        raw, geo = m._density(feats, BF16)
        pairs = [(m(feats, dirs, BF16),
                  (m.color(geo, dirs, BF16),
                   mlp.apply_density_activation(raw, cfg)[..., 0])),
                 (m.density(feats, BF16), (raw, geo))]
    for got, ref in pairs:
        for a, b in zip(got, ref):
            err = (a - b).abs()
            assert float((err > 1e-5).float().mean()) <= FLIP_SHARE
            assert float(err.max()) <= OUT_MAX


@pytest.mark.cuda
@pytest.mark.parametrize("sdf", [False, True])
def test_density_form_matches_composed(cuda_device, sdf):
    """The density branch alone (the occupancy refresh, the SDF normals),
    with an arbitrary f32 cotangent on all 16 columns."""
    in_dim = SHAPES["cp"][0]
    cfg = C.MLPConfig(density_activation="sdf" if sdf else "leaky_relu")
    n = 9_999
    m, feats, _ = make(cfg, in_dim, 24, n, cuda_device, seed=2)
    cot = (torch.tensor(np.random.default_rng(3).normal(0, 1, (n, 16)),
                        dtype=torch.float32, device=cuda_device),)
    outs, dfeats, got, _ = kernel_grads(m, feats, None, cot,
                                        density_only=True)
    for layer in m.col:
        assert layer.weight.grad is None
    with torch.no_grad():
        raw, geo = m._density(feats, BF16)
    assert torch.equal(outs[0], torch.cat([raw, geo], dim=-1))
    check_grads(got, dfeats, mlp_kernel.plain_backward(
        m, feats, None, cot, density_only=True))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_ragged_tile_gradients(cuda_device, shape):
    """A cotangent on the last, partial tile alone (27 of 20,011 points):
    the other rows' feature gradient is exactly zero, and every entry of
    every gradient, the weights' sums of 27 points each, lies within the
    tolerance of the plain backward's."""
    in_dim, d_view = SHAPES[shape]
    n = 20_011
    tail = n % 64                            # csrc/mlp.cu TM
    m, feats, dirs = make(C.MLPConfig(), in_dim, d_view, n, cuda_device,
                          seed=5)
    rng = np.random.default_rng(6)
    cot = (torch.zeros((n, 3), device=cuda_device),
           torch.zeros((n,), device=cuda_device))
    cot[0][-tail:] = torch.tensor(rng.normal(0, 1, (tail, 3)),
                                  dtype=torch.float32, device=cuda_device)
    cot[1][-tail:] = torch.tensor(rng.normal(0, 1, (tail,)),
                                  dtype=torch.float32, device=cuda_device)
    _, dfeats, got, _ = kernel_grads(m, feats, dirs, cot)
    assert not dfeats[:n - tail].any()
    assert bool(dfeats[n - tail:].abs().sum(dim=1).gt(0).all())
    ratios = grad_ratios(got, dfeats, mlp_kernel.plain_backward(
        m, feats, dirs, cot))
    for i, ratio in enumerate(ratios):
        assert float(ratio.max()) <= 1.0, (i, float(ratio.max()))


@pytest.mark.cuda
def test_kernel_repeatable_empty_and_graphed(cuda_device):
    """Two backwards give bitwise-equal gradients (no atomics); an empty
    batch launches nothing; a captured forward and backward replays to the
    eager call's values bit for bit."""
    in_dim, d_view = SHAPES["cp"]
    m, feats, dirs = make(C.MLPConfig(), in_dim, d_view, 50_000, cuda_device)
    cot = (torch.randn((50_000, 3), device=cuda_device),
           torch.randn((50_000,), device=cuda_device))
    runs = [kernel_grads(m, feats, dirs, cot) for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1])
    for a, b in zip(runs[0][2], runs[1][2]):
        assert torch.equal(a, b)

    n = mlp_kernel.launches
    empty = kernel_grads(m, feats[:0], dirs[:0], (cot[0][:0], cot[1][:0]))
    assert empty[0][0].shape == (0, 3) and empty[1].shape == (0, in_dim)
    assert all(float(g.abs().sum()) == 0 for g in empty[2])
    assert mlp_kernel.launches == n

    f = feats.clone().requires_grad_(True)
    static = {}

    def step():
        for p in m.parameters():
            p.grad = None
        f.grad = None
        rgb, dens = m(f, dirs, BF16)
        # the same cotangents, made inside the capture
        ((rgb * cot[0]).sum() + (dens * cot[1]).sum()).backward()
        static["out"] = (rgb, dens)

    side = torch.cuda.Stream()        # warm-up and capture, as step.Captured
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        step()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static["out"][0], runs[0][0][0])
    assert torch.equal(static["out"][1], runs[0][0][1])
    assert torch.equal(f.grad, runs[0][1])
    params = [p for layer in list(m.sig) + list(m.col)
              for p in (layer.weight, layer.bias)]
    for p, ref in zip(params, runs[0][2]):
        assert torch.equal(p.grad, ref)
