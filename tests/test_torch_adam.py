"""Adam's update of a parameter group (ops/adam_kernel.py): the plain foreach
passes against optax's closed form on the CPU, and the one-pass CUDA kernel
(csrc/adam.cu) against those foreach passes on the card, bit for bit.

The ``cuda``-marked tests need the card and skip elsewhere; this file imports
no JAX, so on the card's machine it runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_adam.py

The kernel takes the foreach sequence's f32 operations in its order, with
the same roundings and the same fused multiply-adds, so every parameter and
moment it writes must equal the foreach passes' bit for bit, at every size
(a partial last quad of 1 or 3 elements, a whole one, a tensor of 2^26
entries), for lists longer than one launch's parameter block, for tensors
not 16-byte aligned (the kernel's scalar path), for a gradient of None,
with and without weight decay, eagerly and replayed in a CUDA graph whose
count, rate and bias corrections advance on the device.
"""

import math

import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu_torch.ops import adam_kernel
from human_body_reconstruction_tpu_torch.train import state

B1, B2 = adam_kernel.B1, adam_kernel.B2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def group(sizes, seed, device, none_grad=()):
    """Parameters, gradients (None at ``none_grad``) and moments of a group
    with a few steps of history: gradients spread over 12 decades, some
    exact zeros, the second moment at least the first's square."""
    rng = np.random.default_rng(seed)

    def arr(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    ps, gs, ms, vs = [], [], [], []
    for i, n in enumerate(sizes):
        scale = 10.0 ** rng.uniform(-9, 3, n)
        g = rng.normal(0, 1, n) * scale * (rng.random(n) > 0.05)
        m = 0.3 * rng.normal(0, 1, n) * scale
        ps.append(arr(rng.normal(0, 1, n)))
        gs.append(None if i in none_grad else arr(g))
        ms.append(arr(m))
        vs.append(arr(m * m + (rng.normal(0, 1, n) * scale) ** 2))
    return ps, gs, ms, vs


def clone(ts):
    return [None if t is None else t.clone() for t in ts]


def scalars(count: int, rate: float, device):
    """(rate, bc1, bc2) as GroupedOptimizer.step makes them at ``count``."""
    c1 = torch.tensor(float(count), device=device) + 1.0
    return (torch.tensor(rate, dtype=torch.float32, device=device),
            1.0 - torch.pow(B1, c1), 1.0 - torch.pow(B2, c1))


def closed_form(p, g, m, v, count, rate, eps, wd):
    """optax's adam / adamw on f64 numpy arrays, one update at ``count``."""
    g = np.zeros_like(p) if g is None else g
    m = B1 * m + (1 - B1) * g
    v = B2 * v + (1 - B2) * g * g
    upd = (m / (1 - B1 ** (count + 1))) / (
        np.sqrt(v / (1 - B2 ** (count + 1))) + eps) + wd * p
    return p - rate * upd, m, v


@pytest.mark.parametrize("eps,wd", [(1e-15, 0.0), (1e-8, 0.05)],
                         ids=["adam", "adamw"])
def test_plain_matches_closed_form(eps, wd):
    """Two updates of the CPU path (``update`` takes the foreach passes
    there) against optax's form in f64, one gradient None: the moments and
    each parameter's change (a decay of 0.05 so that its term shows)."""
    rng = np.random.default_rng(1)
    sizes = [5, 17, 64]

    def arr(x):
        return torch.tensor(np.asarray(x, np.float32))

    ps = [arr(rng.normal(0, 1, n)) for n in sizes]
    ms = [arr(rng.normal(0, 0.03, n)) for n in sizes]
    vs = [m * m + arr(rng.uniform(0, 0.01, n)) for m, n in zip(ms, sizes)]
    p0 = [p.double().numpy() for p in ps]
    want = [[t.double().numpy() for t in (p, m, v)]
            for p, m, v in zip(ps, ms, vs)]
    launches = adam_kernel.launches
    for count, rate in ((3, 1e-2), (4, 7e-3)):
        gs = [None if i == 1 else arr(rng.normal(0, 0.1, n))
              for i, n in enumerate(sizes)]
        adam_kernel.update(ps, gs, ms, vs, *scalars(count, rate, "cpu"), eps,
                           wd)
        want = [closed_form(p, None if g is None else g.double().numpy(), m,
                            v, count, rate, eps, wd)
                for (p, m, v), g in zip(want, gs)]
    assert adam_kernel.launches == launches
    for p, m, v, a, (wp, wm, wv) in zip(ps, ms, vs, p0, want):
        np.testing.assert_allclose(m.double().numpy(), wm, rtol=1e-5,
                                   atol=1e-8)
        np.testing.assert_allclose(v.double().numpy(), wv, rtol=1e-5)
        np.testing.assert_allclose(p.double().numpy() - a, wp - a,
                                   rtol=1e-4, atol=2e-7)


def test_group_takes_the_wrapper():
    """``AdamGroup.update`` is the wrapper's update at its schedule's rate."""
    ps, gs, ms, vs = group([9, 33], 2, "cpu")
    params = [torch.nn.Parameter(p.clone()) for p in ps]
    for q, g in zip(params, gs):
        q.grad = g.clone()
    grp = state.AdamGroup(params, lambda c: torch.full_like(
        c, 3e-3, dtype=torch.float32), eps=1e-8, weight_decay=1e-4)
    for mg, vg, m, v in zip(grp.exp_avg, grp.exp_avg_sq, ms, vs):
        mg.copy_(m)
        vg.copy_(v)
    count = torch.tensor(6, dtype=torch.int32)
    rate, bc1, bc2 = scalars(6, 3e-3, "cpu")
    grp.update(count, bc1, bc2)
    adam_kernel.update_plain(ps, gs, ms, vs, rate, bc1, bc2, 1e-8, 1e-4)
    for a, b in zip((*params, *grp.exp_avg, *grp.exp_avg_sq), (*ps, *ms, *vs)):
        assert torch.equal(a.detach(), b)
    assert float(grp.lr) == pytest.approx(3e-3)


def test_unsupported_device_raises():
    p = torch.zeros(4, device="meta")
    one = torch.ones((), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        adam_kernel.update([p], [None], [p], [p], one, one, one, 1e-8)


def bits(t):
    return t.view(torch.int32)


def assert_same(got, want):
    for a, b in zip(got, want):
        assert torch.equal(bits(a), bits(b)), (
            f"{int((bits(a) != bits(b)).sum())} of {a.numel()} differ")


SIZES = {"1": [1], "3": [3], "4": [4], "1000003": [1_000_003],
         "2^26": [1 << 26], "list": [4, 1, 4096, 3, 77, 1 << 20, 2]}


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 1e-4], ids=["adam", "adamw"])
@pytest.mark.parametrize("sizes", list(SIZES), ids=list(SIZES))
def test_kernel_equals_foreach(cuda_device, sizes, wd):
    """Two eager updates, the kernel against the foreach passes, bit for
    bit; the list case has a gradient of None."""
    sz = SIZES[sizes]
    ps, gs, ms, vs = group(sz, 3, cuda_device,
                           none_grad=(1,) if len(sz) > 1 else ())
    ref = [clone(x) for x in (ps, gs, ms, vs)]
    eps = 1e-15 if wd == 0.0 else 1e-8
    for count, rate in ((0, 1e-2), (1, 5e-3)):
        sc = scalars(count, rate, cuda_device)
        adam_kernel.update(ps, gs, ms, vs, *sc, eps, wd)
        adam_kernel.update_plain(*ref, *sc, eps, wd)
    torch.cuda.synchronize()
    assert_same((*ps, *ms, *vs), (*ref[0], *ref[2], *ref[3]))


@pytest.mark.cuda
def test_kernel_long_and_unaligned_lists(cuda_device):
    """70 tensors (two launches' parameter blocks), each a view one element
    into its storage (no 16-byte alignment: the scalar path)."""
    sizes = [int(s) for s in np.random.default_rng(4).integers(1, 3000, 70)]
    ps, gs, ms, vs = group([s + 1 for s in sizes], 4, cuda_device,
                           none_grad=(5, 69))
    ps, gs, ms, vs = [[None if t is None else t[1:] for t in x]
                      for x in (ps, gs, ms, vs)]
    ref = [clone(x) for x in (ps, gs, ms, vs)]
    launches = adam_kernel.launches
    sc = scalars(2, 1e-3, cuda_device)
    adam_kernel.update(ps, gs, ms, vs, *sc, 1e-8, 1e-4)
    adam_kernel.update_plain(*ref, *sc, 1e-8, 1e-4)
    torch.cuda.synchronize()
    assert_same((*ps, *ms, *vs), (*ref[0], *ref[2], *ref[3]))
    assert adam_kernel.launches == launches + 1
    assert adam_kernel.fused_elements == sum(sizes)


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 1e-4], ids=["adam", "adamw"])
def test_kernel_in_graph_equals_foreach(cuda_device, wd):
    """One capture of a step that advances the count on the device, takes
    the schedule's rate and the bias corrections there and updates two
    copies of a group, by the kernel and by the foreach passes; three
    replays with fresh gradients; equal bit for bit, and the kernel
    launched from the host at the warm-up and the capture only."""
    ps, gs, ms, vs = group([1, 3, 4, 1_000_003, 4096], 5, cuda_device,
                           none_grad=(2,))
    ref = [clone(x) for x in (ps, gs, ms, vs)]
    eps = 1e-15 if wd == 0.0 else 1e-8
    count = torch.zeros((), dtype=torch.int32, device=cuda_device)
    sched = state.cosine_to_floor_t(1e-2, 1e-4, 10)

    def step():
        c1 = count.to(torch.float32) + 1.0
        bc1, bc2 = 1.0 - torch.pow(B1, c1), 1.0 - torch.pow(B2, c1)
        rate = sched(count)
        adam_kernel.update(ps, gs, ms, vs, rate, bc1, bc2, eps, wd)
        adam_kernel.update_plain(*ref, rate, bc1, bc2, eps, wd)
        count.add_(1)

    launches = adam_kernel.launches
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        step()
    assert adam_kernel.launches == launches + 2
    gen = np.random.default_rng(6)
    for _ in range(3):
        for g, r in zip(gs, ref[1]):
            if g is not None:
                new = torch.tensor(gen.normal(0, 1e-2, g.numel()),
                                   dtype=torch.float32, device=cuda_device)
                g.copy_(new)
                r.copy_(new)
        graph.replay()
    torch.cuda.synchronize()
    assert int(count) == 4
    assert adam_kernel.launches == launches + 2
    assert_same((*ps, *ms, *vs), (*ref[0], *ref[2], *ref[3]))


@pytest.mark.cuda
def test_kernel_counters(cuda_device):
    """``launches`` counts host calls (one a group), ``fused_elements`` the
    last call's elements; an empty group launches nothing."""
    ps, gs, ms, vs = group([10, 4096, 7], 7, cuda_device)
    sc = scalars(0, 1e-3, cuda_device)
    launches = adam_kernel.launches
    adam_kernel.update(ps, gs, ms, vs, *sc, 1e-8)
    assert adam_kernel.launches == launches + 1
    assert adam_kernel.fused_elements == 4113
    adam_kernel.update(ps[:1], gs[:1], ms[:1], vs[:1], *sc, 1e-8)
    adam_kernel.update([], [], [], [], *sc, 1e-8)
    torch.cuda.synchronize()
    assert adam_kernel.launches == launches + 2
    assert adam_kernel.fused_elements == 10


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["float64", "strided", "cpu_rate"])
def test_kernel_refuses(cuda_device, fault):
    """A CUDA group the kernel does not take raises; nothing falls back."""
    ps, gs, ms, vs = group([8], 8, cuda_device)
    rate, bc1, bc2 = scalars(0, 1e-3, cuda_device)
    if fault == "float64":
        ms = [ms[0].double()]
    elif fault == "strided":
        gs = [torch.zeros(16, device=cuda_device)[::2]]
    else:
        rate = rate.cpu()
    with pytest.raises(ValueError):
        adam_kernel.update(ps, gs, ms, vs, rate, bc1, bc2, 1e-8)


@pytest.mark.cuda
def test_optimizer_windows_launch_once_a_group(cuda_device):
    """A GroupedOptimizer over a small field's three groups, captured as a
    window would be: one host launch a group at the warm-up and at the
    capture, none at the replays, and every CUDA group through the
    kernel."""
    from human_body_reconstruction_tpu_torch.utils import config as C

    class Field(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dense, self.lines = [], []
            self.table = torch.nn.Parameter(torch.randn(4096, 8))
            self.mlp = torch.nn.Linear(8, 4)
            self.var_b = torch.nn.Parameter(torch.tensor(0.3))

    field = Field().to(cuda_device)
    opt = state.GroupedOptimizer(C.TrainConfig(), 100, field)
    assert len(opt.groups) == 3
    x = torch.randn(64, 8, device=cuda_device)

    def step():
        opt.zero_grad()
        out = field.mlp(x + field.table[:64]) * field.var_b
        out.square().mean().backward()
        opt.step()

    launches = adam_kernel.launches
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        step()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert adam_kernel.launches == launches + 6
    assert int(opt.count) == 4
    assert all(math.isfinite(float(p.abs().max()))
               for p in field.parameters())
