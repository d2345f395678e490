"""The port's CUDA kernels against their plain PyTorch versions.

The ``cuda``-marked tests need the card and skip elsewhere; this file
imports no JAX, so on the card's machine it runs without the repo's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

The forward kernels and their plain versions do the same f32 operations in
the same order (csrc/encoders.cu uses the non-contracting _rn intrinsics),
so they are held to 1e-6.  The backward kernels compute the same terms but
sum them with f32 atomics, in an order that changes from run to run (the
plain versions' index_add_ is atomic on the card too), and round the sums
to bf16: they are held elementwise to ``cuda_lib.sum_order_tolerance``:
one bf16 ulp of the plain value (bf16 only), plus 2^-18 of the entry's sum
of absolute terms (from the plain backward of |tables| and |gradient|),
plus 1e-6.  The unmarked tests check the build and launch plumbing that
runs on any machine, and read that tolerance at the training path's shape
against the plain backwards summed in another order and with planted
faults.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu_torch.ops import (
    cp_kernel, cuda_lib, dense_grid, dense_kernel, hash_encoding, hash_kernel,
    hash_variants, lowrank, rng_kernel)
from human_body_reconstruction_tpu_torch.utils import config as C
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6


def small_cfg(bf16: bool) -> C.HashConfig:
    base = C.HashConfig(num_levels=4, n_max=128, variant="cp", cp_rank=8,
                        dense_bf16=bf16)
    return dataclasses.replace(base,
                               dense_levels=dense_grid.auto_dense_levels(base))


def tables(cfg, device, n=1000, seed=0):
    rng = np.random.default_rng(seed)
    grids = [torch.tensor(rng.uniform(-1, 1, (g, g, g, cfg.features_per_level)),
                          dtype=torch.float32, device=device)
             for g in dense_grid.dense_grid_sizes(cfg)]
    lines = [torch.tensor(rng.uniform(-1, 1, (3, g, cfg.cp_rank)),
                          dtype=torch.float32, device=device)
             for g in lowrank.cp_line_sizes(cfg)]
    mu = torch.tensor([-1.0, -2.0, -0.5], device=device)
    sigma = torch.tensor(3.0, device=device)
    xn = torch.tensor(rng.uniform(-0.3, 1.3, (n, 3)), dtype=torch.float32,
                      device=device)
    return grids, lines, (mu + xn * sigma, mu, sigma, cfg)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def max_err(a, b) -> float:
    return float((a - b).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_kernels_match_plain(cuda_device, bf16):
    grids, lines, args = tables(small_cfg(bf16), cuda_device)
    n_cp = cp_kernel.cp_encode_kernel.launches
    n_dense = dense_kernel.dense_encode_kernel.launches
    got = cp_kernel.cp_encode_kernel(lines, *args)
    torch.cuda.synchronize()
    assert max_err(got, cp_kernel.cp_encode_plain(lines, *args)) <= TOL
    got = dense_kernel.dense_encode_kernel(grids, *args)
    torch.cuda.synchronize()
    assert max_err(got, dense_kernel.dense_encode_plain(grids, *args)) <= TOL
    assert cp_kernel.cp_encode_kernel.launches == n_cp + 1
    assert dense_kernel.dense_encode_kernel.launches == n_dense + 1


@pytest.mark.cuda
def test_kernels_full_width_and_strided_out(cuda_device):
    """Full-width preset tables; both kernels writing column blocks of one
    wider matrix, as the encoder does; an empty batch launches nothing."""
    h = C.flagship_config().hash
    grids, lines, args = tables(h, cuda_device, n=50_001)
    d = h.dense_levels * h.features_per_level
    out = torch.full((50_001, h.out_dim + 5), float("nan"), device=cuda_device)
    dense_kernel.dense_encode_kernel(grids, *args, out=out[:, :d])
    cp_kernel.cp_encode_kernel(lines, *args, out=out[:, d:h.out_dim])
    torch.cuda.synchronize()
    assert max_err(out[:, :d], dense_kernel.dense_encode_plain(grids, *args)) <= TOL
    assert max_err(out[:, d:h.out_dim],
                   cp_kernel.cp_encode_plain(lines, *args)) <= TOL
    assert torch.isnan(out[:, h.out_dim:]).all()
    n = cp_kernel.cp_encode_kernel.launches
    empty = (args[0][:0],) + args[1:]
    assert cp_kernel.cp_encode_kernel(lines, *empty).shape == (0, 125)
    assert cp_kernel.cp_encode_kernel.launches == n


@pytest.mark.cuda
def test_kernels_reject_bad_inputs(cuda_device):
    grids, lines, args = tables(small_cfg(True), cuda_device)
    with pytest.raises(ValueError):          # tables on another device
        cp_kernel.cp_encode_kernel([l.cpu() for l in lines], *args)
    with pytest.raises(ValueError):          # output of the wrong width
        dense_kernel.dense_encode_kernel(
            grids, *args, out=torch.empty((1000, 3), device=cuda_device))


def test_levels_struct_and_limits():
    lv = cuda_lib.make_levels([73, 154], [0, 73], np.float32([71.0, 152.5]))
    assert lv.n_levels == 2 and list(lv.size[:2]) == [73, 154]
    assert list(lv.offset[:2]) == [0, 73] and lv.scale[1] == 152.5
    with pytest.raises(ValueError):
        cuda_lib.make_levels([4] * 17, [0] * 17, [1.0] * 17)


def test_library_path_keyed_on_sources():
    p = cuda_lib.library_path()
    assert p.parent == cuda_lib.BUILD_DIR
    assert p.name.startswith("libhbr_kernels_") and p.suffix == ".so"
    assert p == cuda_lib.library_path()
    assert (cuda_lib.CSRC_DIR / "encoders.cu").exists()


def test_check_out_validation():
    dev = torch.device("cpu")
    ok = torch.empty((10, 12))[:, 2:9]
    cuda_lib.check_out(ok, 10, 7, dev)
    for bad in (torch.empty((10, 7), dtype=torch.float64),
                torch.empty((10, 8))[:, :7].t().contiguous().t()[:, :7],
                torch.empty((9, 7))):
        with pytest.raises(ValueError):
            cuda_lib.check_out(bad, 10, 7, dev)


def grads_close(kern, plain, tables, args, g, bf16: bool) -> bool:
    """Kernel vs plain backward within the tolerance of the module
    docstring, for every table."""
    got = kern(tables, *args, g)
    want = plain(tables, *args, g)
    abs_sum = plain([t.abs() for t in tables], *args, g.abs())
    torch.cuda.synchronize()
    return all(a.shape == b.shape and bool(
        ((a - b).abs() <= cuda_lib.sum_order_tolerance(b, s, bf16)).all())
        for a, b, s in zip(got, want, abs_sum))


def cotangent(n, c, device, seed=1, extra=3):
    """A seeded (n, c) gradient read through a row stride of c + extra."""
    g = torch.randn((n, c + extra), generator=torch.Generator().manual_seed(seed))
    return g.to(device)[:, extra:]


@pytest.mark.parametrize("encoder", ["cp", "dense"])
def test_sum_order_tolerance_rejects_faults(encoder, monkeypatch):
    """The backward tolerance read from both sides at the training path's
    shape (768,000 points, the preset's tables, bf16), on the CPU.  The
    plain backward summed in another point order stays within it (measured
    0.987 CP, 0.989 dense).  Three planted faults exceed it (measured 305 /
    62 for one point's terms dropped, 3.6e4 / 1.3e5 for the lo and hi lerp
    weights swapped in the scatter, 64 / 463 for dT, or in the dense
    backward the gradient and its x fold, not rounded to bf16)."""
    h = C.flagship_config().hash
    n = 768_000
    grids, lines, (x, mu, sigma, _) = tables(h, "cpu", n=n)
    d = h.dense_levels * h.features_per_level
    g = cotangent(n, h.out_dim, "cpu")
    if encoder == "cp":
        mod, tabs, cols = cp_kernel, lines, g[:, d:]
        plain = cp_kernel.cp_encode_plain_backward
    else:
        mod, tabs, cols = dense_kernel, grids, g[:, :d]
        plain = dense_kernel.dense_encode_plain_backward

    def run(pts=x, grad=cols):
        return plain(tabs, pts, mu, sigma, h, grad)

    want = run()
    abs_sum = plain([t.abs() for t in tabs], x, mu, sigma, h, cols.abs())

    def reading(got):
        return max(float(((a - b).abs()
                          / cuda_lib.sum_order_tolerance(b, s, True)).max())
                   for a, b, s in zip(got, want, abs_sum))

    perm = torch.randperm(n, generator=torch.Generator().manual_seed(2))
    assert reading(run(x[perm], cols[perm])) <= 1.0
    dropped = cols.clone()
    dropped[0] = 0.0
    faults = {"dropped point": run(grad=dropped)}
    with monkeypatch.context() as mp:
        if encoder == "cp":
            lerps = cp_kernel._lerps
            mp.setattr(cp_kernel, "_lerps", lambda *a: [
                (hi, lo, t) for lo, hi, t in lerps(*a)])
        else:
            weights = dense_kernel._weights

            def swapped(*a):
                x0, wx, pair = weights(*a)
                return x0, wx[::-1], pair

            mp.setattr(dense_kernel, "_weights", swapped)
        faults["swapped weights"] = run()
    with monkeypatch.context() as mp:
        # the per-point (N, columns > 1) tensors are the only ones of that
        # shape the backwards round: dT (CP), the gradient and its x fold
        # (dense)
        mp.setattr(mod, "round_bf16", lambda v: v if (
            v.dim() == 2 and v.shape[0] == n and v.shape[1] > 1)
            else dense_grid.round_bf16(v))
        faults["unrounded dT"] = run()
    for name, got in faults.items():
        assert reading(got) > 1.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_backward_kernels_match_plain(cuda_device, bf16):
    cfg = small_cfg(bf16)
    grids, lines, args = tables(cfg, cuda_device)
    d = cfg.dense_levels * cfg.features_per_level
    g = cotangent(1000, cfg.out_dim, cuda_device)
    n_cp = cp_kernel.cp_encode_backward_kernel.launches
    n_dense = dense_kernel.dense_encode_backward_kernel.launches
    assert grads_close(cp_kernel.cp_encode_backward_kernel,
                       cp_kernel.cp_encode_plain_backward, lines, args,
                       g[:, d:], bf16)
    assert grads_close(dense_kernel.dense_encode_backward_kernel,
                       dense_kernel.dense_encode_plain_backward, grids, args,
                       g[:, :d], bf16)
    assert cp_kernel.cp_encode_backward_kernel.launches == n_cp + 1
    assert dense_kernel.dense_encode_backward_kernel.launches == n_dense + 1


@pytest.mark.cuda
def test_backward_kernels_full_width(cuda_device):
    """The preset's tables (the coarsest dense grid accumulating in shared
    memory, every other add going to L2) and a strided gradient."""
    h = C.flagship_config().hash
    grids, lines, args = tables(h, cuda_device, n=200_003)
    d = h.dense_levels * h.features_per_level
    g = cotangent(200_003, h.out_dim, cuda_device, extra=5)
    assert grads_close(cp_kernel.cp_encode_backward_kernel,
                       cp_kernel.cp_encode_plain_backward, lines, args,
                       g[:, d:], True)
    assert grads_close(dense_kernel.dense_encode_backward_kernel,
                       dense_kernel.dense_encode_plain_backward, grids, args,
                       g[:, :d], True)
    n = cp_kernel.cp_encode_backward_kernel.launches
    empty = (args[0][:0],) + args[1:]
    zero = cp_kernel.cp_encode_backward_kernel(lines, *empty, g[:0, d:])
    assert all(not z.any() for z in zero)
    assert cp_kernel.cp_encode_backward_kernel.launches == n


@pytest.mark.cuda
def test_backward_kernels_reject_bad_inputs(cuda_device):
    cfg = small_cfg(True)
    grids, lines, args = tables(cfg, cuda_device)
    d = cfg.dense_levels * cfg.features_per_level
    g = cotangent(1000, cfg.out_dim, cuda_device)
    for call in (
            lambda: cp_kernel.cp_encode_backward_kernel(     # CPU gradient
                lines, *args, g[:, d:].cpu()),
            lambda: cp_kernel.cp_encode_backward_kernel(     # wrong width
                lines, *args, g[:, d + 1:]),
            lambda: dense_kernel.dense_encode_backward_kernel(  # f64
                grids, *args, g[:, :d].double()),
            lambda: dense_kernel.dense_encode_backward_kernel(  # column stride
                grids, *args, g[:, :2 * d:2])):
        with pytest.raises(ValueError):
            call()


@pytest.mark.cuda
def test_encode_params_gives_every_table_a_gradient(cuda_device):
    """On the card the encoder's tables stay in the autograd graph: a loss
    through encode_params reaches every grid and line, through the kernels."""
    cfg = small_cfg(True)
    grids, lines, (x, mu, sigma, _) = tables(cfg, cuda_device)
    params = [t.requires_grad_() for t in grids + lines]
    launches = (cp_kernel.cp_encode_backward_kernel.launches,
                dense_kernel.dense_encode_backward_kernel.launches)
    feats = hash_encoding.encode_params({"dense": grids, "lines": lines}, x,
                                        mu, sigma, cfg)
    assert feats.grad_fn is not None
    (feats * cotangent(1000, cfg.out_dim, cuda_device)).sum().backward()
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in params)
    assert (cp_kernel.cp_encode_backward_kernel.launches,
            dense_kernel.dense_encode_backward_kernel.launches) == tuple(
                n + 1 for n in launches)


def hash_inputs(device, n=2000, levels=4, log2_t=10, seed=0, features=2):
    """A corner-variant config, a U(-1, 1) table, world points with a
    quarter outside the unit box of normalised coordinates, and uniforms."""
    cfg = C.HashConfig(num_levels=levels, log2_table_size=log2_t, n_max=512,
                       features_per_level=features, variant="corner",
                       stochastic_train=True)
    rng = np.random.default_rng(seed)
    table = torch.tensor(rng.uniform(-1, 1, (levels, 2 ** log2_t, features)),
                         dtype=torch.float32, device=device)
    xn = rng.uniform(0, 1, (n, 3))
    xn[: n // 4, 0] = rng.uniform(-0.5, 0.0, n // 4)
    mu = torch.tensor([-1.0, -2.0, -0.5], device=device)
    sigma = torch.tensor([3.0, 2.5, 4.0], device=device)
    x = mu + torch.tensor(xn, dtype=torch.float32, device=device) * sigma
    u = torch.tensor(rng.uniform(0, 1, (3, levels, n)), dtype=torch.float32,
                     device=device)
    return table, (x, mu, sigma, cfg), u


def test_hash_wrappers_on_cpu_run_plain():
    """On CPU tensors the wrappers are the plain versions (no launch), and
    refuse what the kernels would read out of bounds."""
    table, args, u = hash_inputs(torch.device("cpu"))
    n = (hash_kernel.hash_encode_kernel.launches,
         hash_kernel.hash_encode_backward_kernel.launches,
         rng_kernel.uniform_kernel.launches)
    g = cotangent(2000, 8, "cpu")
    for uu in (None, u):
        got = hash_kernel.hash_encode_kernel(table, *args, u=uu)
        want = hash_kernel.hash_encode_plain(table, *args, u=uu)
        bits = None
        if uu is not None:
            (got, bits), (want, want_bits) = got, want
            assert torch.equal(bits, want_bits)
        assert torch.equal(got, want)
        assert torch.equal(
            hash_kernel.hash_encode_backward_kernel(table, *args, g, bits=bits),
            hash_kernel.hash_encode_plain_backward(table, *args, g, u=uu))
    seed = torch.tensor([4], dtype=torch.int32)
    assert torch.equal(rng_kernel.uniform(seed, (3, 5)),
                       rng_kernel.uniform_plain(seed, (3, 5)))
    assert n == (hash_kernel.hash_encode_kernel.launches,
                 hash_kernel.hash_encode_backward_kernel.launches,
                 rng_kernel.uniform_kernel.launches)
    for bad in (lambda: hash_kernel.hash_encode_kernel(table[:3], *args),
                lambda: hash_kernel.hash_encode_kernel(table.double(), *args),
                lambda: hash_kernel.hash_encode_kernel(table, *args, u=u[:, :, 1:]),
                lambda: hash_kernel.hash_encode_backward_kernel(
                    table, *args, g, bits=torch.zeros((4, 2000))),
                lambda: hash_kernel.hash_encode_backward_kernel(
                    table, *args, g, bits=torch.zeros((4, 1999),
                                                      dtype=torch.uint8)),
                lambda: rng_kernel.uniform(seed.long(), (3,)),
                lambda: rng_kernel.uniform(torch.zeros(2, dtype=torch.int32),
                                           (3,))):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.cuda
def test_uniform_kernel_matches_plain_bit_for_bit(cuda_device):
    """Every length mod 4 (the ragged last counter), both outputs."""
    seed = torch.tensor([987654321], dtype=torch.int32, device=cuda_device)
    n0 = rng_kernel.uniform_kernel.launches
    for shape in ((1,), (2, 3), (7, 5, 3), (3, 16, 4097)):
        for as_float in (False, True):
            got = rng_kernel.uniform_kernel(seed, shape, as_float)
            want = rng_kernel.uniform_plain(seed, shape, as_float)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and torch.equal(got, want)
    assert rng_kernel.uniform_kernel.launches == n0 + 8
    empty = rng_kernel.uniform(seed, (0, 4))
    assert empty.shape == (0, 4) and rng_kernel.uniform_kernel.launches == n0 + 8
    u = rng_kernel.uniform(seed, (1 << 20,)).double()
    assert abs(float(u.mean()) - 0.5) < 6 / np.sqrt(12 * (1 << 20))


@pytest.mark.cuda
def test_hash_kernels_full_width_and_strided_out(cuda_device):
    """The reference preset's table (16 levels, T 2^16) writing a column
    block of a wider matrix and reading a strided gradient; an empty batch
    launches nothing."""
    table, args, u = hash_inputs(cuda_device, n=100_003, levels=16, log2_t=16)
    out = torch.full((100_003, 40), float("nan"), device=cuda_device)
    for uu in (None, u):
        bits = want_bits = None
        got = hash_kernel.hash_encode_kernel(table, *args, u=uu,
                                             out=out[:, 4:36])
        want = hash_kernel.hash_encode_plain(table, *args, u=uu)
        if uu is not None:
            (_, bits), (want, want_bits) = got, want
        torch.cuda.synchronize()
        assert max_err(out[:, 4:36], want) <= TOL
        if uu is not None:
            assert torch.equal(bits, want_bits)
        assert torch.isnan(out[:, :4]).all() and torch.isnan(out[:, 36:]).all()
        g = cotangent(100_003, 32, cuda_device, extra=7)
        assert grads_close(
            lambda tb, *a: [hash_kernel.hash_encode_backward_kernel(
                tb[0], *a, bits=bits)],
            lambda tb, *a: [hash_kernel.hash_encode_plain_backward(
                tb[0], *a, u=uu)],
            [table], args, g, False)
    n = hash_kernel.hash_encode_kernel.launches
    empty = (args[0][:0],) + args[1:]
    assert hash_kernel.hash_encode_kernel(table, *empty).shape == (0, 32)
    assert hash_kernel.hash_encode_kernel.launches == n


@pytest.mark.cuda
def test_stochastic_encode_gives_the_table_a_gradient(cuda_device):
    """Through encode_params on the card with the Philox uniforms: the table
    gets a gradient, through all three kernels."""
    table, (x, mu, sigma, cfg), _ = hash_inputs(cuda_device)
    cfg = dataclasses.replace(cfg, hw_rng=True)
    table.requires_grad_()
    launches = (rng_kernel.uniform_kernel.launches,
                hash_kernel.hash_encode_kernel.launches,
                hash_kernel.hash_encode_backward_kernel.launches)
    feats = hash_encoding.encode_params(
        {"table": table}, x, mu, sigma, cfg, stochastic=True,
        generator=torch.Generator(cuda_device).manual_seed(0))
    (feats * cotangent(2000, 8, cuda_device)).sum().backward()
    assert table.grad is not None and bool(table.grad.abs().sum() > 0)
    assert (rng_kernel.uniform_kernel.launches,
            hash_kernel.hash_encode_kernel.launches,
            hash_kernel.hash_encode_backward_kernel.launches) == tuple(
                n + 1 for n in launches)


def ray_points(n, samples, device, seed=3):
    """(world points, mu, sigma) of seeded rays through the scene box, each
    ray's samples consecutive (ray-major, as the renderer flattens them),
    cut to n points; some samples fall outside the unit box of normalised
    coordinates."""
    rng = np.random.default_rng(seed)
    rays = -(-n // samples)
    o = rng.uniform(-0.3, 1.3, (rays, 1, 3))
    d = rng.uniform(0.3, 0.7, (rays, 1, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = (np.linspace(0.0, 1.5, samples)[None, :, None]
         + rng.uniform(0.0, 1.5 / samples, (rays, samples, 1)))
    xn = torch.tensor((o + d * t).reshape(-1, 3)[:n], dtype=torch.float32,
                      device=device)
    mu = torch.tensor([-1.0, -2.0, -0.5], device=device)
    sigma = torch.tensor(3.0, device=device)
    return mu + xn * sigma, mu, sigma


@pytest.mark.cuda
@pytest.mark.parametrize("features", [2, 4])
@pytest.mark.parametrize("order", ["rays", "random"])
@pytest.mark.parametrize("mode", ["exact", "stoch"])
def test_hash_kernels_match_plain_on_rays_and_random(cuda_device, mode, order,
                                                     features):
    """Both hash kernels against their plain versions on ray-ordered points
    (a ray's 64 samples consecutive, so the backward merges its adds) and
    on random ones (a quarter outside the
    unit box); N below one run, not a multiple of a run or a block.  The
    forward bit for bit into a column block of a NaN-filled wider matrix
    (its neighbours stay NaN), with the stochastic bits bit for bit; the
    backward within the sum-order tolerance from a row-strided gradient,
    the stochastic one from the kernel's own bits."""
    stoch = mode == "stoch"
    n_f = hash_kernel.hash_encode_kernel.launches
    n_b = hash_kernel.hash_encode_backward_kernel.launches
    for n in (5, 1000, 20_011):
        table, args, u = hash_inputs(cuda_device, n=n, seed=n,
                                     features=features)
        if order == "rays":
            args = ray_points(n, 64, cuda_device) + args[3:]
        uu = u if stoch else None
        c = 4 * features
        out = torch.full((n, c + 6), float("nan"), device=cuda_device)
        got = hash_kernel.hash_encode_kernel(table, *args, u=uu,
                                             out=out[:, 2:2 + c])
        want = hash_kernel.hash_encode_plain(table, *args, u=uu)
        torch.cuda.synchronize()
        bits, want_bits = (got[1], want[1]) if stoch else (None, None)
        assert torch.equal(out[:, 2:2 + c], want[0] if stoch else want)
        assert torch.isnan(out[:, :2]).all() and torch.isnan(out[:, 2 + c:]).all()
        if stoch:
            assert bits.dtype == torch.uint8 and torch.equal(bits, want_bits)
        g = cotangent(n, c, cuda_device, seed=n, extra=5)
        assert grads_close(
            lambda tb, *a: [hash_kernel.hash_encode_backward_kernel(
                tb[0], *a, bits=bits)],
            lambda tb, *a: [hash_kernel.hash_encode_plain_backward(
                tb[0], *a, bits=want_bits)],
            [table], args, g, False)
    assert hash_kernel.hash_encode_kernel.launches == n_f + 3
    assert hash_kernel.hash_encode_backward_kernel.launches == n_b + 3


def pixel_points(n, order, device, seed=0):
    """(pixel coordinates (n, 2) of a 512x512 image, mu 0, sigma (512,
    512)), the image fit's 2-D points: in row order (``full_pred``'s) or
    drawn at random (a training batch's)."""
    if order == "rows":
        pix = torch.arange(n, device=device) % (512 * 512)
    else:
        pix = torch.randint(0, 512 * 512, (n,), device=device,
                            generator=torch.Generator(device).manual_seed(seed))
    ij = torch.stack([(pix % 512).float(), (pix // 512).float()], -1)
    return ij, torch.tensor(0.0, device=device), torch.tensor(
        [512.0, 512.0], device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["rows", "random"])
def test_hash_kernels_2d_match_plain(cuda_device, order):
    """The 2-D build at the image fit's width (L 16, F 2, T 2^18, n_max
    2^16): the forward bit for bit into a column block of a NaN-filled
    wider matrix, the backward within the sum-order tolerance from a
    row-strided gradient; N below a run, not a multiple of a run or a
    block, and a full batch; the stochastic mode refused on 2-D points."""
    cfg = C.HashConfig(num_levels=16, features_per_level=2,
                       log2_table_size=18, n_min=16, n_max=2 ** 16, dim=2)
    table = torch.empty((16, 2 ** 18, 2), device=cuda_device).uniform_(
        -1, 1, generator=torch.Generator(cuda_device).manual_seed(0))
    n_f = hash_kernel.hash_encode_kernel.launches
    n_b = hash_kernel.hash_encode_backward_kernel.launches
    for n in (5, 1000, 200_003):
        args = (table, *pixel_points(n, order, cuda_device, seed=n), cfg)
        out = torch.full((n, 38), float("nan"), device=cuda_device)
        hash_kernel.hash_encode_kernel(*args, out=out[:, 3:35])
        want = hash_kernel.hash_encode_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(out[:, 3:35], want)
        assert torch.isnan(out[:, :3]).all() and torch.isnan(out[:, 35:]).all()
        g = cotangent(n, 32, cuda_device, seed=n, extra=5)
        assert grads_close(
            lambda tb, *a: [hash_kernel.hash_encode_backward_kernel(tb[0], *a)],
            lambda tb, *a: [hash_kernel.hash_encode_plain_backward(tb[0], *a)],
            [table], args[1:], g, False)
    assert hash_kernel.hash_encode_kernel.launches == n_f + 3
    assert hash_kernel.hash_encode_backward_kernel.launches == n_b + 3
    u = torch.zeros((3, 16, 5), device=cuda_device)
    with pytest.raises(ValueError, match="3-D points only"):
        hash_kernel.hash_encode_kernel(table, *pixel_points(5, order,
                                                            cuda_device)[:3],
                                       cfg, u=u)


def test_stochastic_encoder_keeps_the_bits_not_u():
    """What the encoder's autograd Function keeps for the backward in
    stochastic mode: the picked corners' offset bits, uint8 (L, N), and no
    tensor of u's (3, L, N); exact mode keeps neither.  The table gradient
    through the kept bits equals the plain backward from u."""
    table, (x, mu, sigma, cfg), u = hash_inputs(torch.device("cpu"))
    g = cotangent(2000, 8, "cpu")
    for uu in (None, u):
        tb = table.clone().requires_grad_()
        feats = hash_encoding.encode_params({"table": tb}, x, mu, sigma, cfg,
                                            stochastic=uu is not None, u=uu)
        kept = [t for t in feats.grad_fn.saved_tensors if t is not None]
        assert not any(tuple(t.shape) == (3, 4, 2000) for t in kept)
        small = [t for t in kept if t.dtype == torch.uint8]
        if uu is None:
            assert small == []
        else:
            (bits,) = small
            assert tuple(bits.shape) == (4, 2000)
            assert torch.equal(bits, hash_kernel.hash_encode_plain(
                table, x, mu, sigma, cfg, u=uu)[1])
        (feats * g).sum().backward()
        assert torch.equal(tb.grad, hash_kernel.hash_encode_plain_backward(
            table, x, mu, sigma, cfg, g, u=uu))


def cp_cfg(rank: int, bf16: bool) -> C.HashConfig:
    return dataclasses.replace(small_cfg(bf16), cp_rank=rank)


def test_cp_pack_lines_pads_with_zeros():
    """The kernels' line layout: each level's lines stacked on the real
    columns, in the stored dtype, zero after column R, rows 16-byte
    aligned."""
    for rank, bf16 in ((25, True), (7, False), (48, True), (8, True)):
        cfg = cp_cfg(rank, bf16)
        _, lines, _ = tables(cfg, "cpu", n=4)
        packed = cp_kernel.pack_lines(lines, cfg)
        rpf = cp_kernel.padded(rank, cp_kernel.LINE_COLS)
        assert packed.shape == (3, sum(lowrank.cp_line_sizes(cfg)), rpf)
        assert packed.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert rpf % 8 == 0 and rpf - 8 < rank <= rpf
        assert (rpf * packed.element_size()) % 16 == 0
        stacked = torch.cat(lines, dim=1)
        want = dense_grid.round_bf16(stacked) if bf16 else stacked
        assert torch.equal(packed[..., :rank].float(), want)
        assert not packed[..., rank:].any()


def test_cp_kernel_inputs_at_preset_width():
    """What a launch is handed at the preset's width: normalised points,
    the (3, sum_G, 32) packed lines, each level's offset into them, and a
    backward accumulator of 28 f32 columns (16-byte rows)."""
    h = C.flagship_config().hash
    _, lines, (x, mu, sigma, _) = tables(h, "cpu", n=4)
    xn, packed, lv, sizes = cp_kernel._kernel_inputs(lines, x, mu, sigma, h)
    assert sizes == [73, 154, 324, 685, 1449]
    assert packed.shape == (3, 2685, 32) and packed.dtype == torch.bfloat16
    assert torch.equal(xn, dense_grid.normalise(x, mu, sigma))
    assert lv.n_levels == 5 and list(lv.size[:5]) == sizes
    assert list(lv.offset[:5]) == [0, 73, 227, 551, 1236]
    rp = cp_kernel.padded(25, cp_kernel.ACC_COLS)
    assert rp == 28 and (4 * rp) % 16 == 0


def test_cp_wrappers_refuse_unit_stride_breaks():
    """What the kernels would misread is refused on every device: a
    gradient or output without unit column stride, a row stride below the
    width, another dtype."""
    cfg = cp_cfg(7, True)
    _, lines, args = tables(cfg, "cpu", n=50)
    c = len(lines) * 7
    wide = torch.zeros((50, 2 * c + 3))
    overlapping = torch.as_strided(wide, (50, c), (c - 1, 1))
    for bad in (wide[:, 1:2 * c + 1:2], overlapping, wide[:, :c].double(),
                wide[:49, :c]):
        with pytest.raises(ValueError):
            cp_kernel.cp_encode_backward_kernel(lines, *args, bad)
        with pytest.raises(ValueError):
            cp_kernel.cp_encode_kernel(lines, *args, out=bad)
    cp_kernel.cp_encode_backward_kernel(lines, *args, wide[:, 3:3 + c])


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["rays", "random"])
@pytest.mark.parametrize("rank", [25, 7, 48])
@pytest.mark.parametrize("bf16", [False, True])
def test_cp_kernels_match_plain_on_rays_and_random(cuda_device, bf16, rank,
                                                   order):
    """Both CP kernels against their plain versions on ray-ordered points
    (runs of a ray's samples, so cells repeat and the backward merges its
    adds) and on random ones; N below one run, not a multiple of a run or a
    tile; the forward into a column block of a wider matrix, the backward
    from a column-offset, row-strided gradient."""
    cfg = cp_cfg(rank, bf16)
    _, lines, _ = tables(cfg, cuda_device, n=4)
    c = len(lines) * rank
    for n in (5, 1000, 20_011):
        if order == "rays":
            args = ray_points(n, 48, cuda_device) + (cfg,)
        else:
            args = tables(cfg, cuda_device, n=n, seed=n)[2]
        g = cotangent(n, c, cuda_device, seed=n, extra=5)
        out = torch.full((n, c + 6), float("nan"), device=cuda_device)
        cp_kernel.cp_encode_kernel(lines, *args, out=out[:, 2:2 + c])
        torch.cuda.synchronize()
        assert max_err(out[:, 2:2 + c],
                       cp_kernel.cp_encode_plain(lines, *args)) <= TOL
        assert torch.isnan(out[:, :2]).all()
        assert torch.isnan(out[:, 2 + c:]).all()
        assert grads_close(cp_kernel.cp_encode_backward_kernel,
                           cp_kernel.cp_encode_plain_backward, lines, args, g,
                           bf16)


@pytest.mark.cuda
def test_cp_kernels_full_width_on_ray_samples(cuda_device):
    """The preset's lines on 128-sample rays: the forward bit for bit, the
    backward within the sum-order tolerance from the encoder's strided
    gradient block."""
    h = C.flagship_config().hash
    _, lines, _ = tables(h, cuda_device, n=4)
    n = 100_003
    args = ray_points(n, 128, cuda_device, seed=11) + (h,)
    d = h.dense_levels * h.features_per_level
    g = cotangent(n, h.out_dim, cuda_device, seed=5, extra=0)
    out = torch.full((n, h.out_dim), float("nan"), device=cuda_device)
    cp_kernel.cp_encode_kernel(lines, *args, out=out[:, d:])
    torch.cuda.synchronize()
    assert max_err(out[:, d:], cp_kernel.cp_encode_plain(lines, *args)) <= TOL
    assert torch.isnan(out[:, :d]).all()
    assert grads_close(cp_kernel.cp_encode_backward_kernel,
                       cp_kernel.cp_encode_plain_backward, lines, args,
                       g[:, d:], True)


def dense_cfg(bf16: bool, features: int = 2) -> C.HashConfig:
    return dataclasses.replace(small_cfg(bf16), features_per_level=features)


def test_dense_kernel_layout_pads_levels():
    """The kernels' flat grid layout: each level from a multiple of 4
    elements, zeros between levels; at the preset's width no padding within
    and only the 18^3 grid in the backward's shared-memory budget; more
    than 8 features a level refused on every device."""
    cfg = dense_cfg(False, features=3)
    grids, _, (x, mu, sigma, _) = tables(cfg, "cpu", n=4)
    lv, offsets = dense_kernel._levels(grids, cfg)
    flat = dense_kernel._flat_grids(grids, offsets, torch.float32)
    assert all(o % dense_kernel.LEVEL_ALIGN == 0 for o in offsets)
    assert flat.numel() == offsets[-1] and lv.n_levels == len(grids)
    for l, g in enumerate(grids):
        assert lv.offset[l] == offsets[l] and lv.size[l] == g.shape[0]
        assert torch.equal(flat[offsets[l]:offsets[l] + g.numel()],
                           g.reshape(-1))
        assert not flat[offsets[l] + g.numel():offsets[l + 1]].any()
    h = C.flagship_config().hash
    grids, _, _ = tables(h, "cpu", n=4)
    _, offsets = dense_kernel._levels(grids, h)
    assert offsets == [0, 18 ** 3 * 2, 18 ** 3 * 2 + 35 ** 3 * 2 + 2]
    k = cuda_lib.shared_prefix([4 * (b - a) for a, b in zip(offsets, offsets[1:])],
                               cuda_lib.BWD_SHARED_BYTES)
    assert k == 1
    cfg9 = dense_cfg(False, features=9)
    grids9, _, args9 = tables(cfg9, "cpu", n=4)
    with pytest.raises(ValueError):
        dense_kernel.dense_encode_kernel(grids9, *args9)


def load_chip_smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_grid_sample_yardstick_computes_the_dense_encoding(direction):
    """chip_smoke.py's library yardstick of the dense kernels,
    F.grid_sample on each level's permuted volume, computes the dense
    encoding of dense_encode_plain in f32 (dense_bf16 off) on points inside
    the box (outside it the encoder clamps the cell and grid_sample pads
    with zeros), and grid_sampler_3d_backward its grids' gradient: the
    yardstick times the same work.  Tolerance 1e-5 (forward) and 1e-5 of
    the gradient's largest entry (backward): the coordinates go through
    u = 2 x_l / (G - 1) - 1 and back, a few f32 ulps of x_l."""
    cs = load_chip_smoke()
    h = dataclasses.replace(C.flagship_config().hash, dense_bf16=False)
    n = 5000
    grids, _, (_, mu, sigma, _) = tables(h, "cpu", n=4)
    rng = np.random.default_rng(7)
    xn = torch.tensor(rng.uniform(0.01, 0.99, (n, 3)), dtype=torch.float32)
    x = mu + xn * sigma
    if direction == "forward":
        got = torch.cat([o.reshape(o.shape[1], -1).t() for o in
                         cs.grid_sample_levels(cs.grid_sample_inputs(
                             grids, x, mu, sigma, h))], 1)
        want = dense_kernel.dense_encode_plain(grids, x, mu, sigma, h)
        assert got.shape == want.shape == (n, 4)
        assert max_err(got, want) <= 1e-5
    else:
        d = h.dense_levels * h.features_per_level
        g = cotangent(n, h.out_dim, "cpu")[:, :d]
        got = cs.grid_sample_backward_levels(
            cs.grid_sample_inputs(grids, x, mu, sigma, h), g)()
        want = dense_kernel.dense_encode_plain_backward(grids, x, mu, sigma,
                                                        h, g)
        for vol, w in zip(got, want):
            vol = vol[0].permute(1, 2, 3, 0)
            assert vol.shape == w.shape
            assert max_err(vol, w) <= 1e-5 * float(w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["rays", "random"])
@pytest.mark.parametrize("features", [2, 3])
@pytest.mark.parametrize("bf16", [False, True])
def test_dense_kernels_match_plain_on_rays_and_random(cuda_device, bf16,
                                                      features, order):
    """Both dense kernels against their plain versions on ray-ordered points
    (runs of a ray's samples, so cells repeat and the backward merges its
    adds) and on random ones; N below one run, not a multiple of a run or a
    block; the forward into a column block of a NaN-filled wider matrix
    (its neighbours stay NaN), the backward from a column-offset,
    row-strided gradient.  F = 3 takes the kernels' unaligned spans."""
    cfg = dense_cfg(bf16, features)
    grids, _, _ = tables(cfg, cuda_device, n=4)
    c = cfg.dense_levels * features
    for n in (5, 1000, 20_011):
        if order == "rays":
            args = ray_points(n, 48, cuda_device) + (cfg,)
        else:
            args = tables(cfg, cuda_device, n=n, seed=n)[2]
        g = cotangent(n, c, cuda_device, seed=n, extra=5)
        out = torch.full((n, c + 6), float("nan"), device=cuda_device)
        dense_kernel.dense_encode_kernel(grids, *args, out=out[:, 3:3 + c])
        torch.cuda.synchronize()
        assert max_err(out[:, 3:3 + c],
                       dense_kernel.dense_encode_plain(grids, *args)) <= TOL
        assert torch.isnan(out[:, :3]).all()
        assert torch.isnan(out[:, 3 + c:]).all()
        assert grads_close(dense_kernel.dense_encode_backward_kernel,
                           dense_kernel.dense_encode_plain_backward, grids,
                           args, g, bf16)


@pytest.mark.cuda
def test_dense_kernels_full_width_on_ray_samples(cuda_device):
    """The preset's grids on 128-sample rays: the forward bit for bit into
    the encoder's first columns, the backward within the sum-order
    tolerance from the encoder's strided gradient block."""
    h = C.flagship_config().hash
    grids, _, _ = tables(h, cuda_device, n=4)
    n = 100_003
    args = ray_points(n, 128, cuda_device, seed=11) + (h,)
    d = h.dense_levels * h.features_per_level
    g = cotangent(n, h.out_dim, cuda_device, seed=5, extra=0)
    out = torch.full((n, h.out_dim), float("nan"), device=cuda_device)
    dense_kernel.dense_encode_kernel(grids, *args, out=out[:, :d])
    torch.cuda.synchronize()
    assert max_err(out[:, :d],
                   dense_kernel.dense_encode_plain(grids, *args)) <= TOL
    assert torch.isnan(out[:, d:]).all()
    assert grads_close(dense_kernel.dense_encode_backward_kernel,
                       dense_kernel.dense_encode_plain_backward, grids, args,
                       g[:, :d], True)


def sweep_chunks(device):
    """(points, scene) of two mesh-sweep chunks, lattice-ordered (k
    fastest): 100,003 points (a multiple of no block) from the middle of a
    64^3 sweep, and the last chunk of a 50^3 sweep in chunks of 65,536,
    padded past R^3 so its tail lies outside the scene box."""
    from human_body_reconstruction_tpu_torch.models.nerf import scene_from_bounds
    from human_body_reconstruction_tpu_torch.pipeline.mesh_export import (
        sweep_points)

    scene = scene_from_bounds([-1.2, -1.5, -0.9], [1.3, 1.1, 1.4],
                              device=device)
    lo, span = scene["min_bound"], scene["max_bound"] - scene["min_bound"]
    mid = sweep_points(2 ** 17, 64, 100_003, lo, span)
    start = (50 ** 3 // 65_536) * 65_536
    last = sweep_points(start, 50, 65_536, lo, span)
    outside = ((last > scene["max_bound"]) | (last < lo)).any(-1)
    assert int(outside.sum()) == start + 65_536 - 50 ** 3
    return [mid, last], scene


@pytest.mark.cuda
@pytest.mark.parametrize("encoder", ["cp", "dense", "hash"])
def test_forward_kernels_match_plain_on_sweep_chunks(cuda_device, encoder):
    """The mesh sweep's forwards (CP and dense at the preset's width, the
    exact hash forward on the reference table) on lattice-ordered chunks,
    bit for bit with their plain versions, both into a contiguous output
    and into their columns of the encoder's NaN-filled (N, out_dim) matrix
    (the sweep's layout: dense first), the other columns left NaN."""
    chunks, scene = sweep_chunks(cuda_device)
    if encoder == "hash":
        h = C.HashConfig(num_levels=16, log2_table_size=16, n_max=2048,
                         variant="corner")
        table = hash_inputs(cuda_device, n=4, levels=16, log2_t=16)[0]
        kern = lambda x, **kw: hash_kernel.hash_encode_kernel(
            table, x, scene["mu"], scene["sigma"], h, **kw)
        plain = lambda x: hash_kernel.hash_encode_plain(
            table, x, scene["mu"], scene["sigma"], h)
    else:
        h = C.flagship_config().hash
        grids, lines, _ = tables(h, cuda_device, n=4)
        mod, tabs = ((cp_kernel, lines) if encoder == "cp"
                     else (dense_kernel, grids))
        name = f"{encoder}_encode"
        kern = lambda x, **kw: getattr(mod, f"{name}_kernel")(
            tabs, x, scene["mu"], scene["sigma"], h, **kw)
        plain = lambda x: getattr(mod, f"{name}_plain")(
            tabs, x, scene["mu"], scene["sigma"], h)
    d = h.dense_levels * h.features_per_level if encoder != "hash" else 0
    cols = slice(0, d) if encoder == "dense" else slice(d, h.out_dim)
    for x in chunks:
        got = kern(x)
        mat = torch.full((x.shape[0], h.out_dim), float("nan"),
                         device=cuda_device)
        kern(x, out=mat[:, cols])
        torch.cuda.synchronize()
        want = plain(x)
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        assert torch.equal(got, want)
        assert torch.equal(mat[:, cols], want)
        rest = torch.ones(h.out_dim, dtype=torch.bool)
        rest[cols] = False
        assert bool(mat[:, rest.to(cuda_device)].isnan().all())


# ------------------------------------------------------- the hash variants

def variant_inputs(device, n, order, features=2, levels=4, log2_t=10,
                   seed=0, **flags):
    """A packed/cell config, a U(-1, 1) table of its payload, points in ray
    order or at random (a quarter outside the unit box), uniforms, and the
    subsampling draws the config routes (``hash_encoding.draw_subsample``)."""
    cfg = C.HashConfig(num_levels=levels, log2_table_size=log2_t, n_max=512,
                       features_per_level=features, **flags)
    table, args, u = hash_inputs(device, n=n, levels=levels, log2_t=log2_t,
                                 seed=seed, features=features)
    if cfg.payload != features:
        table = torch.tensor(np.random.default_rng(seed).uniform(
            -1, 1, (levels, 2 ** log2_t, cfg.payload)), dtype=torch.float32,
            device=device)
    if order == "rays":
        args = ray_points(n, 64, device) + args[3:]
    args = args[:3] + (cfg,)
    route = hash_encoding.hash_route(cfg, cfg.stochastic_train)
    draws = hash_encoding.draw_subsample(
        route, cfg, levels, n, device, torch.Generator(device).manual_seed(seed))
    return table, args, u, draws


INT8_FLAGS = dict(stochastic_train=True, packed=True, pack_format="int8")
BF16_FLAGS = dict(stochastic_train=True, packed=True)


def pack_table(fmt, features, levels, log2_t):
    """A table whose packing meets its edges.  int8: level l % 4 = 0 has
    max 127, so the scaled values are the entries, many of them k + 0.5
    (ties); 1 is scaled by -1e-3; 2 is zeros (scale 1e-12); 3 has its max
    at its last entry.  bf16: entries whose low 16 bits are 0x8000."""
    rng = np.random.default_rng(levels + log2_t)
    T = 2 ** log2_t
    tab = rng.uniform(-1, 1, (levels, T, features)).astype(np.float32)
    k = min(T - 1, 299)
    if fmt == "bf16":
        bits = tab.view(np.uint32)
        bits[:, :k + 1] = (bits[:, :k + 1] & 0xFFFF0000) | 0x8000
        return tab
    tab[0::4, 0, 0] = 127.0
    tab[0::4, 1:k + 1] = rng.integers(-126, 126, (len(tab[0::4]), k,
                                                  features)) + 0.5
    tab[1::4] *= -1e-3
    tab[2::4] = 0.0
    tab[3::4, -1, -1] = -130.0
    return tab


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,features", [("bf16", 2), ("int8", 1),
                                          ("int8", 2), ("int8", 3),
                                          ("int8", 4)])
def test_pack_kernel_matches_plain_bit_for_bit(cuda_device, fmt, features):
    """Words and scales bit for bit (``pack_table``'s ties, zero level and
    max at a level's last entry), on a small table, one of T 1 (bf16: rows
    not a multiple of four), the hash path's width, and one whose levels
    are past an int8 cluster's registers (read twice); one launch a call,
    and on the stream (by the profiler) one kernel and no memset."""
    from torch.profiler import ProfilerActivity, profile

    n_p = hash_variants.pack_kernel.launches
    past = {1: 19, 2: 18, 3: 17, 4: 17}[features]
    shapes = ((4, 10), (3, 0), (16, 16), (4, past))
    for levels, log2_t in shapes:
        table = torch.tensor(pack_table(fmt, features, levels, log2_t),
                             device=cuda_device)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            words, scale = hash_variants.pack_kernel(table, fmt)
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(ops) == 1 and f"pack_{fmt}" in ops[0], ops
        want_w, want_s = hash_variants.pack_plain(table, fmt)
        torch.cuda.synchronize()
        assert torch.equal(words, want_w)
        assert (scale is None) == (fmt == "bf16")
        if scale is not None:
            assert torch.equal(scale, want_s)
            assert float(scale[2]) == np.float32(1e-12)
    assert hash_variants.pack_kernel.launches == n_p + len(shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["rays", "random"])
@pytest.mark.parametrize("mode", ["exact", "stoch"])
@pytest.mark.parametrize("fmt,features", [("bf16", 2), ("int8", 2),
                                          ("int8", 4)])
def test_packed_forward_kernel_matches_plain(cuda_device, fmt, features, mode,
                                             order):
    """The packed forward (stochastic, and the packed-exact read) bit for
    bit with its plain version into a column block of a NaN-filled wider
    matrix, the stochastic corner bits too; N below a block, not a
    multiple of one, and larger."""
    n_f = hash_variants.packed_encode_kernel.launches
    for n in (5, 1000, 20_011):
        table, args, u, _ = variant_inputs(
            cuda_device, n, order, features, seed=n,
            **(INT8_FLAGS if fmt == "int8" else BF16_FLAGS))
        words, scale = hash_variants.pack_kernel(table, fmt)
        uu = u if mode == "stoch" else None
        c = 4 * features
        out = torch.full((n, c + 6), float("nan"), device=cuda_device)
        got = hash_variants.packed_encode_kernel(words, scale, *args, u=uu,
                                                 out=out[:, 2:2 + c])
        want = hash_variants.packed_encode_plain(words, scale, *args, u=uu)
        torch.cuda.synchronize()
        if uu is not None:
            assert torch.equal(got[1], want[1])
            want = want[0]
        assert torch.equal(out[:, 2:2 + c], want)
        assert torch.isnan(out[:, :2]).all() and torch.isnan(out[:, 2 + c:]).all()
    assert hash_variants.packed_encode_kernel.launches == n_f + 3


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["rays", "random", "rays128", "one_cell"])
@pytest.mark.parametrize("features", [1, 2, 4])
def test_cell_kernels_match_plain(cuda_device, features, order):
    """The cell forward bit for bit into a column block, its backward within
    the sum-order tolerance from a row-strided gradient: points in ray order
    (64 or 128 samples a ray), at random, or all in one cell of each level;
    n below a warp, and not a multiple of a warp or a block; and at 10
    levels of 2^16 rows, whose backward takes the levels a group at a time
    (32 MB of rows: 8 levels at F 2, 4 at F 4) with a narrower last group."""
    n_f = hash_variants.cell_encode_kernel.launches
    n_b = hash_variants.cell_encode_backward_kernel.launches
    shapes = ((5, 4, 10), (1000, 4, 10), (20_011, 4, 10), (20_011, 10, 16))
    for n, levels, log2_t in shapes:
        table, args, u, draws = variant_inputs(
            cuda_device, n, "random" if order == "random" else "rays",
            features, levels=levels, log2_t=log2_t, seed=n, variant="cell")
        if order == "rays128":
            args = ray_points(n, 128, cuda_device) + args[3:]
        elif order == "one_cell":
            args, _, _ = edit_draws("one_cell", args, u, draws)
        c = levels * features
        out = torch.full((n, c + 3), float("nan"), device=cuda_device)
        hash_variants.cell_encode_kernel(table, *args, out=out[:, 3:])
        want = hash_variants.cell_encode_plain(table, *args)
        torch.cuda.synchronize()
        assert torch.equal(out[:, 3:], want) and torch.isnan(out[:, :3]).all()
        g = cotangent(n, c, cuda_device, seed=n, extra=5)
        assert grads_close(
            lambda tb, *a: [hash_variants.cell_encode_backward_kernel(
                tb[0], *a)],
            lambda tb, *a: [hash_variants.cell_encode_plain_backward(
                tb[0], *a)],
            [table], args, g, False)
    assert hash_variants.cell_encode_kernel.launches == n_f + len(shapes)
    assert hash_variants.cell_encode_backward_kernel.launches == \
        n_b + len(shapes)


SEG_TILE = 2048   # sorted pairs a segsum block takes (csrc/hash.cu SEG_TILE)
# (pairs, run layout): every run layout meets the tile edges in its own way
SEGSUM_EDGES = {
    "one_run": (3 * SEG_TILE + 5, "one_run"),
    "runs_of_tile_minus_1": (5 * SEG_TILE + 17, SEG_TILE - 1),
    "runs_of_tile": (5 * SEG_TILE, SEG_TILE),
    "runs_of_tile_plus_1": (5 * SEG_TILE + 3, SEG_TILE + 1),
    "run_starts_in_last_tile": (3 * SEG_TILE + 50, "last_30"),
    "below_one_tile": (1000, "random"),
    "not_a_vector_multiple": (2 * SEG_TILE + 3, "random"),
    "unaligned": (2 * SEG_TILE + 9, "unaligned"),
    "many_tiles": (300 * SEG_TILE + 11, "random"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("edge", sorted(SEGSUM_EDGES))
def test_segsum_edges_match_plain(cuda_device, edge):
    """The sorted scatters of sorted pairs at the segsum tile pass's edges:
    one run of all m pairs, runs of exactly a tile less one, a tile and a
    tile and one, a run that starts in the last tile, m below a tile, m not
    a multiple of the 16-byte loads' four, arrays off 16-byte alignment
    (scalar loads), many tiles for the join; the last index is size - 1.
    Both strategies within the sum-order tolerance of ``scatter_plain``;
    segsum the same bits on a second call, and zero where no pair lands."""
    m, layout = SEGSUM_EDGES[edge]
    rng = np.random.default_rng(m)
    size = 70_001
    if layout == "one_run":
        idx = np.full(m, size - 1)
    elif isinstance(layout, int):
        run = np.arange(m) // layout
        idx = size - 1 - 7 * (run[-1] - run)
    else:
        idx = np.sort(rng.integers(0, size, m))
        if layout == "last_30":
            idx[-30:] = size - 1
        idx[-1] = size - 1
    val = rng.standard_normal(m + 1).astype(np.float32)
    si = torch.tensor(np.concatenate([[0], idx]), dtype=torch.int32,
                      device=cuda_device)
    sv = torch.tensor(val, device=cuda_device)
    if layout == "unaligned":
        si, sv = si[1:], sv[1:]
        assert si.data_ptr() % 16 and sv.data_ptr() % 16
    else:
        si, sv = si[1:].clone(), sv[1:].clone()
    want_i, want_v = si.cpu().long(), sv.cpu()
    abs_sum = hash_variants.scatter_plain(size, want_i, want_v.abs())
    n_s = hash_variants.add_sorted_kernel.launches
    for strategy in ("sorted", "segsum"):
        got = hash_variants.add_sorted_kernel(size, si, sv, strategy)
        again = hash_variants.add_sorted_kernel(size, si, sv, strategy)
        want = hash_variants.scatter_plain(size, want_i, want_v, strategy)
        torch.cuda.synchronize()
        assert bool((got.cpu() - want).abs().le(cuda_lib.sum_order_tolerance(
            want, abs_sum, False)).all()), strategy
        absent = torch.ones(size, dtype=torch.bool)
        absent[want_i] = False
        assert not got.cpu()[absent].any(), strategy
        if strategy == "segsum":
            assert torch.equal(got, again)
    assert hash_variants.add_sorted_kernel.launches == n_s + 4


SUB_FLAGS = {"gsub": dict(grad_subsample=True),
             "lvl": dict(grad_subsample=True, grad_level_subsample=True),
             "lpair": dict(grad_subsample=True, grad_level_pair=True)}
# (fmt, F, routing, levels, n, edit of the draws and points): the routings
# (level routing is an int8 option: HashConfig refuses it with bf16), then
# the edges of the per-term kernel.
SUB_CASES = [pytest.param("bf16", 2, "gsub", 4, 20_011, None,
                          id="bf16-2-gsub")] + [
    pytest.param("int8", 4, r, 4, 20_011, None, id=f"int8-4-{r}")
    for r in sorted(SUB_FLAGS)] + [
    pytest.param(*c, id=i) for i, c in {
        "int8-1-lpair-L2-n5": ("int8", 1, "lpair", 2, 5, None),
        "int8-1-lvl-L2": ("int8", 1, "lvl", 2, 1000, None),
        "int8-3-lpair-L16": ("int8", 3, "lpair", 16, 20_011, None),
        "int8-2-lvl-L16": ("int8", 2, "lvl", 16, 20_011, None),
        "bf16-2-gsub-L16": ("bf16", 2, "gsub", 16, 20_011, None),
        "int8-4-lvl-one-level": ("int8", 4, "lvl", 4, 20_011, "one_level"),
        "int8-4-lvl-level-undrawn": ("int8", 4, "lvl", 4, 20_011,
                                     "level_undrawn"),
        "int8-4-lpair-psel0": ("int8", 4, "lpair", 4, 20_011, "psel0"),
        "int8-4-lpair-psel1": ("int8", 4, "lpair", 4, 20_011, "psel1"),
        "int8-2-lpair-one-cell": ("int8", 2, "lpair", 4, 20_011, "one_cell"),
        "int8-4-lvl-one-row": ("int8", 4, "lvl", 4, 20_011, "one_row"),
    }.items()]


def edit_draws(edit, args, u, draws):
    """The points, uniforms and draws of a per-term edge: every point drawn
    to level 2 (one_level), none to level 1 (level_undrawn), psel all 0 or
    all 1, every point in one cell of each level (one_cell), and there also
    corner 0, feature 0 and level 1 for all (one_row: every term on one
    row)."""
    x, mu, sigma, cfg = args
    if edit == "one_level":
        draws["lsel"].fill_(2)
    elif edit == "level_undrawn":
        draws["lsel"][draws["lsel"] == 1] = 0
    elif edit in ("psel0", "psel1"):
        draws["psel"].fill_(int(edit[-1]))
    elif edit in ("one_cell", "one_row"):
        xn = 0.3 + torch.rand(x.shape, generator=torch.Generator().manual_seed(
            9), dtype=torch.float64) * 1e-7
        x = (mu.cpu() + xn.float() * sigma.cpu()).to(x.device)
        for s in hash_kernel._scales(cfg):
            assert len(torch.unique(hash_kernel.level_coords(
                dense_grid.normalise(x, mu, sigma), float(s))[0], dim=0)) == 1
        if edit == "one_row":
            u = torch.ones_like(u)
            draws["pick"].zero_()
            draws["lsel"].fill_(1)
    return (x, mu, sigma, cfg), u, draws


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["rays", "random"])
@pytest.mark.parametrize("fmt,features,routing,levels,n,edit", SUB_CASES)
def test_sub_backward_and_sorted_scatters_match_plain(cuda_device, fmt,
                                                      features, routing,
                                                      levels, n, edit,
                                                      order):
    """The subsampled backward (random strategy: hash_kernel's backward
    given the draws, one thread a point and its drawn terms) within the
    sum-order tolerance of its plain version, from the forward kernel's
    bits and the drawn pick/lsel/psel, at F 1 to 4, L 2 to 16, n below a
    block and not a multiple of one, and at ``edit_draws``'s edges; the
    pairs kernel
    equal to its plain version (indices and values bit for bit); the sorted
    and segsum scatters of them within the tolerance, and also of the
    unsubsampled pairs."""
    flags = dict(INT8_FLAGS if fmt == "int8" else BF16_FLAGS,
                 **SUB_FLAGS[routing])
    table, args, u, draws = variant_inputs(cuda_device, n, order, features,
                                           levels=levels, seed=5, **flags)
    args, u, draws = edit_draws(edit, args, u, draws)
    words, scale = hash_variants.pack_kernel(table, fmt)
    _, bits = hash_variants.packed_encode_kernel(words, scale, *args, u=u)
    sub = (draws["pick"], draws.get("lsel"), draws.get("psel"))
    g = cotangent(n, levels * features, cuda_device, seed=6, extra=5)
    n_b = hash_kernel.hash_encode_backward_kernel.launches

    def routed(tb, *a, dev=None):
        to = (lambda v: v) if dev is None else (
            lambda v: v.to(dev) if torch.is_tensor(v) else v)
        return [hash_kernel.hash_encode_backward_kernel(
            to(tb[0]), *[to(v) for v in a], to(bits),
            **{k: to(v) for k, v in zip(("pick", "lsel", "psel"), sub)})
            .to(cuda_device)]
    assert grads_close(routed, lambda tb, *a: routed(tb, *a, dev="cpu"),
                       [table], args, g, False)
    assert hash_kernel.hash_encode_backward_kernel.launches > n_b
    got = routed([table], *args, g)[0]
    if edit == "level_undrawn":
        assert not got[1].any() and got[0].any()
    elif edit == "one_level":
        assert got[2].any() and not got[[0, 1, 3]].any()
    elif edit == "one_row":
        assert int((got != 0).sum()) == 1
    size = table.numel()
    for pick in (sub, (None, None, None)):
        idx, val = hash_variants.pairs_kernel(table, *args, g, bits, *pick)
        cpu = [v.cpu() if torch.is_tensor(v) else v for v in args]
        want_i, want_v = hash_variants.pairs_plain(
            table.cpu(), *cpu, g.cpu(), bits.cpu(),
            *[v if v is None else v.cpu() for v in pick])
        assert torch.equal(idx.cpu().long(), want_i)
        assert torch.equal(val.cpu(), want_v)
        abs_sum = hash_variants.scatter_plain(size, want_i, want_v.abs())
        for strategy in ("sorted", "segsum"):
            got = hash_variants.scatter(size, idx, val, strategy).cpu()
            want = hash_variants.scatter_plain(size, want_i, want_v, strategy)
            assert bool((got - want).abs().le(cuda_lib.sum_order_tolerance(
                want, abs_sum, False)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cell", "bf16_gsub", "int8_lpair_segsum",
                                  "packed_exact_int8"])
def test_variant_encodes_on_the_card_match_the_cpu(cuda_device, case):
    """``encode_params`` of each variant with the same draws on the card
    (kernels) and the CPU (plain versions): features bit for bit, the table
    gradient within the sum-order tolerance."""
    flags = {"cell": dict(variant="cell"),
             "bf16_gsub": dict(BF16_FLAGS, grad_subsample=True),
             "int8_lpair_segsum": dict(INT8_FLAGS, grad_subsample=True,
                                       grad_level_pair=True,
                                       scatter_strategy="segsum"),
             "packed_exact_int8": dict(packed=True, packed_exact_train=True,
                                       pack_format="int8")}[case]
    n = 20_011
    table, (x, mu, sigma, cfg), u, draws = variant_inputs(
        cuda_device, n, "rays", 4 if "int8" in case else 2, seed=7, **flags)
    stochastic = cfg.stochastic_train
    g = cotangent(n, cfg.out_dim, cuda_device, seed=8)
    res = []
    for dev, gg in ((cuda_device, g), ("cpu", g.cpu()), ("cpu", g.cpu().abs())):
        tb = table.to(dev).clone().requires_grad_()
        feats = hash_encoding.encode_params(
            {"table": tb}, x.to(dev), mu.to(dev), sigma.to(dev), cfg,
            stochastic=stochastic, u=u.to(dev) if stochastic else None,
            **{k: v.to(dev) for k, v in draws.items()})
        (feats * gg).sum().backward()
        res.append((feats.detach().cpu(), tb.grad.cpu()))
    (f_card, g_card), (f_cpu, g_cpu), (_, abs_sum) = res
    assert torch.equal(f_card, f_cpu)
    assert float(g_cpu.abs().max()) > 0.1
    assert bool((g_card - g_cpu).abs().le(cuda_lib.sum_order_tolerance(
        g_cpu, abs_sum, False)).all())
