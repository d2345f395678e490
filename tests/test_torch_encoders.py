"""PyTorch port vs the JAX package: the dense and CP encoders, their kernel
wrappers' plain versions (forward and backward), the full encoder's feature
order and its gradients.

Small CP config: 4 levels up to n_max 128, rank 8, auto dense levels (2
dense, G 18 and 34; 2 CP levels, G 66 and 130).  Tables and points are made
with numpy from a seed; a third of the points lie outside the scene box.
The Pallas kernels run here in interpret mode: the dense one at this
config, the CP one (too slow interpreted at this size) at one level, rank 4
and 64 points.  The CUDA kernels themselves are held to their plain
versions by tests/test_torch_kernels.py, on the card.
Gradients are taken against a seeded normal cotangent and compared with
``jax.grad`` of the JAX functions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu.ops import cp_pallas as jcp_pallas
from human_body_reconstruction_tpu.ops import dense_grid as jdense
from human_body_reconstruction_tpu.ops import dense_pallas as jdense_pallas
from human_body_reconstruction_tpu.ops import hash_encoding as jhe
from human_body_reconstruction_tpu.ops import lowrank as jlowrank
from human_body_reconstruction_tpu_torch.ops import (
    cp_kernel, cuda_lib, dense_grid, dense_kernel, hash_encoding, lowrank)
from human_body_reconstruction_tpu_torch.utils import config as C

MU = np.array([-1.0, -2.0, -0.5], np.float32)
SIGMA = np.float32(3.0)


def small_cfg(bf16: bool = True) -> C.HashConfig:
    base = C.HashConfig(num_levels=4, n_max=128, variant="cp", cp_rank=8,
                        dense_bf16=bf16)
    return dataclasses.replace(base,
                               dense_levels=dense_grid.auto_dense_levels(base))


def make_tables(cfg, seed=0):
    rng = np.random.default_rng(seed)
    grids = [rng.uniform(-1, 1, (g, g, g, cfg.features_per_level))
             .astype(np.float32) for g in dense_grid.dense_grid_sizes(cfg)]
    lines = [rng.uniform(-1, 1, (3, g, cfg.cp_rank)).astype(np.float32)
             for g in lowrank.cp_line_sizes(cfg)]
    xn = rng.uniform(-0.3, 1.3, (600, 3)).astype(np.float32)
    return grids, lines, (MU + xn * SIGMA).astype(np.float32)


def both(arrays):
    return ([torch.tensor(a) for a in arrays],
            tuple(jnp.asarray(a) for a in arrays))


def run_port(fn, tables, x, cfg):
    return fn(tables, torch.tensor(x), torch.tensor(MU), torch.tensor(SIGMA),
              cfg).numpy()


def run_jax(fn, tables, x, cfg, **kw):
    return np.asarray(fn(tables, jnp.asarray(x), jnp.asarray(MU), SIGMA, cfg,
                         **kw))


def close(a, b, atol):
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_small_cfg_shape():
    cfg = small_cfg()
    assert cfg.dense_levels == 2
    assert dense_grid.dense_grid_sizes(cfg) == [18, 34]
    assert lowrank.cp_line_sizes(cfg) == [66, 130]


@pytest.mark.parametrize("bf16", [False, True])
def test_dense_encode_matches_xla(bf16):
    """Same roundings on both sides (bf16 two-hot rows and pair products);
    only the f32 order of the four-term sums differs: atol 1e-5."""
    cfg = small_cfg(bf16)
    grids, _, x = make_tables(cfg)
    tg, jg = both(grids)
    close(run_port(dense_grid.dense_encode, tg, x, cfg),
          run_jax(jdense.dense_encode, jg, x, cfg), 1e-5)


def test_dense_kernel_plain_matches_pallas_interpret():
    """dense_encode_plain against dense_pallas's kernel run interpreted.
    The Pallas hats are 1 - |g - x_eff| with x_eff = x0 + frac rounded in
    f32, the port forms 1 - frac and frac directly; on these inputs the two
    agree exactly, and the remaining freedom is the f32 order of the
    four-term sums: atol 1e-5."""
    cfg = small_cfg(True)
    grids, _, x = make_tables(cfg)
    tg, jg = both(grids)
    close(run_port(dense_kernel.dense_encode_plain, tg, x, cfg),
          run_jax(jdense_pallas.dense_encode_pallas, jg, x, cfg,
                  interpret=True), 1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_dense_kernel_plain_matches_xla(bf16):
    """f32: the same function as dense_grid.dense_encode (atol 1e-5).  bf16:
    the Pallas roundings (f32 lerp weights, bf16 pair product and folded
    terms) against the XLA ones (bf16 lerp weights): a few bf16 ulps
    (2**-8 relative) of |grid| <= 1 values, measured up to 6.5e-3: atol
    1e-2."""
    cfg = small_cfg(bf16)
    grids, _, x = make_tables(cfg)
    tg, jg = both(grids)
    close(run_port(dense_kernel.dense_encode_plain, tg, x, cfg),
          run_jax(jdense.dense_encode, jg, x, cfg), 1e-2 if bf16 else 1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_cp_encode_matches_xla(bf16):
    """The two-hot matrix form with the XLA path's roundings: atol 1e-5."""
    cfg = small_cfg(bf16)
    _, lines, x = make_tables(cfg)
    tl, jl = both(lines)
    close(run_port(lowrank.cp_encode, tl, x, cfg),
          run_jax(jlowrank.cp_encode, jl, x, cfg), 1e-5)


def test_cp_encode_reference_matches():
    cfg = small_cfg(False)
    _, lines, x = make_tables(cfg)
    tl, jl = both(lines)
    ref = run_jax(jlowrank.cp_encode_reference, jl, x, cfg)
    close(run_port(lowrank.cp_encode_reference, tl, x, cfg), ref, 1e-5)
    close(run_port(lowrank.cp_encode, tl, x, cfg), ref, 1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_cp_kernel_plain_matches_xla(bf16):
    """f32: the same function as lowrank.cp_encode (atol 1e-5).  bf16: the
    Pallas lerp weights bf16(1 - frac) against the XLA bf16(1 - bf16(frac)),
    at most one bf16 ulp per weight, on products of three lerps of
    |line| <= 1 values, measured up to 3.8e-3: atol 1e-2."""
    cfg = small_cfg(bf16)
    _, lines, x = make_tables(cfg)
    tl, jl = both(lines)
    close(run_port(cp_kernel.cp_encode_plain, tl, x, cfg),
          run_jax(jlowrank.cp_encode, jl, x, cfg), 1e-2 if bf16 else 1e-5)


def test_encode_params_order():
    """Dense features first, then CP, as jhe.encode_params lays them out."""
    cfg = small_cfg(False)
    grids, lines, x = make_tables(cfg)
    (tg, jg), (tl, jl) = both(grids), both(lines)
    port = hash_encoding.encode_params(
        {"dense": tg, "lines": tl}, torch.tensor(x), torch.tensor(MU),
        torch.tensor(SIGMA), cfg).numpy()
    ref = np.asarray(jhe.encode_params({"dense": jg, "lines": jl},
                                       jnp.asarray(x), jnp.asarray(MU),
                                       SIGMA, cfg))
    assert port.shape == ref.shape == (x.shape[0], cfg.out_dim)
    close(port, ref, 1e-5)


def test_wrappers_on_cpu_run_plain():
    cfg = small_cfg(True)
    grids, lines, x = make_tables(cfg)
    tg, _ = both(grids)
    tl, _ = both(lines)
    args = (torch.tensor(x), torch.tensor(MU), torch.tensor(SIGMA), cfg)
    before = (cp_kernel.cp_encode_kernel.launches,
              dense_kernel.dense_encode_kernel.launches)
    out = torch.full((x.shape[0], cfg.out_dim + 3), float("nan"))
    d = cfg.dense_levels * cfg.features_per_level
    dense_kernel.dense_encode_kernel(tg, *args, out=out[:, :d])
    cp_kernel.cp_encode_kernel(tl, *args, out=out[:, d:cfg.out_dim])
    assert torch.equal(out[:, :d], dense_kernel.dense_encode_plain(tg, *args))
    assert torch.equal(out[:, d:cfg.out_dim],
                       cp_kernel.cp_encode_plain(tl, *args))
    assert torch.isnan(out[:, cfg.out_dim:]).all()
    # the plain versions ran: no kernel launch was counted
    assert (cp_kernel.cp_encode_kernel.launches,
            dense_kernel.dense_encode_kernel.launches) == before
    with pytest.raises(ValueError):
        cp_kernel.cp_encode_kernel(tl, torch.tensor(x).to("meta"),
                                   torch.tensor(MU), torch.tensor(SIGMA), cfg)


def test_wrappers_reject_bad_inputs():
    """What the kernels would read out of bounds is refused on every device,
    before the plain version or the kernel runs."""
    cfg = small_cfg(True)
    grids, lines, x = make_tables(cfg)
    tg, _ = both(grids)
    tl, _ = both(lines)
    args = (torch.tensor(x), torch.tensor(MU), torch.tensor(SIGMA), cfg)
    flat = (torch.tensor(x)[:, :2],) + args[1:]
    bad_grid = [tg[0][:, :, :-1]] + tg[1:]
    bad_line = [tl[0][:, :-1]] + tl[1:]
    for call in (lambda: dense_kernel.dense_encode_kernel(bad_grid, *args),
                 lambda: dense_kernel.dense_encode_kernel(tg, *flat),
                 lambda: dense_kernel.dense_encode_kernel(
                     tg, *args, out=torch.empty((x.shape[0], 3))),
                 lambda: cp_kernel.cp_encode_kernel(bad_line, *args),
                 lambda: cp_kernel.cp_encode_kernel(tl, *flat),
                 lambda: cp_kernel.cp_encode_kernel(
                     tl, *args, out=torch.empty((x.shape[0], 1)))):
        with pytest.raises(ValueError):
            call()


def cotangent(x, cfg, seed=7):
    return np.random.default_rng(seed).normal(
        size=(x.shape[0], cfg.out_dim)).astype(np.float32)


def jax_grad(fn, tables, x, cols, cfg, **kw):
    """jax.grad of sum(fn(tables, x) * cols) w.r.t. each table."""
    def f(t):
        return jnp.sum(fn(t, jnp.asarray(x), jnp.asarray(MU), SIGMA, cfg, **kw)
                       * jnp.asarray(cols))
    return [np.asarray(g) for g in
            jax.grad(f)(tuple(jnp.asarray(a) for a in tables))]


def port_args(x, cfg):
    return torch.tensor(x), torch.tensor(MU), torch.tensor(SIGMA), cfg


def all_close(port, ref, atol):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert tuple(a.shape) == b.shape
        close(a.detach().numpy(), b, atol)


# Gradient tolerances, on |gradient| up to about 4.5.  f32: the same sums in
# another order, measured 1.4e-6: atol 1e-5.  bf16: the Pallas roundings
# (bf16 lerp weights of f32 fractions, dT rounded to bf16, the result rounded
# to bf16) against the XLA ones (bf16(1 - bf16(frac)) weights, bf16
# products): one bf16 ulp of the largest entries, measured 1.56e-2: atol 3e-2.
GRAD_ATOL = {False: 1e-5, True: 3e-2}


@pytest.mark.parametrize("bf16", [False, True])
def test_cp_backward_matches_xla_grad(bf16):
    cfg = small_cfg(bf16)
    _, lines, x = make_tables(cfg)
    d = cfg.dense_levels * cfg.features_per_level
    ct = cotangent(x, cfg)[:, d:]
    port = cp_kernel.cp_encode_plain_backward(
        [torch.tensor(a) for a in lines], *port_args(x, cfg), torch.tensor(ct))
    all_close(port, jax_grad(jlowrank.cp_encode, lines, x, ct, cfg),
              GRAD_ATOL[bf16])


@pytest.mark.parametrize("bf16", [False, True])
def test_dense_backward_matches_xla_grad(bf16):
    cfg = small_cfg(bf16)
    grids, _, x = make_tables(cfg)
    d = cfg.dense_levels * cfg.features_per_level
    ct = cotangent(x, cfg)[:, :d]
    port = dense_kernel.dense_encode_plain_backward(
        [torch.tensor(a) for a in grids], *port_args(x, cfg), torch.tensor(ct))
    all_close(port, jax_grad(jdense.dense_encode, grids, x, ct, cfg),
              GRAD_ATOL[bf16])


def test_dense_backward_matches_pallas_interpret_grad():
    """dense_encode_plain_backward against the VJP of dense_pallas's kernel
    run interpreted: the same terms (bf16(bf16(g) * wx) * bf16(wy * wz)),
    summed in another order, then rounded to bf16; measured exact: one bf16
    ulp of the reference plus 1e-6, the tolerance the CUDA kernel is held
    to."""
    cfg = small_cfg(True)
    grids, _, x = make_tables(cfg)
    d = cfg.dense_levels * cfg.features_per_level
    ct = cotangent(x, cfg)[:, :d]
    port = dense_kernel.dense_encode_plain_backward(
        [torch.tensor(a) for a in grids], *port_args(x, cfg), torch.tensor(ct))
    ref = jax_grad(jdense_pallas.dense_encode_pallas, grids, x, ct, cfg,
                   interpret=True)
    for a, b in zip(port, ref):
        b = torch.tensor(b)
        assert bool(((a - b).abs() <= cuda_lib.bf16_ulp(b) + 1e-6).all())


def test_cp_backward_matches_pallas_interpret_grad():
    """cp_encode_plain_backward against the VJP of cp_pallas's kernel run
    interpreted, on one CP level (G 65) at rank 4 and 64 points: the
    interpreted kernel takes about 3 s at this size.  The same terms
    (bf16 lerp weights times bf16(dT)), summed in another order, then
    rounded to bf16; measured exact: one bf16 ulp of the reference plus
    1e-6, the tolerance the CUDA kernel is held to."""
    base = dataclasses.replace(small_cfg(True), num_levels=3, n_max=64,
                               cp_rank=4)
    cfg = dataclasses.replace(base,
                              dense_levels=dense_grid.auto_dense_levels(base))
    assert lowrank.cp_line_sizes(cfg) == [65]
    _, lines, x = make_tables(cfg)
    x = x[:64]
    d = cfg.dense_levels * cfg.features_per_level
    ct = cotangent(x, cfg)[:, d:]
    port = cp_kernel.cp_encode_plain_backward(
        [torch.tensor(a) for a in lines], *port_args(x, cfg), torch.tensor(ct))
    ref = jax_grad(jcp_pallas.cp_encode_pallas, lines, x, ct, cfg,
                   interpret=True)
    assert len(port) == len(ref) == 1
    for a, b in zip(port, ref):
        b = torch.tensor(b)
        assert a.shape == b.shape
        assert bool(((a - b).abs() <= cuda_lib.bf16_ulp(b) + 1e-6).all())


@pytest.mark.parametrize("bf16", [False, True])
def test_encode_params_grad_matches_autograd_of_plain(bf16):
    """The encoder Function on the CPU: its forward is the plain forwards',
    exactly, and its backward (the plain backwards, which round dT and the
    result to bf16 as the Pallas VJPs do) is autograd of the plain forwards
    within the tolerance above (f32 measured 9.5e-7, bf16 1.6e-2)."""
    cfg = small_cfg(bf16)
    grids, lines, x = make_tables(cfg)
    args = port_args(x, cfg)
    ct = torch.tensor(cotangent(x, cfg))
    tg = [torch.tensor(a, requires_grad=True) for a in grids]
    tl = [torch.tensor(a, requires_grad=True) for a in lines]
    out = hash_encoding.encode_params({"dense": tg, "lines": tl}, *args)
    ref = torch.cat([dense_kernel.dense_encode_plain(tg, *args),
                     cp_kernel.cp_encode_plain(tl, *args)], dim=-1)
    assert torch.equal(out, ref)
    got = torch.autograd.grad((out * ct).sum(), tg + tl)
    want = torch.autograd.grad((ref * ct).sum(), tg + tl)
    all_close(got, [w.numpy() for w in want], GRAD_ATOL[bf16])
    # the positions get no gradient
    xs = args[0].clone().requires_grad_()
    feats = hash_encoding.encode_params({"dense": tg, "lines": tl}, xs,
                                        *args[1:])
    assert torch.autograd.grad(feats.sum(), xs, allow_unused=True)[0] is None


def test_backward_wrappers_on_cpu_run_plain():
    cfg = small_cfg(True)
    grids, lines, x = make_tables(cfg)
    tg, tl = both(grids)[0], both(lines)[0]
    args = port_args(x, cfg)
    d = cfg.dense_levels * cfg.features_per_level
    wide = torch.tensor(cotangent(x, cfg))
    before = (cp_kernel.cp_encode_backward_kernel.launches,
              dense_kernel.dense_encode_backward_kernel.launches)
    for kern, plain, tabs, cols in (
            (cp_kernel.cp_encode_backward_kernel,
             cp_kernel.cp_encode_plain_backward, tl, wide[:, d:]),
            (dense_kernel.dense_encode_backward_kernel,
             dense_kernel.dense_encode_plain_backward, tg, wide[:, :d])):
        for a, b in zip(kern(tabs, *args, cols), plain(tabs, *args, cols)):
            assert torch.equal(a, b)
        for bad in (cols[:-1], cols[:, 1:], cols.double(), cols[:, ::2]):
            with pytest.raises(ValueError):
                kern(tabs, *args, bad)
    assert (cp_kernel.cp_encode_backward_kernel.launches,
            dense_kernel.dense_encode_backward_kernel.launches) == before
