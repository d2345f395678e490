"""The port's CUDA kernels against their plain PyTorch versions.

The ``cuda``-marked tests need the card and skip elsewhere; this file
imports no JAX, so on the card's machine it runs without the repo's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Kernel and plain version do the same f32 operations in the same order
(csrc/encoders.cu uses the non-contracting _rn intrinsics), so they are held
to 1e-6.  The unmarked tests check the build and launch plumbing that runs
on any machine.
"""

import dataclasses

import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu_torch.ops import (
    cp_kernel, cuda_lib, dense_grid, dense_kernel, lowrank)
from human_body_reconstruction_tpu_torch.utils import config as C

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
