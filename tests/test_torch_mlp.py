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
