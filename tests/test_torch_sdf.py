"""PyTorch port vs the JAX package: SDF mode, the hierarchical second pass
and top-K sample compaction, on the CPU.

A small CP model (4 levels up to n_max 128, rank 4, auto dense levels, MLP
width 16, f32 encoders and MLP) built by the JAX ``init_params`` and carried
across by ``from_jax_params``; the SDF sharpness set to 20 so that the
composited weights are far from zero.  Every random draw is made with
jax.random from the JAX keys, as the JAX ``render_rays`` makes it, and
handed to the port: the ladder jitter or the guided placement's stratified
draw (``k_strat``), the second pass's quantiles (``k_fine``, at evaluation
too) and the eikonal subsample's indices (``fold_in(key, 0x5DF)``).  The JAX
sampling module gets torch's sums (``_JnpWithTorchSums``), as in
tests/test_torch_ops.py.

Tolerances: the f32 paths agree to about 1e-6 (a step's gradients to 1e-5
of their norm).  The eikonal norm is a central difference over 2·eps =
1e-3 of two densities that agree to a few f32 ulps, so it carries their
difference times 1e3 (measured up to 2.6e-4: atol 1e-3); in a step's
gradients the parameter gradients of the two densities cancel to about
1e-3 of their size, so their sum-order differences surface at up to
1.9e-3 of the norm (the dense grids, ladder; 1.7e-4 elsewhere): 5e-3 in
SDF mode.  An SDF weight is 1 - phi_{i+1}/phi_i at sharpness 20, which
turns density differences of a few 1e-7 into weight differences of a
few 1e-6; the second pass draws its depths from those weights, and a
depth in a nearly empty bin moves with them (measured: first-pass weights
2.1e-6 apart move a second-pass depth by 3.2e-5), so its weights and
colours differ by up to 5.4e-5 and 2.5e-5: atol 1e-4 on SDF weights and
colours.  Test names avoid the words that tests/conftest.py marks slow.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu.models import nerf as jnerf
from human_body_reconstruction_tpu.ops import compositing as jcomp
from human_body_reconstruction_tpu.ops import sampling as jsampling
from human_body_reconstruction_tpu.pipeline import restore as jrestore
from human_body_reconstruction_tpu.train import step as jstep
from human_body_reconstruction_tpu.train import trainer as jtrainer
from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.ops import compositing, dense_grid
from human_body_reconstruction_tpu_torch.ops import sampling
from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
from human_body_reconstruction_tpu_torch.train import step
from human_body_reconstruction_tpu_torch.utils import config as C
from test_torch_ops import _JnpWithTorchSums
from test_torch_train import both_occ, dataset, jax_batch, rel_norm
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LO = np.array([-1.5, -1.5, -1.5], np.float32)
HI = np.array([1.5, 1.5, 1.5], np.float32)
B, S, N_FINE, N_EIK = 64, 16, 8, 100
EIK_ATOL = 1e-3
STEP_GRAD_SDF = 5e-3
SDF_ATOL = 1e-4
SHARPNESS = 20.0


def small_cfg(sdf=False, hier=False, occ=None) -> C.PipelineConfig:
    """``occ``: None, "guided" (guided placement of 8 from 8 probes, mass
    dt, stratified) or "compact" (the masked ladder cut to its first 8
    occupied samples)."""
    h = C.HashConfig(num_levels=4, n_max=128, variant="cp", cp_rank=4,
                     dense_bf16=False, init_scale=0.5, cp_init_scale=0.6,
                     dense_impl="xla")
    h = dataclasses.replace(h, dense_levels=dense_grid.auto_dense_levels(h))
    occ_kw = {}
    if occ is not None:
        occ_kw = dict(occupancy=True, occupancy_resolution=16,
                      compact_samples=8)
    if occ == "guided":
        occ_kw.update(occ_guided=True, occ_probes=8, occ_dt="mass",
                      occ_stratified=True)
    return C.PipelineConfig(
        hash=h, mlp=C.MLPConfig(width=16, density_activation="sdf" if sdf
                                else "leaky_relu"),
        render=C.RenderConfig(num_samples=S, use_sdf=sdf, hierarchical=hier,
                              num_fine_samples=N_FINE if hier else 0,
                              **occ_kw),
        train=C.TrainConfig(ray_batch=B, cp_tv_weight=1e-2,
                            eikonal_subsample=N_EIK,
                            compute_dtype="float32"))


def jax_params(cfg):
    params = jax.tree.map(np.array, jtrainer.init_params(
        jax.random.PRNGKey(0), cfg))
    if "var" in params:
        params["var"]["b"] = np.float32(SHARPNESS)
    else:
        params["mlp"]["sig"][-1]["b"][0] += 1.0   # visibly opaque density
    return params


def ball_mask(g=16):
    """A ball of radius 1 in the 16^3 grid over the scene (mu LO, sigma the
    box's diagonal)."""
    c = (np.arange(g) + 0.5) / g * np.sqrt(3.0) * 3.0 - 1.5
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    return ((xx ** 2 + yy ** 2 + zz ** 2) < 1.0).astype(np.float32)


def jax_draws(cfg, key, train: bool, n_pts: int) -> dict:
    """The JAX ``render_rays`` draws from ``key``, as the port takes them."""
    k_strat, k_fine = jax.random.split(key, 4)[:2]
    r = cfg.render
    draws = {}
    if train and r.occ_guided:
        draws["xi"] = jax.random.uniform(k_strat, (B, r.compact_samples),
                                         maxval=1.0 - 1e-6)
    elif train:
        draws["u"] = jax.random.uniform(k_strat, (B, S))
    if r.hierarchical:
        draws["fine_u"] = jax.random.uniform(k_fine, (B, N_FINE),
                                             maxval=1.0 - 1e-6)
    if train and r.use_sdf:
        draws["eik_idx"] = jax.random.randint(
            jax.random.fold_in(key, 0x5DF), (N_EIK,), 0, n_pts)
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


def eik_points(cfg, train):
    """The number of points the eikonal term subsamples from in training."""
    r = cfg.render
    k = r.compact_samples if r.occupancy else S
    return B * (k + N_FINE if r.hierarchical else k) if train else 0


def rays(seed=0):
    images, c2ws, K = dataset(seed)
    batch, img, pix = jax_batch(jax.random.PRNGKey(2), images, c2ws, K)
    tbatch = step.sample_ray_batch(torch.tensor(images), torch.tensor(c2ws),
                                   torch.tensor(K), B, img_idx=img,
                                   pix_idx=pix)
    return batch, tbatch


def test_composite_sdf_matches_jax():
    """Colour, weights and transmittance, and the gradients of a weighted
    sum of the colour and weights with respect to rgb, sdf and b."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(2.0, 6.0, (32, 24)), -1).astype(np.float32)
    rgb = rng.uniform(size=(32, 24, 3)).astype(np.float32)
    sdf = rng.uniform(-1.0, 1.0, (32, 24)).astype(np.float32)
    sdf[:4] = sdf[:4, :1]                         # flat rays: alpha 0
    cw = rng.normal(size=(32, 3)).astype(np.float32)
    ww = rng.normal(size=(32, 24)).astype(np.float32)

    def jfun(rgb, sdf, b):
        c, w, tr = jcomp.composite_sdf(jnp.asarray(t), rgb, sdf, b)
        return jnp.sum(c * cw) + jnp.sum(w * ww), (c, w, tr)

    (_, ref), jg = jax.value_and_grad(jfun, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(rgb), jnp.asarray(sdf), jnp.float32(3.0))
    args = [torch.tensor(a, requires_grad=True)
            for a in (rgb, sdf, np.float32(3.0))]
    out = compositing.composite_sdf(torch.tensor(t), *args)
    (torch.sum(out[0] * torch.tensor(cw))
     + torch.sum(out[1] * torch.tensor(ww))).backward()
    assert float(out[1].detach().sum(-1).max()) > 0.5
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-6)
    for a, b in zip(args, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_hierarchical_ts_matches_jax(monkeypatch):
    """Merged, sorted depths from the leading S - 1 weights, the JAX key's
    quantiles handed to the port; some rays have no weight at all."""
    monkeypatch.setattr(jsampling, "jnp", _JnpWithTorchSums())
    rng = np.random.default_rng(1)
    t = np.sort(rng.uniform(2.0, 6.0, (48, 16)), -1).astype(np.float32)
    w = rng.uniform(size=(48, 16)).astype(np.float32) ** 4
    w[:5] = 0.0
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jsampling.hierarchical_ts(key, jnp.asarray(t),
                                               jnp.asarray(w), 12))
    u = torch.tensor(np.asarray(jax.random.uniform(key, (48, 12),
                                                   maxval=1.0 - 1e-6)))
    port = sampling.hierarchical_ts(torch.tensor(t), torch.tensor(w), 12, u=u)
    assert port.shape == (48, 28)
    assert bool((port[:, 1:] >= port[:, :-1]).all())
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-5)
    drawn = sampling.hierarchical_ts(torch.tensor(t), torch.tensor(w), 12,
                                     generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (48, 28) and bool((drawn >= 2.0).all())


def test_sdf_finite_difference_normals_matches_jax():
    """Central differences of the 2*sigmoid-1 head at points inside the box
    and within eps of its faces (whose offsets are clipped)."""
    cfg = small_cfg(sdf=True)
    params = jax_params(cfg)
    field = ckpt.from_jax_params(params, cfg)
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1.4, 1.4, (200, 3)).astype(np.float32)
    pts[:20, 0] = 1.5 - 1e-4                      # at a face: clipped
    pts[20:40, 2] = -1.5
    ref = np.asarray(jnerf.sdf_finite_difference_normals(
        jax.tree.map(jnp.asarray, params), jrestore.scene_from_bounds(LO, HI),
        jnp.asarray(pts), cfg))
    with torch.no_grad():
        port = nerf.sdf_finite_difference_normals(
            field, nerf.scene_from_bounds(LO, HI), torch.tensor(pts), cfg)
    assert port.shape == (200, 3) and float(np.abs(ref).max()) > 0.1
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=EIK_ATOL)


RENDER_CASES = {"sdf": dict(sdf=True),
                "sdf_guided": dict(sdf=True, occ="guided"),
                "hier": dict(hier=True),
                "hier_compact": dict(hier=True, occ="compact"),
                "sdf_hier": dict(sdf=True, hier=True)}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_rays_matches_jax(case, train, monkeypatch):
    """``render_rays`` in training (its draws injected) and at evaluation
    (the second pass from the JAX key's quantiles): both passes' colours
    and weights, and the eikonal norms.  "sdf_guided" is the quality
    protocol's SDF composition; "hier_compact" cuts the masked ladder (and
    the second pass, in training) to each ray's first 8 occupied
    samples."""
    monkeypatch.setattr(jsampling, "jnp", _JnpWithTorchSums())
    cfg = small_cfg(**RENDER_CASES[case])
    params = jax_params(cfg)
    field = ckpt.from_jax_params(params, cfg)
    (o, d, n, _), (to, td, tn, _) = rays()
    occ_j = occ_p = None
    if cfg.render.occupancy:
        occ_j, occ_p = both_occ(ball_mask())
    key = jax.random.PRNGKey(3)
    ref = jnerf.render_rays(jax.tree.map(jnp.asarray, params),
                            jrestore.scene_from_bounds(LO, HI), o, d, n, key,
                            cfg, occ=occ_j, jitter=train)
    with torch.no_grad():
        out = nerf.render_rays(field, nerf.scene_from_bounds(LO, HI), to, td,
                               tn, cfg, occ=occ_p, jitter=train,
                               draws=jax_draws(cfg, key, train,
                                               eik_points(cfg, train)))
    keys = ["coarse", "fine", "weights", "t"]
    if cfg.render.hierarchical:
        keys.append("fine_weights")
        assert out["fine_weights"].shape[-1] == out["t"].shape[-1] + N_FINE \
            or cfg.render.occupancy
        assert np.abs(np.asarray(ref["fine"])
                      - np.asarray(ref["coarse"])).max() > 1e-5
    assert float(out["weights"].sum(-1).max()) > 0.1
    for k in keys:
        assert tuple(out[k].shape) == ref[k].shape, k
        atol = SDF_ATOL if cfg.render.use_sdf and k != "t" else 1e-5
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)
    if cfg.render.use_sdf:
        want = np.asarray(ref["eikonal_norm"])
        assert out["eikonal_norm"].shape == want.shape
        assert want.shape[0] == (N_EIK if train else B * (
            S + N_FINE if cfg.render.hierarchical else S))
        np.testing.assert_allclose(out["eikonal_norm"].numpy(), want,
                                   rtol=0, atol=EIK_ATOL)
    else:
        assert "eikonal_norm" not in out


def one_step(cfg, monkeypatch):
    """(JAX loss, aux, grads by group), (port loss, aux, grads by group) of
    one training step from the same params, batch and draws."""
    monkeypatch.setattr(jsampling, "jnp", _JnpWithTorchSums())
    params = jax_params(cfg)
    field = ckpt.from_jax_params(params, cfg)
    batch, tbatch = rays()
    occ_j = occ_p = None
    if cfg.render.occupancy:
        occ_j, occ_p = both_occ(ball_mask())
    key = jax.random.PRNGKey(3)
    (lj, auxj), gj = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), jrestore.scene_from_bounds(LO, HI),
        batch, key, cfg, occ_j, None, step=10)
    lp, auxp = step.loss_fn(field, nerf.scene_from_bounds(LO, HI), tbatch,
                            cfg, occ_p, None, step=10,
                            draws=jax_draws(cfg, key, True,
                                            eik_points(cfg, True)))
    lp.backward()
    jg = {k: np.concatenate([np.asarray(g).reshape(-1) for g in
                             jax.tree_util.tree_leaves(gj[k])])
          for k in ("dense", "lines")}
    jg["mlp"] = np.concatenate(
        [np.asarray(g).reshape(-1) for branch in ("sig", "col")
         for layer in gj["mlp"][branch]
         for g in (np.asarray(layer["w"]).T, layer["b"])])
    pg = {name: np.concatenate([p.grad.numpy().reshape(-1) for p in ps])
          for name, ps in (("dense", field.dense), ("lines", field.lines),
                           ("mlp", list(field.mlp.parameters())))}
    if cfg.render.use_sdf:
        jg["var"] = np.asarray(gj["var"]["b"]).reshape(1)
        pg["var"] = field.var_b.grad.numpy().reshape(1)
    return (float(lj), auxj, jg), (float(lp.detach()), auxp, pg)


@pytest.mark.parametrize("case", ["sdf", "sdf_guided", "hier",
                                  "hier_compact", "sdf_hier"])
def test_step_loss_and_grads_match_jax(case, monkeypatch):
    """One step's loss (MSE of both passes, the eikonal term 0.1·mean((|g|
    - 1)^2), factor-line TV), ``aux["eikonal"]`` and every group's gradient,
    the SDF sharpness's included."""
    cfg = small_cfg(**RENDER_CASES[case])
    (lj, auxj, gj), (lp, auxp, gp) = one_step(cfg, monkeypatch)
    assert np.isfinite(lp) and lp == pytest.approx(lj, rel=1e-5)
    assert float(auxp["psnr"].detach()) == pytest.approx(float(auxj["psnr"]),
                                                abs=1e-4)
    if cfg.render.use_sdf:
        eik = float(auxp["eikonal"])
        assert eik > 0 and eik == pytest.approx(float(auxj["eikonal"]),
                                                rel=1e-4)
        assert abs(float(gp["var"][0])) > 0
    else:
        assert "eikonal" not in auxp
    assert set(gp) == set(gj)
    for k in gj:
        assert gp[k].shape == gj[k].shape, k
        assert rel_norm(gp[k], gj[k]) <= (
            STEP_GRAD_SDF if cfg.render.use_sdf else 1e-5), k


# One step of the SDF mode in its bf16 numerics (the encoders' bf16
# roundings, the MLP in bf16 compute), held to JAX's Pallas path: both
# Pallas kernels run interpreted, as the TPU ran the es16k mode, whose xla
# twin differs only in that switch.  The port takes the JAX placement
# (``placement=``) and eikonal indices.  JAX's CP kernel lays the levels'
# factor rows out "tight" (a level may start inside a 128-column block) and
# rounds a point's block-local coordinate x + (level offset) to f32 there,
# which moves about 1% of its hat weights by one bf16 ulp; its "padded"
# layout starts every level on a block and rounds nothing.  The same terms
# under the two layouts are the step's spread, measured on this step: JAX
# tight against padded 1.45e-3 (lines), 1.9e-4 (mlp), 8.7e-5 (dense),
# 9.1e-6 (var), loss 1.8e-6.  The port against padded: 6e-8 (lines), 3.5e-7
# (mlp), 1.0e-4 (dense: the bf16 rounding of the dense grid's f32 sums,
# taken in another order), 1e-7 (var); against tight: the layout's spread.
# Tolerance: twice the largest spread, 3e-3.  (JAX's XLA path rounds the
# lerp weights and the CP lines' products elsewhere: on this step the port's
# gradients differ from it by 0.28 (mlp) to 0.62 (dense) of their norm, and
# its eikonal term reads 0.694 against 0.718, so at bf16 the mode's two JAX
# paths are two functions; the port follows the Pallas one.)
BF16_STEP_GRAD = 3e-3


def bf16_sdf_step(monkeypatch, port_hash=(), **hash_kw):
    """One guided SDF step in bf16 numerics on both sides, the port given
    JAX's placement and eikonal indices: ((loss, aux, grads) of JAX, then
    of the port under each hash config change of ``port_hash``, the first
    being none) with grads by group."""
    monkeypatch.setattr(jsampling, "jnp", _JnpWithTorchSums())
    base = small_cfg(sdf=True, occ="guided")
    cfg = dataclasses.replace(
        base, hash=dataclasses.replace(base.hash,
                                       **{"dense_bf16": True, **hash_kw}),
        train=dataclasses.replace(base.train, compute_dtype="bfloat16"))
    params = jax_params(cfg)
    batch, tbatch = rays()
    occ_j, occ_p = both_occ(ball_mask())
    key = jax.random.PRNGKey(3)
    r, scene = cfg.render, jrestore.scene_from_bounds(LO, HI)
    t, dt = jsampling.occupancy_guided_ts(
        jax.random.split(key, 4)[0], batch[0], batch[1], occ_j, scene["mu"],
        scene["sigma"], r.near, r.far, r.compact_samples,
        num_probe=r.occ_probes, explore_frac=r.occ_explore, jitter=True,
        probe_jitter=r.occ_probe_jitter, dt_mode=r.occ_dt,
        stratified=r.occ_stratified)
    eik_idx = jax.random.randint(jax.random.fold_in(key, 0x5DF), (N_EIK,), 0,
                                 eik_points(cfg, True))
    (lj, auxj), gj = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), scene, batch, key, cfg, occ_j,
        jnp.bfloat16, step=10)
    jg = {k: np.concatenate([np.asarray(g).reshape(-1) for g in
                             jax.tree_util.tree_leaves(gj[k])])
          for k in ("dense", "lines")}
    jg["mlp"] = np.concatenate(
        [np.asarray(g).reshape(-1) for branch in ("sig", "col")
         for layer in gj["mlp"][branch]
         for g in (np.asarray(layer["w"]).T, layer["b"])])
    jg["var"] = np.asarray(gj["var"]["b"]).reshape(1)
    out = [(float(lj), auxj, jg)]
    for change in ({},) + tuple(port_hash):
        pcfg = dataclasses.replace(cfg, hash=dataclasses.replace(cfg.hash,
                                                                 **change))
        field = ckpt.from_jax_params(params, pcfg)
        lp, auxp = step.loss_fn(
            field, nerf.scene_from_bounds(LO, HI), tbatch, pcfg, occ_p,
            torch.bfloat16, step=10,
            draws={"eik_idx": torch.tensor(np.asarray(eik_idx))},
            placement=[torch.tensor(np.asarray(a)) for a in (t, dt)])
        lp.backward()
        pg = {name: np.concatenate([p.grad.numpy().reshape(-1) for p in ps])
              for name, ps in (("dense", field.dense), ("lines", field.lines),
                               ("mlp", list(field.mlp.parameters())),
                               ("var", [field.var_b]))}
        out.append((float(lp.detach()), auxp, pg))
    return out


@pytest.mark.parametrize("layout", ["tight", "padded"])
def test_bf16_sdf_step_matches_jax_pallas(layout, monkeypatch):
    (lj, auxj, jg), (lp, auxp, pg) = bf16_sdf_step(
        monkeypatch, cp_impl="pallas", dense_impl="pallas", cp_layout=layout)
    assert lp == pytest.approx(lj, rel=1e-4)
    assert float(auxp["eikonal"]) == pytest.approx(float(auxj["eikonal"]),
                                                   rel=1e-4)
    for k in jg:
        assert pg[k].shape == jg[k].shape, k
        assert rel_norm(pg[k], jg[k]) <= BF16_STEP_GRAD, k


# The _xla twin (cp_impl and dense_impl "xla"): JAX's XLA encoders round
# each lax.map block's partial gradient to bf16 and add the CP blocks' in
# bf16; the port follows them in plain PyTorch (ops/xla_encoders.py).  The
# same step held to JAX's XLA path, measured: dense 1.5e-7, lines 5.7e-6,
# mlp 1.3e-6, var 0 of their norms: XLA_STEP_GRAD.  Under the Pallas
# roundings the port was 0.62 (dense), 0.36 (lines), 0.28 (mlp) and 1.3e-3
# (var) from it; its own bf16-vs-f32 spread on this step (the encoders in
# f32, the MLP in bf16) is 0.67, 0.52, 0.23 and 1.1e-3, and the port must
# stay below that spread too.
XLA_STEP_GRAD = 3e-3


def test_bf16_sdf_step_matches_jax_xla(monkeypatch):
    (lj, auxj, jg), (lp, auxp, pg), (_, _, pallas), (_, _, f32) = (
        bf16_sdf_step(monkeypatch, port_hash=(
            {"cp_impl": "pallas", "dense_impl": "pallas"},
            {"dense_bf16": False}), cp_impl="xla", dense_impl="xla"))
    got = {k: rel_norm(pg[k], jg[k]) for k in jg}
    before = {k: rel_norm(pallas[k], jg[k]) for k in jg}
    spread = {k: rel_norm(pg[k], f32[k]) for k in jg}
    print(f"port vs JAX xla {got}; Pallas roundings vs JAX xla {before}; "
          f"port bf16 vs f32 {spread}")
    assert lp == pytest.approx(lj, rel=1e-4)
    assert float(auxp["eikonal"]) == pytest.approx(float(auxj["eikonal"]),
                                                   rel=1e-4)
    for k in jg:
        assert pg[k].shape == jg[k].shape, k
        assert got[k] <= XLA_STEP_GRAD and got[k] < spread[k], k
