"""The neuralangelo head (models/sdf_head.py) held to the plain reference
(benchmark/reference/neuralangelo.py, the one the benchmark's
``neuralangelo.train`` cell holds the program to) on the CPU at a small
size: L 4, F 8, T 2^10, MLPs 32 wide, 8 rays, 8 + 2 x 4 samples, seeded
random weights.

Tolerances.  Both sides compute in f32 with the same operations in the same
order, but not in the same batches: the reference encodes and multiplies
a block of rays at a time, the program every point at once, so a GEMM or a
sum may round differently.  f agrees to a few f32 ulps of its size
(rtol 1e-5).  Differences of taps divide by eps, one cell of the finest
active level in world units (the scene's diagonal, 12.2 here, over 81 at
the taps' stage: 0.15): grad f by 2 eps (an ulp of f, 6e-8, becomes 2e-7
of grad f: atol 2e-6), the Laplacian by eps^2 (an ulp becomes 3e-6: atol
1e-4).  Up-sampled depths
sit on the sigmoid of f at sharpness up to 128, which amplifies an ulp of
f to 1e-5 of a depth at most (atol 1e-5).  Weights, colour and loss are
smooth in those (rtol 1e-4).  Gradients collect every term above, the
curvature's 1/eps^2 included (rtol 2e-3 of the leaf's norm).  The same
computation with bf16 MLP operands moves f by its 8-bit mantissa (4e-3):
its loss misses by 5e-4 and its gradients by 0.07 of a leaf's norm
(``test_bf16_operands_fail_the_tolerances``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from benchmark.reference import neuralangelo as ref
from human_body_reconstruction_tpu_torch.models import nerf, sdf_head
from human_body_reconstruction_tpu_torch.ops import sampling
from human_body_reconstruction_tpu_torch.train import state as state_lib
from human_body_reconstruction_tpu_torch.train import step as step_lib
from human_body_reconstruction_tpu_torch.utils import config as C

from torch_threads import one_torch_thread  # noqa: F401

RAYS = 8
HORIZON = 1000


def tiny_cfg(**train):
    base = C.neuralangelo_config()
    return dataclasses.replace(
        base,
        hash=dataclasses.replace(base.hash, num_levels=4, log2_table_size=10,
                                 n_max=128),
        mlp=dataclasses.replace(base.mlp, sdf_width=32, rgb_width=32),
        render=dataclasses.replace(base.render, num_samples=8,
                                   neus_fine_samples=4, neus_rounds=2),
        train=dataclasses.replace(base.train, ray_batch=RAYS, warmup_steps=10,
                                  c2f_every=10, c2f_init_levels=2, **train))


def pipeline_dict(cfg):
    return {k: dataclasses.asdict(getattr(cfg, k))
            for k in ("hash", "dir_enc", "mlp", "render", "train")}


def tiny_dataset(seed=0):
    """Two 8x8 views of random colours looking at the origin from radius
    3.5 (the synthetic scenes' orbit)."""
    g = torch.Generator().manual_seed(seed)
    c2ws = []
    for theta in (0.3, 2.0):
        eye = np.array([3.5 * np.cos(theta), 3.5 * np.sin(theta), 1.0])
        fwd = eye / np.linalg.norm(eye)
        right = np.cross([0.0, 0.0, 1.0], fwd)
        right /= np.linalg.norm(right)
        m = np.eye(4, dtype=np.float32)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = (right, np.cross(fwd, right),
                                                  fwd, eye)
        c2ws.append(m)
    K = torch.tensor([[8.0, 0, 4], [0, 8.0, 4], [0, 0, 1]])
    return {"images": torch.rand((2, 8, 8, 3), generator=g),
            "c2ws": torch.as_tensor(np.stack(c2ws)), "K": K, "H": 8, "W": 8}


def setup(cfg, seed=3):
    p = pipeline_dict(cfg)
    weights = ref.init_weights(p, seed, torch.device("cpu"))
    field = nerf.Field(cfg)
    sdf_head.load_leaves(field, weights)
    ds = tiny_dataset()
    lo, hi = ref.bounds_of(ds, cfg.render.near, cfg.render.far)
    scene = nerf.scene_from_bounds(lo, hi)
    return p, weights, field, ds, scene


def rays(seed=1):
    g = torch.Generator().manual_seed(seed)
    o = torch.tensor([[0.2, -0.1, 4.0]]).repeat(RAYS, 1)
    d = torch.nn.functional.normalize(
        torch.randn((RAYS, 3), generator=g) * 0.1 + torch.tensor([0, 0, -1.0]),
        dim=-1)
    return o, d


def stage_pair(cfg, p, count):
    return (sdf_head.stage(cfg, torch.tensor(count, dtype=torch.int32),
                           HORIZON), ref.stage(p, count, HORIZON))


def test_taps_match_reference():
    """f, the feature, grad f and the Laplacian at random points (the
    centre and six taps as one encode), at a stage with 3 of 4 levels."""
    cfg = tiny_cfg()
    p, w, field, _, scene = setup(cfg)
    st, rst = stage_pair(cfg, p, 40)
    assert rst["active"] == 3
    x = torch.rand((64, 3), generator=torch.Generator().manual_seed(5)) - 0.5
    with torch.no_grad():
        f, feat, grad, lap = sdf_head.taps(field, scene, x, cfg, st)
        rf, rfeat, rgrad, rlap = ref.taps(w, p, x, scene, rst,
                                          ref.Rounding(None))
    torch.testing.assert_close(f, rf, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(feat, rfeat, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(grad, rgrad, rtol=0, atol=2e-6)
    torch.testing.assert_close(lap, rlap, rtol=0, atol=1e-4)


@pytest.mark.parametrize("count", [40, 50])
def test_taps_step_one_cell_of_the_finest_active_level(count):
    """The taps lie one cell of the finest active level from their centre
    in the grid's coordinates, (x - mu) / sigma times the level's scale
    (the paper's grid size, Eq. 7-8): the +x tap's cell index there is its
    centre's plus one, while at the coarsest level it mostly stays."""
    cfg = tiny_cfg()
    p, _, _, _, scene = setup(cfg)
    st, rst = stage_pair(cfg, p, count)
    res = sdf_head.resolutions(cfg)
    eps = sdf_head.tap_step(st, scene)
    assert float(eps) == pytest.approx(
        float(scene["sigma"]) / res[rst["active"] - 1], rel=1e-6)
    x = torch.rand((4096, 3), generator=torch.Generator().manual_seed(6)) - 0.5
    q = sdf_head.tap_batch(x, eps)
    centre, plus_x = q[:4096], q[4096:].reshape(4096, 6, 3)[:, 0]
    scales = ref.level_scales(p["hash"])

    def cell(pts, level):
        xn = (pts - scene["mu"]) / scene["sigma"]
        return torch.floor(xn[:, 0] * float(scales[level]))

    top = rst["active"] - 1
    moved = cell(plus_x, top) - cell(centre, top)
    assert float((moved == 1).float().mean()) >= 0.99
    assert float((cell(plus_x, 0) == cell(centre, 0)).float().mean()) >= 0.5


def test_upsampled_depths_match_reference():
    """The 4 + 2 x 4 up-sampled depths from the same stratified draws."""
    cfg = tiny_cfg()
    p, w, field, _, scene = setup(cfg)
    st, rst = stage_pair(cfg, p, 40)
    o, d = rays()
    u = torch.rand((RAYS, 8), generator=torch.Generator().manual_seed(2))
    t0 = sdf_head.stratified(RAYS, cfg, o.device, jitter=True, u=u)
    torch.testing.assert_close(t0, ref.stratified(RAYS, p["render"], u),
                               rtol=0, atol=0)
    with torch.no_grad():
        t = sampling.neus_upsample(
            t0, o, d, lambda q: sdf_head.sdf_only(field, scene, q, cfg, st),
            4, 2)
        rt = ref.upsample(w, p, o, d, t0, scene, rst, ref.Rounding(None))
    assert t.shape == (RAYS, 16)
    assert bool((t[:, 1:] >= t[:, :-1]).all())
    torch.testing.assert_close(t, rt, rtol=0, atol=1e-5)
    # the rounds' depths crowd where the surface is: not all stratified
    assert not torch.equal(t[:, :8], t0)


def test_neus_weights_and_colour_match_reference():
    """Given the same depths: the NeuS weights, f and the colour."""
    cfg = tiny_cfg()
    p, w, field, _, scene = setup(cfg)
    o, d = rays()
    u = torch.rand((RAYS, 8), generator=torch.Generator().manual_seed(2))
    st, rst = stage_pair(cfg, p, 40)
    with torch.no_grad():
        out = sdf_head.render_rays(field, scene, o, d, cfg, jitter=True,
                                   draws={"u": u}, st=st)
        col, gnorm, lap, sdf, wts = ref.render(w, p, o, d, out["t"], scene,
                                               rst, ref.Rounding(None))
    torch.testing.assert_close(out["density"], sdf, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out["weights"], wts, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(out["fine"], col, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(out["eikonal_norm"], gnorm, rtol=0, atol=2e-6)
    torch.testing.assert_close(out["laplacian"], lap, rtol=0, atol=1e-4)
    assert float(out["weights"].sum(-1).max()) <= 1.0 + 1e-6


def _program_steps(cfg, field, ds, scene, seed, n, start=0):
    st = state_lib.create_train_state(field, cfg.train, HORIZON)
    st.step = start
    gen = torch.Generator().manual_seed(seed)
    losses, grads = [], None
    for k in range(n):
        m = step_lib.train_step(st, scene, ds["images"], ds["c2ws"], ds["K"],
                                cfg, RAYS, gen)
        losses.append(float(m["loss"]))
        if k == 0:
            grads = {name: st.opt.moments(v)[0] / (1 - ref.ADAM_B1)
                     for name, v in sdf_head.named_leaves(field).items()}
    return losses, grads


def _reference_steps(p, w0, ds, scene, seed, n, rnd, start=0, fault=None):
    w = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    mom = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in w.items()}
    gen = torch.Generator().manual_seed(seed)
    sc = {"mu": scene["mu"], "sigma": scene["sigma"]}
    losses, grads = [], None
    for k in range(n):
        losses.append(ref.train_step(w, p, ds, sc, start + k, HORIZON, gen,
                                     rnd, fault))
        if k == 0:
            grads = {name: v.grad.clone() for name, v in w.items()}
        ref.adam_update(w, mom, p, start + k, HORIZON)
    return losses, grads, {k: v.detach() for k, v in w.items()}


def _grad_gaps(got, want):
    return {k: float(torch.linalg.vector_norm(got[k] - want[k])
                     / max(float(torch.linalg.vector_norm(want[k])), 1e-30))
            for k in want}


@pytest.mark.parametrize("start", [0, 45])
def test_step_loss_gradients_and_update_match_reference(start):
    """One step's loss and every leaf's gradient, and the parameters after
    three steps of Adam, from the same weights and draws: at the warm-up's
    first count (lr 0, curvature weight 0) and past it (3 levels active)."""
    cfg = tiny_cfg()
    p, w0, field, ds, scene = setup(cfg)
    losses, grads = _program_steps(cfg, field, ds, scene, 11, 3, start)
    rl, rg, rw = _reference_steps(p, w0, ds, scene, 11, 3,
                                  ref.Rounding(None), start)
    np.testing.assert_allclose(losses, rl, rtol=1e-4)
    gaps = _grad_gaps(grads, rg)
    assert max(gaps.values()) < 2e-3, gaps
    after = sdf_head.named_leaves(field)
    for k, v in rw.items():
        torch.testing.assert_close(after[k].detach(), v, rtol=2e-3,
                                   atol=1e-6, msg=k)


def test_bf16_operands_fail_the_tolerances():
    """The reference with bf16 MLP operands (the precision below the
    configuration's f32) misses the loss or the gradient tolerance."""
    cfg = tiny_cfg()
    p, w0, field, ds, scene = setup(cfg)
    losses, grads = _program_steps(cfg, field, ds, scene, 11, 1, 45)
    rl, rg, _ = _reference_steps(p, w0, ds, scene, 11, 1,
                                 ref.Rounding(torch.bfloat16), 45)
    loss_gap = abs(losses[0] - rl[0]) / abs(rl[0])
    assert loss_gap > 1e-4 or max(_grad_gaps(grads, rg).values()) > 2e-3


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_planted_faults_move_the_step(fault):
    """Each planted fault of the reference moves the loss or a leaf's
    gradient past the tolerances that the sound step keeps."""
    cfg = tiny_cfg()
    p, w0, field, ds, scene = setup(cfg)
    sound = _reference_steps(p, w0, ds, scene, 11, 1, ref.Rounding(None), 45)
    bad = _reference_steps(p, w0, ds, scene, 11, 1, ref.Rounding(None), 45,
                           fault)
    loss_gap = abs(bad[0][0] - sound[0][0]) / abs(sound[0][0])
    assert loss_gap > 1e-4 or max(_grad_gaps(bad[1], sound[1]).values()) > 2e-3


@pytest.mark.parametrize("count", [0, 9, 10, 29, 30, 40, 50, 60, 10 ** 6])
def test_schedule_stages(count):
    """Levels masked, eps, the curvature weight and the cosine anneal at
    counts on both sides of each stage change (warm-up 10, a level every
    10 after it from 2 of 4): device, host and reference agree."""
    cfg = tiny_cfg()
    p = pipeline_dict(cfg)
    dev, rst = stage_pair(cfg, p, count)
    host = sdf_head.stage_host(cfg, count, HORIZON)
    want_active = {0: 2, 9: 2, 10: 2, 29: 2, 30: 2, 40: 3, 50: 4, 60: 4,
                   10 ** 6: 4}[count]
    assert host["active_levels"] == rst["active"] == want_active
    mask = dev["mask"].reshape(4, 8)
    assert torch.equal(mask[:, 0], (torch.arange(4) < want_active).float())
    res = sdf_head.resolutions(cfg)
    assert float(dev["eps"]) == rst["eps"] == np.float32(
        1.0 / res[want_active - 1])
    assert float(dev["curvature_weight"]) == pytest.approx(
        rst["curvature_weight"], rel=1e-6)
    assert host["curvature_weight"] == pytest.approx(
        rst["curvature_weight"], rel=1e-6)
    assert float(dev["anneal"]) == pytest.approx(rst["anneal"], rel=1e-6)
    if count <= 10:
        assert rst["curvature_weight"] == pytest.approx(5e-4 * count / 10)


def test_published_schedule_and_resolutions():
    """The published ladder: res 33 ... 2048 (32 g^15 rounds below 2048 in
    float64, as the source computes it), 4 levels until step 30,000, all
    16 from 85,000, eps 1 / 2048 there (in the grid's units), the curvature
    weight 5e-4 / g^15."""
    cfg = C.neuralangelo_config()
    res = sdf_head.resolutions(cfg)
    assert (res[0], res[-1], len(res)) == (33, 2048, 16)
    for step, active in ((0, 4), (29_999, 4), (30_000, 5), (84_999, 15),
                         (85_000, 16), (400_000, 16)):
        assert sdf_head.stage_host(cfg, step, 500_000)["active_levels"] == \
            active
    late = sdf_head.stage_host(cfg, 85_000, 500_000)
    assert late["eps"] == 1.0 / 2048
    assert late["curvature_weight"] == pytest.approx(5e-4 / 64.0, rel=1e-9)
    assert late["anneal"] == 1.0
    assert cfg.hash.out_dim == 128 and sdf_head.sdf_dims(cfg) == [
        (131, 256), (256, 257)]
    assert sdf_head.rgb_dims(cfg) == [(278, 256), (256, 256), (256, 256),
                                      (256, 256), (256, 3)]


def test_window_across_a_stage_change_matches_single_steps():
    """A window of steps across a stage change reads each step's stage from
    the device count: the same as single steps (on the CPU the window is
    the eager loop; the card's graph is the ``cuda`` case below)."""
    cfg = tiny_cfg()
    _, _, f1, ds, scene = setup(cfg)
    _, _, f2, _, _ = setup(cfg)
    s1 = state_lib.create_train_state(f1, cfg.train, HORIZON)
    s2 = state_lib.create_train_state(f2, cfg.train, HORIZON)
    s1.step = s2.step = 38
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    step_lib.train_step_multi(s1, scene, ds["images"], ds["c2ws"], ds["K"],
                              cfg, RAYS, 4, g1)
    for _ in range(4):
        step_lib.train_step(s2, scene, ds["images"], ds["c2ws"], ds["K"], cfg,
                            RAYS, g2)
    for (k, a), b in zip(sdf_head.named_leaves(f1).items(),
                         sdf_head.named_leaves(f2).values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_point_counters_count_a_step():
    """A step's centre, tap and up-sampling points."""
    cfg = tiny_cfg()
    _, _, field, ds, scene = setup(cfg)
    before = (sdf_head.centre_points, sdf_head.tap_points,
              sdf_head.upsample_points)
    _program_steps(cfg, field, ds, scene, 1, 1)
    assert sdf_head.step_points() == {"centre": RAYS * 16,
                                      "taps": 6 * RAYS * 16,
                                      "upsample": RAYS * (8 + 4)}
    assert (sdf_head.centre_points - before[0],
            sdf_head.tap_points - before[1],
            sdf_head.upsample_points - before[2]) == (128, 768, 96)


def test_unported_routes_are_named():
    """The head refuses what it does not run: F 8 stochastic or packed
    reads, CP, an occupancy grid, a per-axis normalisation, level ranks."""
    cfg = C.neuralangelo_config()
    assert sdf_head.unported(cfg) is None
    for bad in (dict(stochastic_train=True), dict(packed=True),
                dict(variant="cp")):
        c = dataclasses.replace(cfg, hash=dataclasses.replace(cfg.hash, **bad))
        assert sdf_head.unported(c) is not None
    for bad in (dict(occupancy=True), dict(normalization="unit_box")):
        c = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, **bad))
        assert sdf_head.unported(c) is not None
    assert sdf_head.unported(cfg, level_parallel=2) is not None


def test_preset_run_checkpoint_restores_and_meshes(tmp_path):
    """``train_hash --preset neuralangelo`` at a tiny size through
    ``Trainer.run`` writes a checkpoint that ``pipeline/restore.py``
    restores into the same field and ``nerf2mesh --iso 0`` meshes."""
    from human_body_reconstruction_tpu_torch.cli import nerf2mesh, train_hash
    from human_body_reconstruction_tpu_torch.pipeline import restore

    out = str(tmp_path / "run")
    trainer = train_hash.main([
        "--preset", "neuralangelo", "--synthetic", "--steps", "4",
        "--num_batch", "32", "--hash_size", "10", "--num_levels", "4",
        "--max_res", "64", "--num_samples", "8", "--log_every", "2",
        "--steps_per_call", "2", "--device", "cpu", "--out_dir", out])
    cfg = trainer.cfg
    assert (cfg.mlp.head, cfg.hash.features_per_level, cfg.mlp.sdf_width,
            cfg.train.ray_batch) == ("neuralangelo", 8, 256, 32)
    assert trainer.history[-1]["active_levels"] == 4
    res = restore.restore(out, "default", device="cpu", log_fn=lambda s: None)
    assert res.cfg == cfg
    for (k, a), b in zip(sdf_head.named_leaves(res.field).items(),
                         sdf_head.named_leaves(trainer.state.field).values()):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0, msg=k)
    stats = nerf2mesh.main([
        "--ckpt_dir", out, "--resolution", "16", "--iso", "0", "--cache", "",
        "--chunk", "4096",
        "--out", str(tmp_path / "mesh.ply"), "--device", "cpu"])
    assert stats["num_verts"] > 0 and os.path.exists(tmp_path / "mesh.ply")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs and kernels run only on "
                    "the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_window_replays_the_step_across_a_stage_change(cuda_device):
    """On the card: two 4-step windows of one captured step across the
    stage change at 40 (2 -> 3 levels): one capture, 7 replays, the point
    counters a step's, no MLP3D call, and the parameters' change within a
    hundredth of eager single steps' (the hash backward's float atomics
    sum in another order on each run; Adam's first steps take an entry
    whose gradient is rounding by the whole rate)."""
    from human_body_reconstruction_tpu_torch.ops import mlp_kernel

    cfg = tiny_cfg()
    p = pipeline_dict(cfg)
    ds = {k: v.to(cuda_device) if torch.is_tensor(v) else v
          for k, v in tiny_dataset().items()}
    lo, hi = ref.bounds_of(ds, cfg.render.near, cfg.render.far)
    scene = nerf.scene_from_bounds(lo, hi, device=cuda_device)
    w0 = ref.init_weights(p, 3, cuda_device)
    fields = [nerf.Field(cfg, device=cuda_device) for _ in range(2)]
    states = []
    for f in fields:
        sdf_head.load_leaves(f, w0)
        s = state_lib.create_train_state(f, cfg.train, HORIZON)
        s.step = 36
        states.append(s)
    data = (ds["images"], ds["c2ws"], ds["K"])
    composed = mlp_kernel.composed_calls
    graph = step_lib.WindowGraph()
    g1 = torch.Generator(cuda_device).manual_seed(9)
    for _ in range(2):
        step_lib.train_step_multi(states[0], scene, *data, cfg, RAYS, 4, g1,
                                  graph=graph)
    assert (graph.captures, graph.replays, states[0].step) == (1, 7, 44)
    assert sdf_head.step_points() == {"centre": RAYS * 16,
                                      "taps": 6 * RAYS * 16,
                                      "upsample": RAYS * 12}
    g2 = torch.Generator(cuda_device).manual_seed(9)
    for _ in range(8):
        step_lib.train_step(states[1], scene, *data, cfg, RAYS, g2)
    torch.cuda.synchronize()
    assert mlp_kernel.composed_calls == composed
    got = sdf_head.named_leaves(fields[0])
    want = sdf_head.named_leaves(fields[1])
    for k, v in w0.items():
        a = float(torch.linalg.vector_norm(got[k].detach() - v))
        b = float(torch.linalg.vector_norm(want[k].detach() - v))
        assert abs(a - b) <= 1e-2 * max(b, 1e-12), (k, a, b)


def test_head_takes_the_fields_own_calls():
    """The field dispatches once, through ``field.mlp``: the neuralangelo
    head renders, meshes and records its stage itself; MLP3D has no stages
    and the head refuses MLP3D's encoded-view call."""
    cfg = tiny_cfg()
    p, _, field, _, scene = setup(cfg)
    assert field.mlp.renders
    plain = nerf.Field(C.PipelineConfig(),
                       generator=torch.Generator().manual_seed(0))
    assert not plain.mlp.renders
    assert plain.mlp.stage_key(cfg, 10 ** 6) is None
    assert plain.mlp.stage_record(cfg, 10 ** 6, HORIZON, scene) == {}
    rec = field.mlp.stage_record(cfg, 45, HORIZON, scene)
    assert rec["active_levels"] == ref.stage(p, 45, HORIZON)["active"] == 3
    assert rec["normal_eps"] == pytest.approx(
        float(scene["sigma"]) / sdf_head.resolutions(cfg)[2], rel=1e-6)
    x = torch.rand((32, 3), generator=torch.Generator().manual_seed(7)) - 0.5
    with torch.no_grad():
        rgb, f = field.mlp.sweep(field, scene, x, cfg)
        # the sweep's GEMMs take the taps too: other batches, other sums
        torch.testing.assert_close(
            f, nerf.density_only(field, scene, x, cfg), rtol=1e-5, atol=1e-6)
    assert rgb.shape == (32, 3)
    with pytest.raises(NotImplementedError):
        nerf.field_forward(field, scene, x, torch.zeros((32, 3)), cfg)
