"""Configuration: the config dataclasses, plus level geometry.

A copy of the JAX package's ``utils/config.py`` (dataclasses, their
``__post_init__`` checks and properties, ``to_json``/``from_json``), so the
port imports nothing of that package.  The field names, defaults and JSON
layout are the same (tests/test_torch_boundary.py holds them equal), so a
run directory written by either package restores in the other.  Field
comments that speak of the TPU describe the reference's choices; the port
reads the same fields.

``level_scales`` is float64 numpy on the host, as in the JAX package
(ops/hash_encoding.py:45).  The kernels see it cast to f32; computed in f32
from the start, the flagship's finest line would become 1450 long instead
of 1449 and its checkpoints would no longer load.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class HashConfig:
    """Multiresolution hash-grid encoder (reference hash_encoding.py:5-39).

    ``n_min``/``n_max`` bracket the per-level resolutions
    ``N_l = n_min * b**l`` with ``b = exp((ln n_max - ln n_min)/(L-1))``
    (reference hash_encoding.py:13, 153).
    """

    num_levels: int = 16          # L
    features_per_level: int = 2   # F
    log2_table_size: int = 16     # T = 2**log2_table_size (power of two)
    n_min: int = 16
    n_max: int = 2048
    dim: int = 3
    init_scale: float = 1e-4      # U(-1e-4, 1e-4) table init (ref :32)
    # "corner": reference-exact layout — every corner hashed separately,
    #   corners shared across cells (C0-continuous field, 2**dim gathers
    #   per point-level).
    # "cell": TPU-fast layout — ONE hash per (point, level) cell whose
    #   bucket stores all 2**dim corner features contiguously (single
    #   row-gather; 8x fewer lookups; field is trilinear inside a cell
    #   but may be discontinuous across cell faces under collisions).
    # "cp": NO hash table at all — each fine level stores a rank-cp_rank
    #   CP factorisation (three 1-D factor lines, TensoRF-style) and the
    #   whole encoder evaluates as batched MXU matmuls: zero random
    #   gathers forward, zero scatters backward, no collisions, no
    #   stochastic estimators (ops/lowrank.py).  Per-level feature count
    #   is cp_rank (not features_per_level); coarse levels may still be
    #   dense 3-D grids via dense_levels.
    variant: str = "corner"
    # Training-time unbiased single-corner sampling (corner variant):
    # each corner bit is Bernoulli(frac), selecting corner c with exactly
    # its trilinear weight — 2**dim fewer gathers per step, which is the
    # dominant TPU cost (docs/PERF_NOTES.md).  Eval always uses the
    # exact interpolant.
    stochastic_train: bool = False
    # With stochastic_train: gather bf16 feature PAIRS packed into single
    # uint32 words (one lookup per point-level instead of two); custom
    # VJP scatters fp32 grads into the table.  Requires F == 2.
    packed: bool = False
    # With packed: scatter 2x the gradient of one randomly chosen feature
    # per (point, level) instead of both — unbiased, halves the backward
    # scatter volume.
    grad_subsample: bool = False
    # Stochastic-corner uniforms from the TPU hardware PRNG (a Pallas
    # kernel) instead of threefry; ignored off-TPU.
    hw_rng: bool = False
    # Store the first `dense_levels` (coarsest) levels as DENSE grids
    # (real Instant-NGP section 4 — the reference hashes every level,
    # hash_encoding.py:41-55) evaluated as MXU tensor-product matmuls
    # with no random gather/scatter at all (ops/dense_grid.py).  The
    # hash table then holds only the remaining num_levels - dense_levels
    # hashed levels.  Coarse levels become collision-free and their
    # training cost leaves the chip's lookup bottleneck entirely.
    dense_levels: int = 0
    # bf16 matmul operands on the dense path (fp32 accumulation); fp32
    # operands are ~6x slower on the MXU and only needed for parity tests.
    dense_bf16: bool = True
    # Dense-level implementation (mirrors cp_impl):
    #   "xla":    ops/dense_grid.py lax.map + dot (materialises the
    #             (block, G^2) pair-weight operand in HBM — measured
    #             31.9 ms of a 169 ms flagship step, encode_micro_r4),
    #   "pallas": ops/dense_pallas.py — every level fused in ONE kernel
    #             sweep, pair weights rebuilt in VMEM, third axis folded
    #             in-kernel; HBM traffic = points in + (N, D*F) out,
    #   "auto":   pallas on TPU when dense_bf16=True, xla elsewhere
    #             (the kernel computes in bf16 internally, same contract
    #             as cp_impl="auto").
    dense_impl: str = "auto"
    # Packed-gather word format (with `packed`):
    #   "bf16": F == 2 bf16 features per uint32 word,
    #   "int8": F features (2 or 4) as symmetric-int8 lanes of one word,
    #     dequantised by a per-level dynamic scale — 4 features per
    #     lookup at F=4, halving lookups again vs bf16 pairs.
    pack_format: str = "bf16"
    # With grad_subsample on the int8 path: ALSO route each point's
    # gradient to one randomly chosen level (scaled L x, unbiased) —
    # the backward scatter shrinks to one contribution per point.
    # Higher gradient variance; quality-check before enabling.
    grad_level_subsample: bool = False
    # Milder level subsampling (int8 path, with grad_subsample): split
    # the hashed levels into consecutive PAIRS and route each point's
    # gradient to one randomly chosen level of every pair (scaled 2x,
    # unbiased) — the backward scatter (the dominant step cost,
    # docs/PERF_NOTES.md) halves, and every point still feeds one level
    # of each resolution pair (vs grad_level_subsample's one level
    # total, which costs ~0.9 dB).  Requires an even number of hashed
    # levels; mutually exclusive with grad_level_subsample.
    grad_level_pair: bool = False
    # With `packed`: evaluate the EXACT (non-stochastic) path via packed
    # word reads too — one lookup per (corner, level) instead of F.
    # Features are then bf16/int8-rounded exactly as the training
    # forward reads them (the faithful read for a packed-trained model);
    # F x faster eval renders and mesh sweeps.  Set False to read the
    # fp32 master table instead.
    packed_eval: bool = True
    # TRAIN the exact (non-stochastic) trilerp through packed word
    # reads: one lookup per (corner, level) instead of F, exact
    # 8-corner interpolation, exact per-corner scatter backward
    # (hash_encode_packed_exact + its custom VJP).  Features are
    # bf16-rounded (F=2) / int8-quantised — the TPU analog of the
    # reference's fp16-autocast training (train_hash2.py:192, 218).
    # This is the fastest EXACT-SEMANTICS trainable mode; the fp32
    # master-table path stays the correctness oracle (bench.py
    # "exact_oracle").  Requires `packed`; independent of
    # stochastic_train.
    packed_exact_train: bool = False
    # Backward scatter-add strategy for the packed training paths:
    #   "random": plain .at[].add — every contribution pays the ~4KB
    #     random-write tile (measured ~77M contribs/s on v5e),
    #   "sorted": lax.sort the (index, value) pairs first, then a
    #     scatter with indices_are_sorted=True,
    #   "segsum": sort, collapse duplicate-index runs with a sorted
    #     segment sum, then ONE sorted scatter of unique indices.
    # Pick by measurement (scripts/tpu_probe_scatter.py); exact in all
    # cases (pure reassociation of the same sums).
    scatter_strategy: str = "random"
    # Rank of each CP level's factor lines (variant="cp"): every fine
    # level contributes cp_rank features (out_dim grows accordingly; the
    # MLP input is just wider — MXU-cheap).  16 matches the hash path's
    # per-level parameter count at T=2^16/F=4 within ~2x.
    cp_rank: int = 16
    # Factor-line init U(-s, s).  Features are products of `dim` line
    # entries, so s=0.1 puts the product at ~1e-3 (near the hash init
    # regime) while per-line gradients stay ~s**(dim-1).
    cp_init_scale: float = 0.1
    # CP two-hot matmul implementation:
    #   "xla":    ops/lowrank.py lax.map + dot (materialises the two-hot
    #             matrix in HBM — HBM-bound at flagship shapes),
    #   "pallas": ops/cp_pallas.py VMEM-resident kernel (W never leaves
    #             the chip; measured speedup in docs/PERF_NOTES.md r3),
    #   "auto":   pallas on TPU backends when dense_bf16=True (the
    #             kernel computes in bf16 internally), xla elsewhere —
    #             so dense_bf16=False keeps its f32 meaning on TPU.
    # Explicit "pallas" opts into bf16 kernel numerics regardless of
    # dense_bf16.
    cp_impl: str = "auto"
    # Pallas kernel W-scratch row layout (cp_impl="pallas"/"auto"):
    #   "tight":  per-level segments 8-aligned, only the total padded to
    #             128 — 13.5% fewer executed rows at the flagship ladder
    #             (the 2^k+2 line sizes each waste ~126 rows under
    #             per-segment 128 alignment).  Semantics-identical:
    #             hat rows are exactly zero outside their own segment
    #             (residual diffs are FMA-grouping-level only,
    #             tests/test_cp_pallas.py).
    #   "padded": the original per-segment 128 alignment.
    cp_layout: str = "tight"
    # Double-buffer the forward W scratch so consecutive axes' VPU hat
    # builds can overlap the previous axis' MXU matmul (the build is the
    # co-dominant kernel cost).  Costs one extra (block, total) bf16
    # scratch of VMEM.
    cp_fwd_db: bool = True
    # Level-parallel (tensor-parallel) encoding: name of the mesh axis
    # that shards the hash table's LEVEL dimension.  Set only inside
    # shard_map bodies (parallel/level_parallel.py builds it for you) —
    # the encoder then all_gathers per-chip feature blocks along this
    # axis before the MLP.  Lookups, the chip bottleneck, scale linearly
    # with the axis extent.  None = single-chip/no level sharding.
    level_axis: Optional[str] = None

    def __post_init__(self):
        if self.variant == "cp" and (self.stochastic_train or self.packed):
            raise ValueError(
                "variant='cp' has no hash table: the stochastic/packed "
                "gather estimators do not apply (CP is already exact and "
                "gather-free) — drop --stochastic/--packed")
        if self.grad_level_subsample and not (
                self.grad_subsample and self.pack_format == "int8"
                and self.packed):
            raise ValueError(
                "grad_level_subsample requires packed int8 with "
                "grad_subsample (it extends the 1-of-F routing to "
                "1-of-(L,F)); without them it would silently do nothing")
        if self.grad_level_pair:
            if not (self.grad_subsample and self.pack_format == "int8"
                    and self.packed):
                raise ValueError(
                    "grad_level_pair requires packed int8 with "
                    "grad_subsample (it extends the 1-of-F routing to "
                    "1-of-2 levels per consecutive pair)")
            if self.grad_level_subsample:
                raise ValueError(
                    "grad_level_pair and grad_level_subsample are "
                    "mutually exclusive (pick one level-routing scheme)")
            if self.dense_levels >= 0 and self.num_hashed_levels % 2:
                # dense_levels == -1 is the "auto" sentinel some CLIs
                # resolve AFTER construction; the final replace() with
                # the resolved count re-runs this check
                raise ValueError(
                    "grad_level_pair needs an even number of hashed "
                    f"levels, got {self.num_hashed_levels}")
        if self.packed_exact_train and not self.packed:
            raise ValueError(
                "packed_exact_train requires packed=True (it trains "
                "through the packed word-read exact forward)")
        if self.scatter_strategy not in ("random", "sorted", "segsum"):
            raise ValueError(
                f"unknown scatter_strategy {self.scatter_strategy!r}; "
                "expected random | sorted | segsum")

    @property
    def table_size(self) -> int:
        return 2 ** self.log2_table_size

    @property
    def num_hashed_levels(self) -> int:
        return self.num_levels - self.dense_levels

    @property
    def corners(self) -> int:
        return 2 ** self.dim

    @property
    def payload(self) -> int:
        """Feature floats stored per bucket."""
        if self.variant == "cell":
            return self.features_per_level * self.corners
        return self.features_per_level

    @property
    def out_dim(self) -> int:
        if self.variant == "cp":
            return (self.dense_levels * self.features_per_level
                    + self.num_hashed_levels * self.cp_rank)
        return self.num_levels * self.features_per_level


@dataclasses.dataclass(frozen=True)
class PosEncConfig:
    """Frequency positional encoding for view directions.

    ``mode='linear'`` reproduces the reference's linear frequency ladder
    sin(2*x*k), cos(2*x*k), k=0..num_freq-1 (reference encoder.py:27-29);
    ``mode='nerf'`` is the standard geometric 2**k ladder.
    """

    d_model: int = 3
    num_freq: int = 4
    mode: str = "linear"  # "linear" | "nerf"

    @property
    def out_dim(self) -> int:
        return self.d_model * self.num_freq * 2


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """Hash-NeRF MLP head (reference test_hash.py:20-77).

    Density branch: Linear(in, width) -> ReLU -> [num_sig blocks] ->
    (1 + geo_feat_dim); colour branch Linear(geo_feat_dim + d_view, width)
    -> ... -> 3.  ``rgb_activation`` defaults to ``sigmoid`` (bounded
    colours; better PSNR); ``elu`` matches the reference exactly
    (reference test_hash.py:67).
    """

    width: int = 64
    num_sig: int = 2        # hidden blocks in the density branch
    num_col: int = 2        # hidden blocks in the colour branch
    geo_feat_dim: int = 15
    density_activation: str = "leaky_relu"  # or "sdf" (2*sigmoid-1)
    rgb_activation: str = "sigmoid"         # "sigmoid" | "elu" (reference)
    # The port's own fields (the JAX package has none of them; their
    # defaults leave every JAX configuration as it is).  ``head``
    # "mlp3d" is the head above; "neuralangelo" is Neuralangelo's
    # NeuralSDF and IDR NeuralRGB (models/sdf_head.py), whose SDF MLP's
    # hidden layer and feature are ``sdf_width`` wide and whose colour
    # MLP's layers are ``rgb_width`` wide.
    head: str = "mlp3d"
    sdf_width: int = 256
    rgb_width: int = 256


@dataclasses.dataclass(frozen=True)
class ClassicNeRFConfig:
    """Vanilla NeRF MLP (reference vol_renderer.py:12-86)."""

    d_input: int = 60
    n_layers: int = 8
    d_filter: int = 256
    skip: Tuple[int, ...] = (4,)
    d_viewdirs: Optional[int] = 60


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Volume rendering (reference vol_renderer.py:88-245, helper.py:53-107)."""

    near: float = 2.0
    far: float = 6.0
    num_samples: int = 64
    num_fine_samples: int = 0      # >0 enables hierarchical second pass
    hierarchical: bool = False
    per_ray_jitter: bool = True    # reference shares one jitter across the
                                   # batch (helper.py:210-237); per-ray is
                                   # strictly better and the default
    log_sampling: bool = False
    sigma_clip_min: float = -10.0  # reference helper.py:76
    use_sdf: bool = False
    white_background: bool = False
    # Scene normalisation feeding the hash encoder:
    #   "diagonal": mu = min bound, sigma = ||max-min||_2 (reference
    #     train_hash2.py:117-119 — uses only ~58% of each level's range),
    #   "unit_box": per-axis (x - lo)/(hi - lo) — full table utilisation.
    normalization: str = "diagonal"
    occupancy: bool = False        # occupancy-grid culling
    occupancy_resolution: int = 256  # max_dim//4 (ref vol_renderer.py:106)
    # Density threshold below which a cell is culled (the EMA grid's
    # mask cut).  The default matches Instant-NGP's 0.01 regime for
    # hash fields; CP fields may need it paired with sigma_l1_weight
    # (empty-space fog) — calibrate via quality_matrix occ_frac.
    occ_threshold: float = 0.01
    # With occupancy on, keep only the first `compact_samples` occupied
    # samples of each ray (depth-ordered static compaction): the field
    # runs on B x K points instead of B x S.  0 disables. Empty-space
    # intervals contribute nothing (their cells have zero density), so
    # compositing over the kept subset with full-ladder dt is exact as
    # long as no occupied sample overflows the K budget.
    compact_samples: int = 0
    # With occupancy on: place training samples by inverse-CDF over the
    # OCCUPIED probe intervals of each ray (num_samples probes,
    # compact_samples-or-num_samples placed) instead of stratified +
    # top-K truncation — proportional coverage with no truncation risk
    # (NerfAcc-style, ops/sampling.py occupancy_guided_ts).
    occ_guided: bool = False
    # Probe-interval count for occ_guided (0 = num_samples).  Each probe
    # is one tile-priced random grid lookup (docs/PERF_NOTES.md), so
    # fewer probes directly cut the per-step occupancy cost; the grid
    # cell size bounds the useful resolution (128 probes over a 4-unit
    # ray span vs 128^3 cells over the scene — ~64 probes loses nothing).
    occ_probes: int = 0
    # With occ_guided: fraction of each ray's sample mass routed to its
    # EMPTY-marked intervals so wrongly-culled cells keep training and
    # can recover (ops/sampling.py occupancy_guided_ts exploration floor).
    occ_explore: float = 0.05
    # With occ_guided: randomise each probe's position within its
    # interval per ray per step instead of probing the fixed midpoint —
    # decorrelates interval-classification errors across steps (a fixed
    # ladder repeats the same misses every step; measured convergence
    # inversion at 128 probes, docs/PERF_NOTES.md).
    occ_probe_jitter: bool = False
    # With occ_guided: dt estimator. "clip" runs dt to the next sample
    # clipped at the probe-interval end (biased low when samples are
    # sparser than probe intervals); "mass" is the unbiased
    # importance-weighted estimator dt = h*W/(K*m) (ops/sampling.py
    # occupancy_guided_ts docstring).  Default "mass": on the hard
    # textured scene it reaches 30.24 dB at step 2000 where clip needs
    # 6000 steps for 30.18, and converges +0.78 dB higher (30.96 vs
    # 30.18 at 6000) at identical step rate (docs/PERF_NOTES.md
    # "Unbiased mass-dt").
    occ_dt: str = "mass"
    # With occ_guided training: draw the inverse-CDF u's stratified
    # (one jittered draw per 1/K CDF stratum) instead of iid uniform.
    # Strictly lower-variance placement, makes the mass-dt "each sample
    # carries 1/K of the ray's mass" assumption structural, and the
    # monotone u lets occupancy_guided_ts skip its per-ray sort.
    # Off by default pending the on-chip quality A/B (batch G).
    occ_stratified: bool = False
    # EVAL-time guided placement (serving): >0 renders each ray with
    # this many DETERMINISTIC inverse-CDF samples (stratified quantiles
    # of the per-ray occupied-probe CDF, exploration off, occupancy mask
    # applied) instead of the full `num_samples` ladder.  The ladder's
    # cost is lookups x samples, so a 32-48 budget cuts serving latency
    # ~3-4x; quality vs the exact ladder is measured per checkpoint
    # (cli/render.py --eval_guided).  Requires an occupancy grid.
    eval_guided: int = 0
    # The port's own (the ``neuralangelo`` head): NeuS up-sampling of
    # ``num_samples`` stratified depths by ``neus_rounds`` rounds of
    # ``neus_fine_samples``.
    neus_fine_samples: int = 16
    neus_rounds: int = 4


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer (reference train_hash2.py:141-162 optimizer/schedule setup)."""

    num_epochs: int = 1000
    ray_batch: int = 16000          # --num_batch
    lr_hash: float = 0.05           # Adam on the hash table
    lr_mlp: float = 0.005           # AdamW on the MLP
    lr_final: float = 1e-4          # cosine floor (CosineAnnealingLR eta_min)
    schedule: str = "cosine"        # "cosine" (train_hash2.py:156-162) or
                                    # "onecycle" (train_hash.py:133-142);
                                    # the port adds "two_steps"
                                    # (Neuralangelo's, below)
    weight_decay: float = 0.01
    eikonal_weight: float = 0.1     # reference train_hash2.py:224
    # Eikonal point budget per step (0 = all B*S sample points, the
    # reference semantics).  The eikonal term costs SIX extra encoder
    # evaluations at its points (finite-difference normals); at the
    # quality-protocol shape that is ~12.6M encodes/step — the SDF
    # step's HLO is the one module that reproducibly crashes the
    # remote compile helper (qm_r4_sdf3.json: pure-XLA impl too), and
    # a regulariser does not need every point.  16k subsampled points
    # shrink the module ~100x and the eikonal cost to noise.
    eikonal_subsample: int = 0
    lr_var: float = 0.01            # SDF var-model optimizer (ref :165)
    seed: int = 0
    compute_dtype: str = "bfloat16"  # TPU analog of the fp16 autocast
                                     # (reference train_hash2.py:192, 218)
    update_rate: int = 15            # occupancy-grid update cadence
    write_every: int = 0             # steps between eval renders (0 = auto)
    # 1-D total-variation weight on the CP factor lines (variant="cp"
    # only; TensoRF §5.3's TV regulariser restated for factor LINES):
    # mean squared first difference along each line's spatial axis.
    # Pure elementwise VPU work — no gathers — and additively separable
    # over rank columns, so it is exact under rank parallelism
    # (parallel/level_parallel.py shards the rank axis; each chip's
    # slice-local term IS its slice of the global objective).  0 = off.
    cp_tv_weight: float = 0.0
    # Steps to hold cp_tv at ZERO before enabling it (0 = on from step
    # 0).  TV flattens the early density fit; if the occupancy warmup
    # refresh reads that flattened field it wrongly culls the subject
    # and guided placement starves (the humanoid-scene collapse,
    # qm_r3_humanoid3.json / docs/PERF_NOTES.md).  Set past
    # occ_warmup_steps so culling locks on before smoothing begins.
    cp_tv_warmup: int = 0
    # L1 sparsity weight on sampled (positive) densities — TensoRF
    # §5.3's density L1 restated for this sampler.  Suppresses
    # empty-space fog so occupancy culling converges; essential for CP
    # fields, whose separable factor products cannot represent exact
    # zeros away from the subject (docs/PERF_NOTES.md round 3).  0 = off.
    sigma_l1_weight: float = 0.0
    # Steps trained WITHOUT culling before the occupancy grid engages.
    # Culling decisions taken from a near-random field are wrong and
    # (with top-K compaction) self-reinforcing: truncated rays train a
    # foggy field whose density keeps every cell above threshold, so the
    # grid never converges and quality collapses (measured: holdout
    # 15.6 dB vs 28.8 unculled on the hard scene, quality_matrix.json).
    occ_warmup_steps: int = 256
    # The port's own (the ``neuralangelo`` head, whose ``schedule`` is
    # "two_steps": a linear warm-up over ``warmup_steps``, then the base
    # rate, a tenth of it from 0.6 of the horizon and a hundredth from
    # 0.8).  The curvature term's weight ramps up over ``warmup_steps``
    # too; coarse to fine, ``c2f_init_levels`` levels are active at
    # first (0: all, always) and one more every ``c2f_every`` steps after
    # the warm-up (models/sdf_head.py ``stage``).
    warmup_steps: int = 5000
    c2f_init_levels: int = 0
    c2f_every: int = 5000


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Full experiment config."""

    hash: HashConfig = dataclasses.field(default_factory=HashConfig)
    dir_enc: PosEncConfig = dataclasses.field(default_factory=PosEncConfig)
    mlp: MLPConfig = dataclasses.field(default_factory=MLPConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def __post_init__(self):
        if self.train.cp_tv_weight > 0.0 and self.hash.variant != "cp":
            raise ValueError(
                "cp_tv_weight > 0 requires encoder variant 'cp' (the TV "
                "regulariser acts on CP factor lines, which only that "
                f"variant has; got variant={self.hash.variant!r}) — drop "
                "--cp_tv or add --encoder_variant cp")


def to_json(cfg: PipelineConfig, path: str):
    """Persist a config next to its checkpoint so downstream tools
    (mesh export) rebuild the exact same model without re-specifying
    encoder/MLP flags."""
    import json

    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def from_json(path: str) -> PipelineConfig:
    import json

    with open(path) as f:
        d = json.load(f)
    sections = {"hash": HashConfig, "dir_enc": PosEncConfig,
                "mlp": MLPConfig, "render": RenderConfig,
                "train": TrainConfig}
    kwargs = {}
    for name, cls in sections.items():
        sec = d.get(name, {})
        fields = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in sec.items() if k in fields}
        tup = {f.name for f in dataclasses.fields(cls)
               if "Tuple" in str(f.type) or "tuple" in str(f.type)}
        for k in tup & known.keys():
            known[k] = tuple(known[k])
        kwargs[name] = cls(**known)
    return PipelineConfig(**kwargs)


def level_scales(cfg: HashConfig) -> np.ndarray:
    """Per-level resolutions N_l = n_min * b**l (float64, host)."""
    if cfg.num_levels == 1:
        return np.asarray([float(cfg.n_min)])
    b = np.exp((np.log(cfg.n_max) - np.log(cfg.n_min)) / (cfg.num_levels - 1))
    return cfg.n_min * b ** np.arange(cfg.num_levels)


def fine_scales(cfg: HashConfig) -> np.ndarray:
    """The resolutions of the levels after the dense ones (CP or hashed),
    cast to f32 as every encoder uses them."""
    return np.asarray(level_scales(cfg)[cfg.dense_levels:], np.float32)


def flagship_config() -> PipelineConfig:
    """The zero-flag ``--preset flagship`` config of the JAX trainer
    (cli/train_hash.py resolve_preset + make_config with default flags):
    CP encoder, 7 levels up to n_max 1448 at rank 25, auto dense levels,
    occupancy-guided mass-dt placement on a 128-sample ladder."""
    from human_body_reconstruction_tpu_torch.ops import dense_grid

    hcfg = HashConfig(n_max=1448, log2_table_size=16, num_levels=7,
                      features_per_level=2, variant="cp", cp_rank=25,
                      dense_levels=0)
    hcfg = dataclasses.replace(
        hcfg, dense_levels=dense_grid.auto_dense_levels(hcfg))
    return PipelineConfig(
        hash=hcfg,
        mlp=MLPConfig(density_activation="leaky_relu",
                      rgb_activation="sigmoid"),
        render=RenderConfig(
            near=2.0, far=6.0, num_samples=128, hierarchical=False,
            use_sdf=False, white_background=False, occupancy=True,
            compact_samples=48, occ_guided=True, occ_probes=32,
            occ_explore=0.05, occ_probe_jitter=False, occ_dt="mass",
            occ_stratified=True, occ_threshold=0.01, eval_guided=0,
            normalization="diagonal"),
        train=TrainConfig(
            num_epochs=1000, ray_batch=16000, update_rate=15, seed=0,
            occ_warmup_steps=256, cp_tv_weight=1e-2, cp_tv_warmup=256 + 64,
            sigma_l1_weight=0.0, eikonal_subsample=16384),
    )


def neuralangelo_config() -> PipelineConfig:
    """Neuralangelo (Li et al., CVPR 2023) at the widths of its
    ``projects/neuralangelo/configs/base.yaml``: a 16-level hash grid of 8
    features a level in 2^22-entry tables from resolution 2^5 to 2^11,
    the ``neuralangelo`` head (SDF MLP 131 -> 256 -> 1 + 256, colour MLP
    four layers of 256), six-tap numerical gradients and curvature, NeuS
    compositing of 64 stratified depths up-sampled by 4 rounds of 16, 1,024
    rays a step, AdamW at 1e-3 on the two-step schedule, eikonal weight
    0.1, curvature 5e-4, coarse to fine from 4 levels every 5,000 steps,
    f32 MLPs.  The scene keeps the port's normalisation."""
    return PipelineConfig(
        hash=HashConfig(num_levels=16, features_per_level=8,
                        log2_table_size=22, n_min=32, n_max=2048,
                        variant="corner", init_scale=1e-4),
        mlp=MLPConfig(head="neuralangelo", density_activation="sdf"),
        render=RenderConfig(near=2.0, far=6.0, num_samples=64, use_sdf=True,
                            occupancy=False, neus_fine_samples=16,
                            neus_rounds=4),
        train=TrainConfig(ray_batch=1024, lr_hash=1e-3, lr_mlp=1e-3,
                          schedule="two_steps", weight_decay=0.01,
                          eikonal_weight=0.1, lr_var=1e-3,
                          compute_dtype="float32",
                          warmup_steps=5000, c2f_init_levels=4,
                          c2f_every=5000),
    )
