#!/usr/bin/env python3
"""Drive the PyTorch port's training and serving paths once on one CUDA card.

1. Build the port's CUDA kernels from csrc/ with nvcc (one process per
   source, all started together) and the marching-cubes extension from
   native/ with g++.  Then, before any phase profiles, read with
   torch.profiler the device operations of one call of the int8 pack, the
   cell forward, the pairs kernel and the packed-exact forward on seeded
   inputs at the paths' shapes: each its one kernel, by name, and no memset
   or copy (a profiler that records nothing fails the run).
2. Flagship training (the zero-flag run, at full width): render the
   synthetic textured dataset (20 views, 400x400, 384 GT samples), train it
   through the port's CLI objects for TRAIN_STEPS steps with the occupancy
   warmup cut to OCC_WARMUP (the TV warmup follows it), every kernel's
   launch count reset just before and counted per phase; print step time
   and rays/s of the unculled and the guided phase, occupied fraction and
   train PSNR.  Then hold each backward kernel to its plain version at the
   two training shapes (768,000 and 2,048,000 points) on the path's own
   points (a seeded ray batch's occupancy-guided placement and unculled
   128-sample ladder, each ray's samples consecutive) and on uniform random
   points; one training step's loss and gradients on the card to the same
   step on the CPU (plain versions); profile one guided step; save,
   restore and serve the trained model.
3. Hash-grid training (``--stochastic --hw_rng``, the reference repo's own
   model at full width: corner hash grid, L 16, T 2^16, n_max 2048, 64
   samples, 16,000 rays, no occupancy grid) on the same dataset for
   HASH_STEPS steps, the three hash-path kernels' launch counts reset just
   before; print ms/step, rays/s, PSNR and launches.  Hold the Philox kernel
   to its plain version bit for bit (and its mean and chi^2 on the card) and
   the hash forward (with its stochastic corner bits) and backward kernels,
   in both modes, to theirs on the path's own points (a seeded ray batch on
   the jittered 64-sample ladder, 1,024,000 points, each ray's samples
   consecutive, u of (3, 16, 1,024,000)) and on as many uniform random
   points, and the exact forward on a 16384-ray chunk of a served frame's
   64-sample ladder; print the cells a point visits per level on the path;
   one stochastic step on the card against the CPU from the same batch,
   ladder and encoder uniforms; profile one step; serve the trained model
   exact on a 64-sample ladder, the forward's launches counted.
4. Serving: write a full-width (flagship preset) run directory in the JAX
   layout: seeded random weights, config JSON, bounds, and an occupancy
   grid whose mask is a seeded ball around the subject.  Restore it
   through the port's server and answer a 400x400 frame on the
   128-sample ladder, one at eval_guided 64, a 4-pose orbit batch and a
   health request, with every kernel's launch count reset just before.
   Then the fused MLP3D kernels (csrc/mlp.cu) at the flagship head's
   shapes, forward and backward on the guided and unculled training points
   and forward on a serving chunk, held to the composed ``_linear`` path
   (outputs, and gradients against ``mlp_kernel.plain_backward``) and timed
   against it and the same layers as cuBLAS bf16 GEMMs (``mlp_phase``),
   with the launches the training run and the served requests counted.
   The training runs and every served request call ``MLP3D`` through the
   kernels alone (``mlp_kernel.composed_calls`` 0 after each).
5. Hold each forward kernel against its plain PyTorch version on the card
   at the serving shape, on a 16384-ray chunk of a 400x400 frame's
   128-sample ladder (2,097,152 points; the dense kernel writing the
   column block of the encoder's (N, 129) matrix, as the encoder does) and
   on as many uniform random points (about 70% of them outside the unit
   box of normalised coordinates), and a whole frame rendered through the
   kernels against the same frame through the plain versions (on the
   CPU).

6. The quality protocol, cut in depth: ``cli/quality_holdout.py`` on the
   textured scene (20 + 4 views at 400x400, 384 ground-truth samples), the
   n1448 mode at horizon 6000 for QUALITY_STEPS steps (the grid installed
   after 256, refreshed at 320): time per step, rays/s, occupied fraction
   and each holdout pose's dB, the mean held above QUALITY_FLOOR_DB.
7. The render CLI: ``cli/render.py --orbit 4 --use_occ --eval_guided 64``
   on the flagship run directory trained in 2; the PNGs decode, frame 0
   equals ``render_image`` of the same pose and config bit for bit, the
   forward kernels' launches counted.
8. Mesh export: ``cli/nerf2mesh.py`` on the flagship run directory at 256^3
   and on the hash-grid run directory of 3 at 128^3, at iso 30 and again
   (from the density cache the first export wrote) at half the sweep's
   99.9th percentile of sigma, since these short runs stay below 30: sweep
   and marching seconds, vertex and face counts, each forward kernel's
   launches during the sweep (64 at 256^3, 8 at 128^3, none from the
   cache), a non-empty mesh inside the scene bounds; one sweep chunk
   (262,144 lattice points, k fastest) through the kernels held to the
   same chunk through the plain versions on the card, the encoder outputs
   and the quantised rgb8 and sigma16 bit for bit.
9. SDF mode: ``cli/quality_holdout.py --mode cp_r21_sdf_guided_es16k`` (the
   quality matrix's SDF mode, full width: 8 levels, n_max 2048, rank 21,
   dense G 18 and 34, subsampled eikonal) on the textured scene, cut to
   320 steps: ms/step, rays/s, the eikonal term, the sharpness var_b,
   occ_frac and the holdout; one step of the saved model on the card
   against the CPU from the same batch, guided placement and eikonal
   indices (loss, every gradient, var_b's included); each encoder kernel
   against its plain version on that step's 98,304 eikonal points (16384
   points at six clipped offsets), the forwards into their columns of the
   encoder's (N, 130) matrix bit for bit.  The saved run is served through
   ``cli/serve.py --use_sdf``: an SDF model, one 200x200 frame through the
   forward kernels, finite and not flat.
10. The hierarchical pass: the same for ``cp_r21_hier_64f64_tv1e2`` (64 + 64
    samples, no grid) cut to 96 steps, the card-vs-CPU step on 4096 rays,
    the kernels on a 16384-ray batch's second-pass points (2,097,152).
11. Continuation: the SDF mode's Trainer at full width (warmup cut to 16)
    trains 24 steps, saves, a fresh Trainer loads (the loaded params,
    moments, counts, step, grid and generator equal to the saved ones bit
    for bit) and trains 16 more; each step's loss within CONT_LOSS_RTOL of
    40 steps in one run.
12. The TPU's own trained SDF weights (``qm_params_*.npz``): the 4
    holdout poses at 400x400, 128 exact samples, beside each record's
    per-pose PSNR and, on every 4th pixel, within JAX_CPU_DB of the JAX
    package on the CPU (``tpu_weights_jax_cpu.json``, written by
    ``tools/tpu_weights_jax_cpu.py``); the xla weights meshed at 192^3, iso
    auto, against the TPU's ``sdf_mesh_textured_r5.ply`` (vertex and face
    counts, symmetric mean nearest-vertex distance in voxels).
13. The new flags through their CLIs: ``train_hash --use_sdf
    --hierarchical`` on the flagship preset for 8 steps, ``--load`` for 8
    more; ``render`` and ``nerf2mesh`` with ``--use_sdf --hierarchical`` on
    that run, the forward kernels' launches counted.
14. The capture front end: the textured humanoid's 20 protocol training
    views rendered at 400x400 and written as PNG frames (``data/png.py``)
    with a COLMAP text model of their cameras; ``cli/colmap2nerf.py
    --text`` (sharpness on), then ``cli/reconstruct.py --skip_poses
    --segment_backend threshold`` at its defaults (the flagship encoder,
    16000 rays x 64 samples, diagonal normalisation, a 256^3 mesh at iso
    30) cut to RECON_STEPS steps, with no cv2, Pillow, ffmpeg or COLMAP:
    each stage's seconds, PNG decode times (the run's frames, and
    Paeth-filtered 400x400 and 1920x1080 ones), train PSNR, ms a step,
    the sweep and marching, the threshold mask's IoU against the
    silhouette (printed, not held); the recovered poses equal the rendered
    ones under the normalising similarity (1e-5), the frames read back
    exactly, the PSNR rises, the mesh is non-empty and inside the run's
    bounds; the four encoder kernels on one ray batch of the run's own
    points (768,000), forwards bit for bit.
15. The 2-D image fit (``cli/image_fit.py`` at its defaults: L 16, F 2, T
    2^18, n_max 2^16, 500 steps): ``--synthetic`` (256x256, batch 65,536),
    then ``--image`` on a 512x512 PNG of the same procedural target written
    by ``data/png.py`` (batch 200,000): ms a step, the final full-image
    PSNR above IMAGE_FIT_FLOOR_DB, the 2-D hash kernels' launches (a
    forward and a backward a step, one more forward for full_pred); both
    kernels against plain on the image run's first batch and its 262,144
    full_pred points (forward bit for bit, backward within the sum-order
    tolerance), timed beside their bounds and the library calls below.
16. ``cli/train_vanilla.py --synthetic --write`` at its defaults (8x256,
    1024 rays x 64 samples, 1000 iterations): ms a step, the test view's
    PSNR beside the untrained model's and an all-black image's, the same
    view again from the saved checkpoint; one step from the CLI's initial
    weights card vs CPU (loss and gradients).
17. ``train_hash --plot_grads --display`` on the flagship, PLOT_GRADS_STEPS
    steps on the textured scene: every log record's grad-norm keys, the
    preview PNG read back, the encoder kernels' launches (the probe's
    backward among them); a ``schedule="onecycle"`` Trainer of
    ONECYCLE_STEPS steps, its rates against the closed form.
18. The held-back tangle: ``cli/quality_holdout.py --scene tangle
    --scene_seed 101`` in the record's mode, its ground truth (20 + 4
    views, 400x400, 384 samples) rendered on the card, cut to
    QUALITY_STEPS: the JAX keys, finite PSNRs, 0 < occ_frac < 1, the field
    computed on the card only.
19. The wide CP ladders and the corner hash grid: ``cp_r64_guided_k48_mass``
    (C 384), ``cp_l12_r32_guided_k48_mass`` (9 CP levels, C 288, 3 dense
    levels) and ``exact`` through the protocol for MODE_STEPS, then their
    kernels against plain on the 2,097,152 ladder points of a seeded
    batch: the forwards bit for bit (the CP one into the matrix and into
    its own output), the backwards within the sum-order tolerance.
20. ``cli/speedrun.py`` with the record's gating (guided 48 every 125
    steps), capped at 375 steps: the JAX keys, every gate render finite,
    the last one guided.
21. The parallel slice (PR 12), on the one card: ``train_hash
    --data_parallel`` through its ``main`` at the flagship's full width
    (DP_STEPS steps, the grid installed at DP_WARMUP) and with
    ``--stochastic --hw_rng`` (DP_HASH_STEPS), each a world of one on NCCL
    in this process, launches counted per run; one data-parallel step of
    the trained flagship, and one level-parallel step (``make_lp_train_step``
    on a (1, 1) layout: the shard's gather, the CP block reorder, the TV's
    psum) of the hash grid and of the ``--cp_rank 32`` ladder with the TV
    on, each against ``train_step`` from the same generators (handed the
    same backward-kernel sums, every metric, gradient and updated parameter
    bit for bit; launching its own float-atomic sums, metrics and the MLP
    bit for bit and the kernels' sums within the sum-order tolerance; the
    NCCL all-reduce a bit-for-bit identity); the level shards of the hash
    grid (16 levels at extents 2 and 4, exact and stochastic, on the hash
    path's 1,024,000 points) and the rank shards of the ``--cp_rank 32``
    ladder (C 80 and 40 a rank, on the flagship's 768,000 guided points),
    each rank's encode run one after another through ``encode_params``
    and joined by ``join_level_blocks`` as the gather joins them, launches
    counted per drive: the forward bit for bit with the unsharded encode's,
    the backward within the sum-order tolerance of the plain sums, each
    shard shape's kernels held to plain and timed, Philox at a level
    rank's (3, L/k, N); the sample-split render of a 400x400 frame at 1,024
    samples (density with occupancy and a white background, SDF with
    occupancy; 2, 4 and 8 segments one after another, combined) within
    1e-5 of the one-pass render; and 2 flagship-width scenes fitted
    together for 4 steps against two single-scene runs from the same
    generators, the parameter limit held below what one skipped update
    moves a group.
22. The hash-grid variants: ``cli/quality_holdout.py`` in four
    modes cut in depth (``cell`` and ``packed_gsub`` 64 unculled steps,
    ``int8_dense_guided_lvl`` and ``int8_dense_guided_k32_mass_lpair`` 288,
    past the grid's install at 256): finite holdout PSNRs, 0 < occ_frac < 1
    where the mode culls, each path's kernels launched;
    ``cli/speedrun.py --encoder int8`` capped after its third gate;
    ``train_hash --stochastic --hw_rng --packed --grad_subsample
    --scatter_strategy sorted`` and ``segsum`` and ``train_hash
    --packed_exact`` (bf16 words read by the packed-exact forward, one launch
    a step) for SCATTER_STEPS steps; a frame of the int8 run served through
    the packed-exact read, and the run meshed by ``cli/nerf2mesh.py`` at
    INT8_SWEEP_RES^3 (64 chunks, each one packed-exact launch).  Then each
    new kernel against its plain version, forwards and packs bit for bit,
    backwards within the sum-order tolerance: on the hash path's 1,024,000
    points (L 16, F 2, T 2^16) the bf16 pack (beside the bf16 cast), the
    bf16 stochastic and packed-exact forwards (beside ``embedding_bag`` on
    the unpacked table given the rows and weights), its 1-of-2 backward
    (beside ``index_add_`` given the pairs), the pairs and the sorted and
    segsum adds (beside ``index_add_`` given the sorted pairs;
    ``torch.sort`` of the pairs printed), the cell pair (beside
    ``embedding_bag``/``index_add_`` given its rows and weights), and the
    cell pair again on the cell mode's own first-pass points of a
    PROTOCOL_RAYS batch (2,097,152 at 128 samples a ray); on the int8
    modes' own first-pass points (6 hashed levels, F 4) the int8 pack, the
    stochastic and packed-exact forwards and the lpair and lvl backwards
    (beside ``index_add_`` given the pairs); the packed-exact forward on
    the middle chunk of the int8 run's INT8_SWEEP_RES^3 sweep (262,144
    lattice points).  Each packed-exact record also gives its sectors (the
    distinct 32-byte sectors the eight corner words of each (point, level)
    span, summed) and its L2 sector figure: their bytes over the L2 read
    rate of ``torch.sum`` over an L2-resident 24 MB buffer, measured
    beside them.  And, on the same
    points, the A/B: the f32 stochastic and exact kernels, and the 1-of-2,
    lpair and lvl backwards (one thread a point and its drawn terms)
    against the run walk (the unsubsampled stochastic backward) given
    their routed gradient, whose undrawn terms are zero.
23. The one-dispatch paths.  Windows of training steps as replays
    of one captured step (``step.WindowGraph``), each from one snapshot of
    the trained state against eager steps: the flagship guided step
    (768,000 points, 25 steps; its grid refreshed in place after the
    capture), the flagship unculled step (2,048,000 points, 25 steps) and
    the hash grid's ``--stochastic --hw_rng`` step (8 steps): every step's
    draws (batch indices and pixels, sampler uniforms, Philox seeds,
    recorded inside the graph) bit for bit, the first step's loss bit for
    bit and its gradients within the sum-order tolerance or twice a second
    eager step's spread, the parameters and moments after the window bit
    for bit with eager's when a graph is handed the eager run's
    backward-kernel sums (every run starts from the state the capture
    window left, so the checked window is replays only; launching its own
    sums, the distance after the window is printed beside a second eager
    run's and one update's), the window's mean metrics the mean of its
    steps; eager and graphed ms a step, device-busy ms and
    kernels a step (torch.profiler over one step and one replay); then the
    trainers' ``run`` with ``steps_per_call`` 25 and 8.  The parallel
    windows, each a world of one on NCCL with its collectives
    captured in the graph, held to eager parallel steps by the same checks
    (and: the step's collectives called while the stream captured, none
    but the ranks' agreement called in a replayed window): the
    data-parallel flagship guided step (25 steps), the ``--cp_rank 32``
    ladder's rank-parallel step with the TV on (8) and the hash grid's
    level-parallel ``--stochastic --hw_rng`` step (8); then ``train_hash
    --data_parallel --steps_per_call 25`` through its ``main`` at the
    flagship's full width (its grid installed between the two windows) and
    with ``--level_parallel 1 --stochastic --hw_rng``, the port's kernels
    counted over each run by torch.profiler.  The fused renders
    on the serving weights: the server's 400x400 frame and 4-pose batch
    and ``render --fused`` equal their eager chunks bit for bit, wall_s
    with the capture excluded; ``cli/speedrun.py --steps_per_call 25``
    beside the eager speedrun of phase 20.
24. Neuralangelo (``neuralangelo_phase``; alone: ``python -c 'import
    chip_smoke, torch; chip_smoke.neuralangelo_phase(torch.device("cuda"),
    "")'``): its published widths on the textured scene through
    ``Trainer.run`` in 25-step windows across the stage change at step
    85,000 (one capture, the ``hbr.train.stage`` span), ms a step, the
    point counters, the ``hbr.sdf.*`` spans of one eager step, the Adam
    kernel's host launches and elements over the windows (one a group at
    the warm-up and the capture) and its kernels in a replayed window, the
    F 8 hash kernels in the 2^22-entry table against their plain versions
    on a step's 917,504 centre and tap points, and the Adam kernel alone on
    a group of the table's 536,870,912 entries: bit for bit against the
    foreach passes, timed beside them and torch's ``_fused_adam_``.

Each kernel's bound is the larger of the bytes its call must move (each
input read once, each output written once) over 3.35 TB/s and its scalar
operations over the card's rate for them (67 TFLOP/s f32; 33.5 TOP/s for
the integer Philox rounds, which an H100 SM issues on 64 of its 128 lanes a
clock), from this run's shapes.  ``library_ms`` is one PyTorch call that
computes the same function: ``torch.rand`` for the Philox kernel;
``F.grid_sample`` (trilinear, ``align_corners=True``, f32, one call a
level) for the dense forward and its ``grid_sampler_3d_backward`` (the
volume's gradient) for the dense backward; ``F.embedding_bag(mode="sum")``
given the rows and weights for the hash forward (3-D and 2-D) and
``index_add_`` given the rows and the weighted terms for the hash
backward; for the CP forward ``F.embedding_bag(mode="sum")`` over the f32
stacked lines, one bag of a (point, level, axis)'s two hat rows and
weights, (3, N, C) out (the product over the axes left out), and for the
CP backward ``index_add_`` of those rows and their terms (weight times the
axis's dT) into an f32 (3*sum_G, R) accumulator.  Kernel times are CUDA events over a
run of launches queued behind a device sleep, so they are the device's
time, not the host's enqueue.

Any failure ends the run with a nonzero exit.  Output: the card's name and
power limit, per-phase, per-request and per-kernel lines, the smoke's wall
time, then one JSON line listing the seven kernels (launches counted on the
path that runs each; the encoder kernels once per shape, named for it and
with a "shape" key: {cp,dense}_forward/serving_path and /random,
{cp,dense}_backward/guided_path, guided_random, unculled_path and
unculled_random, hash_forward/train_path, /random and /serving_path
(exact), hash_backward/train_path and /random,
{cp,dense,hash}_forward/sweep_chunk, {cp,dense}_{forward,backward}/
eikonal_points, /fine_pass and /reconstruct_path,
hash_{forward,backward}_2d/image_fit_batch and /full_pred,
{cp,dense}_{forward,backward}/r64_path and /l12_path (and
cp_forward/*_path_contiguous), hash_{forward,backward}/exact_path,
hash_{forward,backward}/level_shard_k2 and _k4,
hash_{forward,backward}/neuralangelo_step, adam/neuralangelo_table,
uniform_bits/level_shard_k2 and _k4, cp_{forward,backward}/rank_shard_k2
and _k4, with the launches of the phase that runs each shape; a shard
shape runs on a step only under ``--level_parallel`` on 2 or 4 cards, so
its row gives the launches of the serial drive of its k ranks' encodes),
and the hash-variant kernels' records, named for their kernel and
path (``hash_pack/bf16_table``, ``packed_forward/int8_exact_path``,
``packed_forward/bf16_exact_train_path``,
``packed_forward/int8_exact_sweep_chunk``,
``hash_backward/int8_lpair_path``, ``add_sorted/segsum_train_path``,
``cell_forward/protocol_path``, ``cell_backward/protocol_path``, ...),
the MLP3D kernels' (``mlp3d/guided_train``, ``/unculled_train``,
``/serving_chunk``), and last
``{"ok": true, "device": {...}}``.

Run:  python3 chip_smoke.py      (needs one CUDA card; exits 2 without one)
"""

from __future__ import annotations

import base64
import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark.counts import (F32_OPS_PER_S, HBM_BYTES_PER_S, INT32_OPS_PER_S,
                              PHILOX_OPS_PER_VALUE, bound_s)
from benchmark.trace import _union

SEED = 0
ROOT = os.path.dirname(os.path.abspath(__file__))   # the repo's checkout
N_POINTS = 16384 * 128          # one ladder chunk: 16384 rays x 128 samples
FWD_TOL = {"cp_forward": 1e-6,  # kernel vs plain: same operations, order
           "dense_forward": 1e-6}
FRAME_TOL = 1e-3                # card vs CPU: f32 math on two devices, bf16 MLP
TRAIN_STEPS = 200
OCC_WARMUP = 64                 # the preset's 256, cut to fit the time limit
TRAIN_POINTS = (16000 * 48, 16000 * 128)   # guided and unculled steps
# backward kernel vs plain: the same terms, summed by f32 atomics in another
# order, then rounded to bf16: ops/cuda_lib.sum_order_tolerance (one bf16
# ulp of the plain value + 2^-18 of the entry's sum of |terms| + 1e-6)
STEP_LOSS_RTOL = 1e-4           # one step, card vs CPU
STEP_GRAD_RTOL = 1e-2           # per group, ||card - cpu|| / ||cpu||
SOURCE = "human_body_reconstruction_tpu_torch/csrc/encoders.cu"
REPLACES = {    # the TPU kernel (or jnp code) each encoder kernel stands for
    "cp_forward": "human_body_reconstruction_tpu/ops/cp_pallas.py:143",
    # the same forward split per axis: the TPU's kernel past a 15.5 MB VMEM
    # stack, of the protocol's modes only the 12-level ladder's
    # (tools/cp_axis_split.py)
    "cp_forward_axis": "human_body_reconstruction_tpu/ops/cp_pallas.py:158",
    "dense_forward": "human_body_reconstruction_tpu/ops/dense_pallas.py:125",
    "cp_backward": "human_body_reconstruction_tpu/ops/cp_pallas.py:173",
    "dense_backward": "human_body_reconstruction_tpu/ops/dense_pallas.py:152",
    "hash_forward": "none (no TPU kernel: human_body_reconstruction_tpu/ops/"
                    "hash_encoding.py:259 gathers in jnp)",
    "hash_backward": "none (no TPU kernel: the autodiff scatter of "
                     "human_body_reconstruction_tpu/ops/hash_encoding.py:259)"}
HASH_SOURCE = "human_body_reconstruction_tpu_torch/csrc/hash.cu"
HASH_STEPS = 150
HASH_POINTS = 16000 * 64        # one step of the hash path: rays x samples
HASH_RUN = 16                   # points a hash backward thread merges (csrc/hash.cu)
BF16_OPS_PER_S = 989e12         # dense bf16 tensor cores
# the MLP kernels against the composed path, as the card tests hold them
# (tests/test_torch_mlp_kernel.py, whose docstring says why)
MLP_FLIP_SHARE = 1e-2
MLP_OUT_MAX = 1e-2
MLP_GRAD_SHARE = 1e-2
MLP_GRAD_MAX = 8.0
MLP_FEAT_MAX = 128.0
MLP_SOURCE = "human_body_reconstruction_tpu_torch/csrc/mlp.cu"
MLP_REPLACES = ("none (no TPU kernel: human_body_reconstruction_tpu/models/"
                "mlp.py _linear is jnp.dot(bf16, bf16, preferred_element_type="
                "f32), left to XLA)")
QUALITY_STEPS = 320             # the protocol's 6000-step horizon, cut in depth
# the holdout mean of the first card run (28.80 dB; H100 80GB HBM3, 700 W)
# less 2 dB for the nondeterministic sums of the backward kernels
QUALITY_FLOOR_DB = 26.8
SWEEP_CHUNK = 262144            # points a mesh-sweep chunk (cli/nerf2mesh.py)
MESH_RES = {"flagship": 256, "hash": 128}   # the sweeps' lattice sides
# the hierarchical mode through the kernels: its _xla twin (the record's)
# runs the JAX XLA path's roundings in plain PyTorch (ops/xla_encoders.py)
SDF_MODE, HIER_MODE = "cp_r21_sdf_guided_es16k", "cp_r21_hier_64f64_tv1e2"
# the wide CP ladders: rank 64 (C 384) on the 8-level ladder, and the
# 12-level ladder (3 dense levels, 9 CP levels, C 288); the corner hash grid
WIDE_MODES = ("cp_r64_guided_k48_mass", "cp_l12_r32_guided_k48_mass")
HASH_MODE = "exact"
# the records' 5088 and 352 steps, cut in depth: the SDF run installs its
# grid at 256 and refreshes it at 320; the wide ladders and the hash grid
# take a few unculled steps (their path: 16384 rays x 128 ladder samples)
MODE_STEPS = {SDF_MODE: 320, HIER_MODE: 96, WIDE_MODES[0]: 64,
              WIDE_MODES[1]: 64, HASH_MODE: 160}
# the held-back scene: the record's scene seed and mode
TANGLE_SEED, TANGLE_MODE = 101, "cp_r21_guided_k32_p32_tv1e2_strat"
# the time-to-target run: the record's gating (guided 48, every 125 steps),
# capped after the first guided gate (the grid installs at 256)
SPEEDRUN_ARGS = ("--encoder", "cp", "--cp_rank", "32", "--eval_every", "125",
                 "--eval_guided", "48", "--max_steps", "375",
                 "--eval_after_train_db", "0")
HIER_STEP_RAYS = 4096           # the hierarchical card-vs-CPU step's batch
CONT_STEPS, CONT_WARMUP = (24, 16), 16   # k, then m more; warmup cut to 16
PROTOCOL_RAYS = 16384           # the protocol's batch
CLI_STEPS = 8                   # train_hash --use_sdf --hierarchical, then --load
# reconstruct: the protocol's 20 training views; the depth cut to a run that
# installs the grid (256) and starts the TV (320), then a few timed steps
RECON_HW, RECON_VIEWS, RECON_STEPS, RECON_TIMED = 400, 20, 384, 32
# continued vs uninterrupted, per step on the card: the float-atomic
# backwards make two runs of the same steps differ, and the difference
# grows (an H100 80GB HBM3: 1.27e-2 at worst over 40 steps); a second
# uninterrupted run shows the same spread
CONT_LOSS_RTOL = 5e-2
TPU_WEIGHTS = {"cp_r21_sdf_guided_es16k": "qm_r5_sdf_pallas_600.json",
               "cp_r21_sdf_guided_xla_es16k": "qm_r5_sdf_xla_textured.json"}
JAX_CPU_SCORES = "tpu_weights_jax_cpu.json"   # tools/tpu_weights_jax_cpu.py
JAX_CPU_DB = 0.05               # port on the card vs JAX on the CPU, per pose
SDF_MESH = ("cp_r21_sdf_guided_xla_es16k", 192, "sdf_mesh_textured_r5.ply",
            "sdf_mesh_textured_r4.json")
IMAGE_FIT_HW = 512              # the --image target written for the image fit
IMAGE_FIT_FLOOR_DB = 20.0       # the JAX CLI test's floor (test_cli_extras.py)
PLOT_GRADS_STEPS = 32           # train_hash --plot_grads --display
ONECYCLE_STEPS = 10             # a onecycle trainer's horizon and steps
ONECYCLE_F32_TOL = 1e-6         # the f32 device rate vs the f64 closed form,
                                # over the base rate: a few f32 ulps
JAX_ROW_KEYS = ("mode", "steps", "rays_per_sec", "train_psnr", "holdout_psnr",
                "holdout_std", "holdout_min", "holdout_per_pose", "scene",
                "budget_s", "occ_frac")


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def time_ms(fn, reps: int = 20) -> float:
    """Device time of one call of fn: CUDA events around reps calls, queued
    behind a device sleep (about 25 ms) so that the host's enqueue of short
    calls is not what is timed."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(least time in ms, "bytes" or "operations") of a call that must move
    n_bytes and do ops scalar operations (benchmark/counts.py's bound)."""
    t = bound_s(n_bytes, ops, ops_per_s)
    return 1e3 * t, ("bytes" if t == n_bytes / HBM_BYTES_PER_S
                     else "operations")


def write_run_dir(path: str, device: torch.device):
    """Full-width model with seeded random weights, in the JAX layout."""
    from human_body_reconstruction_tpu_torch.data.synthetic import orbit_poses
    from human_body_reconstruction_tpu_torch.models.nerf import Field
    from human_body_reconstruction_tpu_torch.ops import occupancy, rays
    from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
    from human_body_reconstruction_tpu_torch.utils import config as C

    cfg = C.flagship_config()
    gen = torch.Generator().manual_seed(SEED)
    field = Field(cfg, generator=gen)
    with torch.no_grad():               # lift the tiny init to visible output
        for g in field.dense:
            g.mul_(5000.0)              # U(-1e-4, 1e-4) -> U(-0.5, 0.5)
        for ln in field.lines:
            ln.mul_(6.0)                # U(-0.1, 0.1) -> U(-0.6, 0.6)
        field.mlp.sig[-1].bias[0] += 2.0
    K = torch.tensor([[400.0, 0, 200.0], [0, 400.0, 200.0], [0, 0, 1]],
                     device=device)
    poses = torch.as_tensor(orbit_poses(4), device=device)
    lo, hi = rays.scene_bounds(400, 400, K, poses, cfg.render.near,
                               cfg.render.far)
    g = cfg.render.occupancy_resolution
    sigma = torch.sqrt(torch.sum((hi - lo) ** 2))
    c = (torch.arange(g, device=device) + 0.5) / g
    cells = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1)
    radius = 1.2 * (0.9 + 0.2 * torch.rand(
        (g, g, g), generator=torch.Generator(device).manual_seed(SEED + 1),
        device=device))
    mask = (torch.linalg.vector_norm(lo + cells * sigma, dim=-1)
            < radius).to(torch.float32)
    occ = occupancy.OccupancyGrid(mask, mask, torch.tensor(0.01))
    ckpt.save_params(f"{path}/flagship_ckpt.npz", field,
                     extra=ckpt.occ_extras(occ))
    C.to_json(cfg, f"{path}/flagship_config.json")
    ckpt.save_bounds(f"{path}/bounds_model.npy", lo.cpu().numpy(),
                     hi.cpu().numpy())
    return float(mask.mean())


def wrappers(*names):
    """(name, wrapper) of the named kernels, in the order given."""
    from human_body_reconstruction_tpu_torch.ops import (
        adam_kernel, cp_kernel, dense_kernel, hash_kernel, mlp_kernel,
        rng_kernel)

    table = {"mlp": mlp_kernel, "adam": adam_kernel,
             "cp_forward": cp_kernel.cp_encode_kernel,
             "dense_forward": dense_kernel.dense_encode_kernel,
             "cp_backward": cp_kernel.cp_encode_backward_kernel,
             "dense_backward": dense_kernel.dense_encode_backward_kernel,
             "hash_forward": hash_kernel.hash_encode_kernel,
             "hash_backward": hash_kernel.hash_encode_backward_kernel,
             "uniform_bits": rng_kernel.uniform_kernel}
    return [(nm, table[nm]) for nm in names]


TRAIN_KERNELS = ("cp_forward", "dense_forward", "cp_backward",
                 "dense_backward")


def train(run_dir: str, device: torch.device, tag: str):
    """The zero-flag flagship training run through the port's CLI objects.
    Returns (trainer, dataset, launches during training, launches during the
    unculled steps (warm-up included) and the guided ones (the install
    steps included))."""
    from human_body_reconstruction_tpu_torch.cli import train_hash
    from human_body_reconstruction_tpu_torch.ops import mlp_kernel, occupancy
    from human_body_reconstruction_tpu_torch.train.trainer import Trainer
    from human_body_reconstruction_tpu_torch.utils import config as C

    args = train_hash.build_parser().parse_args([
        "--synthetic", "--synthetic_subject", "textured", "--device", "cuda",
        "--occ_warmup", str(OCC_WARMUP), "--steps", str(TRAIN_STEPS),
        "--out_dir", run_dir, "--model_name", "flagship"])
    cfg = train_hash.make_config(args)
    train_hash.check_supported(args, cfg)
    want = C.flagship_config()
    check(cfg.hash == want.hash and cfg.mlp == want.mlp
          and cfg.render == want.render
          and cfg.train.ray_batch == want.train.ray_batch
          and cfg.train.cp_tv_warmup == OCC_WARMUP + 64,
          "the preset's full width, only the warmups cut")
    t0 = time.perf_counter()
    ds, _ = train_hash.load_dataset(args, device)
    torch.cuda.synchronize()
    print(f"train data: textured, {tuple(ds['images'].shape)} rendered on "
          f"the card in {time.perf_counter() - t0:.2f} s")
    trainer = Trainer(cfg=cfg, ds=ds, out_dir=run_dir, model_name="flagship",
                      total_steps=TRAIN_STEPS, log_fn=print)
    kernels = wrappers(*TRAIN_KERNELS, "mlp", "adam")
    for _, kern in kernels:
        kern.launches = 0
    mlp_kernel.composed_calls = 0
    torch.cuda.synchronize()
    phases, by_phase = {}, {"unculled": {}, "guided": {}}
    for name, n, kind in (("warm", 4, "unculled"),
                          ("unculled", OCC_WARMUP - 4, "unculled"),
                          ("install", 4, "guided"),
                          ("guided", TRAIN_STEPS - OCC_WARMUP - 4, "guided")):
        before = {nm: kern.launches for nm, kern in kernels}
        t0 = time.perf_counter()
        trainer.run(n, log_every=16)
        torch.cuda.synchronize()
        phases[name] = (n, time.perf_counter() - t0)
        for nm, kern in kernels:
            by_phase[kind][nm] = (by_phase[kind].get(nm, 0) + kern.launches
                                  - before[nm])
    launches = {nm: kern.launches for nm, kern in kernels}
    for name in ("unculled", "guided"):
        n, sec = phases[name]
        print(f"train {name}: {n} steps, {1e3 * sec / n:.2f} ms/step, "
              f"{n * cfg.train.ray_batch / sec:.1f} rays/s {tag}")
    hist = trainer.history
    occ_frac = float(occupancy.occupied_fraction(trainer.state.occ))
    print(f"train: {trainer.state.step} steps, occupied fraction "
          f"{occ_frac:.4f}, PSNR {hist[0]['psnr']:.2f} dB (step "
          f"{hist[0]['step']}) -> {hist[-1]['psnr']:.2f} dB (step "
          f"{hist[-1]['step']})")
    print(f"launches while training: {launches}; by phase: {by_phase}")
    check(trainer.state.step == TRAIN_STEPS and trainer.state.occ is not None,
          "trained past the occupancy warmup")
    check(all(math.isfinite(r["loss"]) for r in hist), "finite losses")
    check(hist[-1]["psnr"] > hist[0]["psnr"] + 1.0, "train PSNR rose")
    check(0.0 < occ_frac < 1.0, "the grid culls some cells and keeps some")
    check(all(n > 0 for n in launches.values()), launches)
    check(mlp_kernel.composed_calls == 0,
          ("every bf16 MLP3D call took the kernels", mlp_kernel.composed_calls))
    return trainer, ds, launches, by_phase


def training_path_points(trainer, device):
    """The points a training step encodes, ray-major as ``render_rays``
    flattens them (a ray's samples consecutive), from one seeded ray batch
    of the trained model: {"guided": the occupancy-guided placement (16000
    rays x 48), "unculled": the jittered 128-sample ladder (16000 x 128)}."""
    from human_body_reconstruction_tpu_torch.ops import sampling
    from human_body_reconstruction_tpu_torch.train import step

    cfg, st, r, ds = trainer.cfg, trainer.state, trainer.cfg.render, trainer.ds
    gen = torch.Generator(device).manual_seed(SEED + 7)
    o, d = step.sample_ray_batch(ds["images"], ds["c2ws"], ds["K"],
                                 cfg.train.ray_batch, gen)[:2]
    guided, _ = sampling.occupancy_guided_ts(
        o, d, st.occ, trainer.scene["mu"], trainer.scene["sigma"], r.near,
        r.far, r.compact_samples, num_probe=r.occ_probes, dt_mode=r.occ_dt,
        jitter=True, explore_frac=r.occ_explore,
        probe_jitter=r.occ_probe_jitter, stratified=r.occ_stratified,
        generator=gen)
    ladder = sampling.stratified_ts(
        (o.shape[0],), r.near, r.far, r.num_samples, r.log_sampling, device,
        jitter=True, per_ray_jitter=r.per_ray_jitter, generator=gen)
    return {name: (o[:, None, :] + d[:, None, :] * t[..., None]).reshape(-1, 3)
            for name, t in (("guided", guided), ("unculled", ladder))}


def serving_chunk_points(r, K, c2w, device, samples: int):
    """The points of one 16384-ray chunk of a 400x400 frame seen through K
    from c2w on the ``samples`` ladder of render config ``r`` (the frame's
    fifth chunk, through its middle rows), ray-major, as the server encodes
    them."""
    from human_body_reconstruction_tpu_torch.ops import rays, sampling

    o, d, _ = rays.full_image_rays(400, 400, torch.as_tensor(K, device=device),
                                   torch.as_tensor(c2w, device=device))
    o, d = o[4 * 16384:5 * 16384], d[4 * 16384:5 * 16384]
    t = sampling.stratified_ts((o.shape[0],), r.near, r.far, samples,
                               r.log_sampling, device)
    return (o[:, None, :] + d[:, None, :] * t[..., None]).reshape(-1, 3)


def hash_path_points(trainer, device):
    """The points a hash-grid training step encodes: one seeded ray batch
    (16000 rays) on the jittered 64-sample ladder, ray-major as
    ``render_rays`` flattens them (a ray's samples consecutive)."""
    from human_body_reconstruction_tpu_torch.ops import sampling
    from human_body_reconstruction_tpu_torch.train import step

    cfg, r, ds = trainer.cfg, trainer.cfg.render, trainer.ds
    gen = torch.Generator(device).manual_seed(SEED + 8)
    o, d = step.sample_ray_batch(ds["images"], ds["c2ws"], ds["K"],
                                 cfg.train.ray_batch, gen)[:2]
    t = sampling.stratified_ts((o.shape[0],), r.near, r.far, r.num_samples,
                               r.log_sampling, device, jitter=True,
                               per_ray_jitter=r.per_ray_jitter, generator=gen)
    return (o[:, None, :] + d[:, None, :] * t[..., None]).reshape(-1, 3)


def cells_per_point(pts, scene, scales, run: int):
    """Per level, the cells that the backward's runs of ``run`` consecutive
    points visit, per point: 1.0 when every point enters a new cell; run
    merging leaves this share of the corner adds."""
    xn = (pts - scene["mu"]) / scene["sigma"]
    first = torch.arange(pts.shape[0], device=pts.device) % run == 0
    out = []
    for s in scales:
        c = torch.floor(xn * float(s))
        new = first.clone()
        new[1:] |= (c[1:] != c[:-1]).any(-1)
        out.append(float(new.float().mean()))
    return out


def grid_sample_inputs(grids, x, mu, sigma, cfg):
    """The dense levels as ``F.grid_sample`` takes them, the yardstick of
    the dense kernels (never called by the port): per level the (1, F, G,
    G, G) f32 volume and the (1, 1, 1, N, 3) coordinates, in grid_sample's
    (z, y, x) order, u = 2 x_l / (G - 1) - 1 with x_l = xn * scale, which
    ``align_corners=True`` maps back to x_l."""
    from human_body_reconstruction_tpu_torch.ops.dense_grid import normalise
    from human_body_reconstruction_tpu_torch.utils.config import level_scales

    xn = normalise(x, mu, sigma)
    scales = np.float32(level_scales(cfg)[:cfg.dense_levels])
    return [(grid.detach().to(torch.float32).permute(3, 0, 1, 2)[None]
             .contiguous(),
             (2.0 * (xn * float(s)) / (grid.shape[0] - 1) - 1.0)
             .flip(-1).reshape(1, 1, 1, -1, 3))
            for grid, s in zip(grids, scales)]


def grid_sample_levels(inputs):
    """One ``F.grid_sample`` call a level (trilinear): (1, F, 1, 1, N)
    each."""
    return [torch.nn.functional.grid_sample(vol, u, mode="bilinear",
                                            align_corners=True)
            for vol, u in inputs]


def grid_sample_backward_levels(inputs, grad):
    """The volumes' gradients of ``grid_sample_levels`` given the (N, D*F)
    gradient of the features: one ``grid_sampler_3d_backward`` a level, from
    its (1, F, 1, 1, N) gradient (made before the call)."""
    f = inputs[0][0].shape[1]
    gos = [grad[:, l * f:(l + 1) * f].t().contiguous().reshape(1, f, 1, 1, -1)
           for l in range(len(inputs))]
    return lambda: [torch.ops.aten.grid_sampler_3d_backward(
        go, vol, u, 0, 0, True, [True, False])[0]
        for go, (vol, u) in zip(gos, inputs)]


def hash_rows_weights(pts, mu, sigma, h, bits=None, scales=None):
    """The hash kernels' rows and weights, for a library call handed them:
    (flat rows into the (L*T, F) table, (N*L, C) int64, weights (N*L, C)
    f32 or None), C the 2^dim corners of a (point, level) in exact mode or
    the one picked corner (``bits``, stochastic, weight 1); ``scales`` those
    of a level slice."""
    from human_body_reconstruction_tpu_torch.ops import hash_kernel
    from human_body_reconstruction_tpu_torch.ops.dense_grid import normalise

    per_level = hash_kernel._level_terms(normalise(pts, mu, sigma), h,
                                         bits=bits, scales=scales)
    rows = torch.stack([torch.stack([r for r, _ in terms], -1)
                        for terms, _ in per_level], 1)
    n, L, C = rows.shape
    if bits is not None:
        return rows.reshape(n * L, C), None
    w = torch.stack([torch.stack([wt for _, wt in terms], -1)
                     for terms, _ in per_level], 1)
    return rows.reshape(n * L, C), w.reshape(n * L, C)


def embedding_bag_call(table, rows, w):
    """The hash forward as one library call given the rows and weights:
    ``F.embedding_bag(mode="sum")`` over the flat (L*T, F) table, (N*L, F)
    out."""
    flat = table.reshape(-1, table.shape[-1])
    return lambda: torch.nn.functional.embedding_bag(
        rows, flat, per_sample_weights=w, mode="sum")


def cp_bag_inputs(lines, pts, mu, sigma, h):
    """The CP kernels' hat rows and weights, for a library call handed them:
    the f32 (3*sum_G, R) stacked lines (bf16-rounded values where
    ``h.dense_bf16``, as the kernels read them), and each (axis, point,
    level)'s two rows into them and their weights, (3*N*L, 2) int64 and f32
    in the order that makes a bag's (3*N*L, R) output a (3, N, L*R)
    tensor."""
    from human_body_reconstruction_tpu_torch.ops.dense_grid import (
        axis_coords, normalise, round_bf16)
    from human_body_reconstruction_tpu_torch.ops.lowrank import cp_line_sizes
    from human_body_reconstruction_tpu_torch.utils.config import fine_scales

    rnd = round_bf16 if h.dense_bf16 else (lambda v: v)
    sizes = cp_line_sizes(h)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    flat = rnd(torch.cat([ln.detach().to(torch.float32) for ln in lines],
                         dim=1)).reshape(-1, lines[0].shape[-1]).contiguous()
    axis = torch.arange(3, device=pts.device)[:, None] * int(offsets[-1])
    xn = normalise(pts, mu, sigma)
    rows, ws = [], []
    for g, scale, off in zip(sizes, fine_scales(h), offsets[:-1]):
        x0, frac = axis_coords(xn * float(scale), g)
        lo = x0.t() + axis + int(off)                                 # (3, N)
        rows.append(torch.stack([lo, lo + 1], -1))
        ws.append(torch.stack([rnd(1.0 - frac).t(), rnd(frac).t()], -1))
    return (flat, torch.stack(rows, 2).reshape(-1, 2),
            torch.stack(ws, 2).reshape(-1, 2).contiguous())


def cp_embedding_bag_call(flat, rows, w):
    """The CP forward's gathers and lerps as one library call given the
    rows and weights: ``F.embedding_bag(mode="sum")``, one bag of 2 a
    (point, level, axis), over the f32 stacked lines; (3*N*L, R) out, whose
    product over the axes is the encoding."""
    return lambda: torch.nn.functional.embedding_bag(
        rows, flat, per_sample_weights=w, mode="sum")


def cp_index_add_call(flat, rows, w, cols, h):
    """The CP backward as one library call given the rows and the terms
    (each hat row's weight times its axis's bf16-rounded dT, made before
    the call from the f32 lerps): ``index_add_`` into an f32 (3*sum_G, R)
    accumulator.  Returns (the call, the accumulator)."""
    from human_body_reconstruction_tpu_torch.ops.dense_grid import round_bf16

    rnd = round_bf16 if h.dense_bf16 else (lambda v: v)
    R = flat.shape[1]
    n = cols.shape[0]
    t = cp_embedding_bag_call(flat, rows, w)().reshape(3, n, -1, R)
    gl = cols.reshape(n, -1, R)
    dp = gl * t[2]
    dts = torch.stack([rnd(dp * t[1]), rnd(t[0] * dp), rnd((t[0] * t[1]) * gl)])
    terms = (w.reshape(3, n, -1, 2, 1) * dts[:, :, :, None, :]).reshape(-1, R)
    del t, gl, dp, dts
    idx = rows.reshape(-1)
    acc = torch.zeros_like(flat)
    return (lambda: acc.zero_().index_add_(0, idx, terms)), acc


def corner_sectors(rows) -> int:
    """The distinct 32-byte sectors (8 words) that the corner rows of each
    (point, level) span, summed: rows (N*L, C) into the flat (L*T,) words,
    as ``hash_rows_weights`` gives them."""
    sec = (rows >> 3).sort(dim=1).values
    return int(sec.shape[0] + (sec[:, 1:] != sec[:, :-1]).sum())


def l2_read_rate(device) -> float:
    """Bytes a second that ``torch.sum`` reads from an L2-resident buffer of
    L2_BUFFER_BYTES, read 20 times in one call (the rows of a stride-0 view,
    each summed along its contiguous length)."""
    buf = torch.ones(L2_BUFFER_BYTES // 4, device=device)
    view = buf.expand(20, buf.numel())
    ms = time_ms(lambda: view.sum(dim=1), reps=20)
    return 20 * L2_BUFFER_BYTES / (ms * 1e-3)


def index_add_call(table, rows, w, g):
    """The hash backward as one library call given the rows and the terms
    (g, times the corner weights in exact mode, made before the call):
    ``index_add_`` into a flat (L*T, F) accumulator."""
    F = table.shape[-1]
    terms = g.reshape(rows.shape[0], 1, F).expand(-1, rows.shape[1], F)
    if w is not None:
        terms = terms * w[..., None]
    terms, idx = terms.reshape(-1, F).contiguous(), rows.reshape(-1)
    acc = torch.zeros((table.numel() // F, F), dtype=torch.float32,
                      device=table.device)
    return lambda: acc.index_add_(0, idx, terms)


def backward_ops(nm: str, tables, h, n: int):
    """Scalar operations of the backward kernel ``nm`` on n points."""
    return n * {"cp_backward": len(tables) * (h.cp_rank * 26 + 3 * 6),
                "dense_backward": h.dense_levels
                * (28 + 18 * h.features_per_level)}[nm]


def plain_backward(nm: str):
    """The plain PyTorch version of the backward kernel ``nm``."""
    from human_body_reconstruction_tpu_torch.ops import cp_kernel, dense_kernel

    return {"cp_backward": cp_kernel.cp_encode_plain_backward,
            "dense_backward": dense_kernel.dense_encode_plain_backward}[nm]


def backward_check(nm, tables, pts, scene, h, cols, label, tag):
    """The backward kernel ``nm`` against its plain version on ``pts`` with
    the cotangent ``cols`` (its columns of the encoder's (N, out_dim)
    gradient), within ``cuda_lib.sum_order_tolerance``; the dense one also
    timed against ``grid_sampler_3d_backward``.  Returns (max_abs_err, ms,
    plain_ms, library_ms, bound)."""
    from human_body_reconstruction_tpu_torch.ops import cuda_lib

    kern, plain = dict(wrappers(nm))[nm], plain_backward(nm)
    a = (tables, pts, scene["mu"], scene["sigma"], h, cols)
    bnd = bound(nbytes(pts, cols, *tables, *tables),
                backward_ops(nm, tables, h, pts.shape[0]))
    with torch.no_grad():
        got, want = kern(*a), plain(*a)
        abs_sum = plain([t.abs() for t in tables], *a[1:-1], cols.abs())
        torch.cuda.synchronize()
        err = max(float((x - y).abs().max()) for x, y in zip(got, want))
        ulps = max(float(((x - y).abs() / (cuda_lib.bf16_ulp(y)
                                           + 1e-6)).max())
                   for x, y in zip(got, want))
        ratio = max(float(((x - y).abs() / cuda_lib.sum_order_tolerance(
            y, s, True)).max()) for x, y, s in zip(got, want, abs_sum))
        check(all(x.shape == y.shape and bool(torch.isfinite(x).all())
                  for x, y in zip(got, want)),
              f"{nm} gradients finite, of the plain version's shapes")
        ms = time_ms(lambda: kern(*a))
        plain_ms = time_ms(lambda: plain(*a), reps=5)
        lib_ms, lib = None, ""
        if nm == "dense_backward":
            lib_ms = time_ms(grid_sample_backward_levels(
                grid_sample_inputs(tables, pts, scene["mu"], scene["sigma"],
                                   h), cols))
            lib = f", grid_sampler_3d_backward {lib_ms:.4f} ms"
        if nm == "cp_backward":
            flat, rows, w = cp_bag_inputs(tables, pts, scene["mu"],
                                          scene["sigma"], h)
            call, acc = cp_index_add_call(flat, rows, w, cols, h)
            call()
            from human_body_reconstruction_tpu_torch.ops.dense_grid import (
                round_bf16)

            rnd = round_bf16 if h.dense_bf16 else (lambda v: v)
            lib_ratio = max(float(((y - x).abs() / cuda_lib.sum_order_tolerance(
                y, s_, True)).max()) for x, y, s_ in zip(
                    rnd(acc).reshape(3, -1, acc.shape[1]).split(
                        [t.shape[1] for t in tables], 1), want, abs_sum))
            lib_ms = time_ms(call)
            lib = (f", index_add_ given rows and terms (f32) {lib_ms:.4f} ms "
                   f"(|err| / tolerance {lib_ratio:.3f})")
            check(lib_ratio <= 1.0, ("index_add_ computes the CP backward",
                                     label, lib_ratio))
            del flat, rows, w, call, acc
    print(f"kernel {nm}: {pts.shape[0]} {label}, max_abs_err {err:.3e}, worst "
          f"|err| / tolerance {ratio:.3f} (tol 1; / (bf16 ulp + 1e-6) "
          f"{ulps:.3f}), {ms:.4f} ms vs plain {plain_ms:.4f} ms{lib}, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}) {tag}")
    check(ratio <= 1.0, (nm, label, err, ratio))
    return err, ms, plain_ms, lib_ms, bnd


def backward_checks(trainer, device, tag, paths):
    """Each backward kernel against its plain version at both training
    shapes, from a seeded (N, 129) cotangent read through a row stride, on
    the path's own points (``paths``, from ``training_path_points``) and on
    uniform random points.  Returns {kernel name: {(phase, points kind):
    record}}, a record being (max_abs_err, ms, plain_ms, library_ms,
    bound)."""
    field, scene, h = trainer.state.field, trainer.scene, trainer.cfg.hash
    d = h.dense_levels * h.features_per_level
    gen = torch.Generator(device).manual_seed(SEED + 3)
    out = {"cp_backward": {}, "dense_backward": {}}
    for n, (phase, path_pts) in zip(TRAIN_POINTS, (("guided", paths["guided"]),
                                                   ("unculled",
                                                    paths["unculled"]))):
        check(path_pts.shape == (n, 3), ("path points", phase, path_pts.shape))
        xn = torch.rand((n, 3), generator=gen, device=device) * 1.5 - 0.25
        pts = scene["mu"] + xn * scene["sigma"]
        g = torch.randn((n, h.out_dim + 3), generator=gen, device=device)
        g = g[:, 3:]
        for nm, tables, cols in (("cp_backward", list(field.lines), g[:, d:]),
                                 ("dense_backward", list(field.dense),
                                  g[:, :d])):
            for kind, at in (("path", path_pts), ("random", pts)):
                out[nm][(phase, kind)] = backward_check(
                    nm, tables, at, scene, h, cols,
                    f"{kind} points ({phase})", tag)
    return out


def step_on_card_vs_cpu(trainer, ds, device):
    """One guided training step's loss and gradients from the same params,
    batch and sample positions: kernels on the card, plain on the CPU.
    (Placed on each device from the same draws, t differs by a few f32 ulps
    through the order of the CDF sums, and that alone moves the gradient by
    about 5e-3 of its norm.)"""
    from human_body_reconstruction_tpu_torch.ops import sampling
    from human_body_reconstruction_tpu_torch.train import step

    cfg, st, r = trainer.cfg, trainer.state, trainer.cfg.render
    gen = torch.Generator(device).manual_seed(SEED + 4)
    batch = step.sample_ray_batch(ds["images"], ds["c2ws"], ds["K"],
                                  cfg.train.ray_batch, gen)
    placement = sampling.occupancy_guided_ts(
        *batch[:2], st.occ, trainer.scene["mu"], trainer.scene["sigma"],
        r.near, r.far, r.compact_samples, num_probe=r.occ_probes,
        dt_mode=r.occ_dt, jitter=True, explore_frac=r.occ_explore,
        probe_jitter=r.occ_probe_jitter, stratified=r.occ_stratified,
        generator=gen)

    def loss_and_grads(field, dev):
        move = (lambda t: t.to(dev))
        field.zero_grad(set_to_none=True)
        loss, _ = step.loss_fn(
            field, {k: move(v) for k, v in trainer.scene.items()},
            [move(t) for t in batch], cfg,
            type(st.occ)(*(move(t) for t in st.occ)), torch.bfloat16,
            step=st.step, placement=[move(t) for t in placement])
        loss.backward()
        groups = {"dense": field.dense, "lines": field.lines,
                  "mlp": list(field.mlp.parameters())}
        grads = {k: torch.cat([p.grad.reshape(-1) for p in ps]).cpu()
                 for k, ps in groups.items()}
        field.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    card_loss, card = loss_and_grads(st.field, device)
    cpu = torch.device("cpu")
    cpu_loss, ref = loss_and_grads(copy.deepcopy(st.field).to(cpu), cpu)
    rel = {k: float(torch.linalg.vector_norm(card[k] - ref[k])
                    / torch.linalg.vector_norm(ref[k])) for k in ref}
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"step {st.step} card vs CPU ({cfg.train.ray_batch} rays x "
          f"{cfg.render.compact_samples} guided samples): loss "
          f"{card_loss:.7f} vs {cpu_loss:.7f} (rel {loss_rel:.2e}, tol "
          f"{STEP_LOSS_RTOL:g}); gradient rel norm "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (tol {STEP_GRAD_RTOL:g})")
    check(loss_rel <= STEP_LOSS_RTOL, ("step loss", card_loss, cpu_loss))
    check(all(v <= STEP_GRAD_RTOL for v in rel.values()), ("step grads", rel))


def profile_step(trainer, label, tag):
    """torch.profiler over one training step, forward and backward +
    optimizer profiled separately: device kernel time by kind and the
    device's idle share (1 - busy / wall, wall ending in a synchronise)."""
    from torch.profiler import ProfilerActivity, profile

    from human_body_reconstruction_tpu_torch.train import step

    cfg, st, ds = trainer.cfg, trainer.state, trainer.ds
    kinds = (("encoder fwd", ("cp_forward_kernel", "dense_forward_kernel",
                              "hash_forward_kernel")),
             ("encoder bwd", ("cp_backward_kernel", "dense_backward_kernel",
                              "hash_backward_kernel")),
             ("philox", ("uniform_bits_kernel",)),
             ("optimizer", ("multi_tensor", "adam")),
             ("gemm", ("gemm", "sm90_xmma", "cutlass", "ampere")))

    def kind(name):
        low = name.lower()
        return next((k for k, keys in kinds if any(s in low for s in keys)),
                    "other")

    def window(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans, by_kind = [], {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            by_kind[kind(e.name)] = by_kind.get(kind(e.name), 0.0) + (b - a)
        busy = _union(spans)[0]
        return res, wall * 1e3, busy / 1e3, {k: v / 1e3 for k, v in by_kind.items()}

    batch = step.sample_ray_batch(ds["images"], ds["c2ws"], ds["K"],
                                  cfg.train.ray_batch, trainer.generator)
    st.opt.zero_grad()
    (loss, _), wall_f, busy_f, fwd = window(lambda: step.loss_fn(
        st.field, trainer.scene, batch, cfg, st.occ, torch.bfloat16,
        step=st.step, generator=trainer.generator))
    _, wall_b, busy_b, bwd = window(
        lambda: (loss.backward(), st.opt.step(st.step)))
    st.step += 1
    if busy_f + busy_b == 0.0:
        print("profile: the profiler recorded no device time: not measured")
        return
    fmt = (lambda d: ", ".join(f"{k} {v:.3f}" for k, v in sorted(d.items())))
    print(f"profile {label} step {st.step}: forward wall {wall_f:.3f} ms, "
          f"device {busy_f:.3f} ms [{fmt(fwd)}]; backward+optimizer wall "
          f"{wall_b:.3f} ms, device {busy_b:.3f} ms [{fmt(bwd)}]; idle share "
          f"{1.0 - (busy_f + busy_b) / (wall_f + wall_b):.3f} {tag}")


def serve_trained(trainer, ds, run_dir, samples, tag):
    """Save the trained model, restore it through RenderServer, render a
    training view exact on a ``samples`` ladder and score it."""
    from human_body_reconstruction_tpu_torch.cli import serve
    from human_body_reconstruction_tpu_torch.data import png
    from human_body_reconstruction_tpu_torch.ops import mlp_kernel

    trainer.save()
    occ = trainer.state.occ
    args = serve.build_parser().parse_args(
        ["--ckpt_dir", run_dir, "--model_name", trainer.model_name,
         "--device", "cuda"] + (["--use_occ"] if occ is not None else []))
    server = serve.RenderServer(args)
    check(all(torch.equal(a, b) for a, b in zip(
        server.field.parameters(), trainer.state.field.parameters()))
          and (occ is None or torch.equal(server.occ.mask, occ.mask)),
          "restored params and grid equal the trained ones")
    pose, W = 1, ds["W"]
    cax = 2.0 * math.atan(W / (2.0 * float(ds["K"][0, 0])))
    req = {"c2w": ds["c2ws"][pose].tolist(), "height": ds["H"], "width": W,
           "camera_angle_x": cax, "num_samples": samples}
    mlp_kernel.launches = mlp_kernel.composed_calls = 0
    server.handle(req)                       # first use at this shape
    resp = server.handle(req)
    check(resp["ok"], resp)
    check(mlp_kernel.launches > 0 and mlp_kernel.composed_calls == 0,
          ("the served frames went through the MLP kernels",
           mlp_kernel.launches, mlp_kernel.composed_calls))
    img = png.decode_png(base64.b64decode(resp["image_b64"])) / 255.0
    gt = ds["images"][pose].cpu().numpy()
    psnr = 10.0 * math.log10(1.0 / max(float(np.mean((img - gt) ** 2)), 1e-12))
    print(f"served trained {trainer.model_name} model: view {pose} "
          f"{ds['H']}x{W} ladder {samples} in "
          f"{resp['wall_s']} s ({resp['rays_per_sec']} rays/s), PSNR "
          f"{psnr:.2f} dB against the ground truth; MLP kernel launches "
          f"{mlp_kernel.launches} {tag}")
    check(np.isfinite(img).all() and psnr > 12.0, ("served PSNR", psnr))


def entry(name, source, replaces, launches, err, ms, plain_ms, library_ms,
          bnd, shape=None) -> dict:
    """One kernel's record of the JSON line (``shape``: which points, for
    the kernels timed at more than one)."""
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
           "bound_by": bnd[1], "library_ms": library_ms}
    return rec if shape is None else {**rec, "shape": shape}


def train_hash_grid(run_dir: str, ds, device: torch.device, tag: str):
    """``train_hash --stochastic --hw_rng`` at full width through the port's
    CLI objects, on the dataset rendered for the flagship run.  Returns
    (trainer, launches during the timed run)."""
    from human_body_reconstruction_tpu_torch.cli import train_hash
    from human_body_reconstruction_tpu_torch.ops import mlp_kernel
    from human_body_reconstruction_tpu_torch.train.trainer import Trainer

    args = train_hash.build_parser().parse_args([
        "--synthetic", "--synthetic_subject", "textured", "--stochastic",
        "--hw_rng", "--device", "cuda", "--steps", str(HASH_STEPS),
        "--out_dir", run_dir, "--model_name", "hash"])
    cfg = train_hash.make_config(args)
    train_hash.check_supported(args, cfg)
    h, r = cfg.hash, cfg.render
    check((h.variant, h.num_levels, h.features_per_level, h.table_size,
           h.n_max, h.dense_levels, h.stochastic_train, h.hw_rng,
           r.num_samples, r.occupancy, cfg.train.ray_batch)
          == ("corner", 16, 2, 2 ** 16, 2048, 0, True, True, 64, False, 16000),
          "--stochastic --hw_rng resolves to the reference hash grid")
    trainer = Trainer(cfg=cfg, ds=ds, out_dir=run_dir, model_name="hash",
                      total_steps=HASH_STEPS, log_fn=print)
    warm = 5                         # first-use costs, and the first log
    trainer.run(warm, log_every=warm)
    kernels = wrappers("uniform_bits", "hash_forward", "hash_backward", "mlp",
                       "adam")
    for _, kern in kernels:
        kern.launches = 0
    mlp_kernel.composed_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run(HASH_STEPS - warm, log_every=29)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {nm: kern.launches for nm, kern in kernels}
    n = HASH_STEPS - warm
    hist = trainer.history
    print(f"hash train: {n} steps, {1e3 * sec / n:.2f} ms/step, "
          f"{n * cfg.train.ray_batch / sec:.1f} rays/s {tag}")
    print(f"hash train: PSNR {hist[0]['psnr']:.2f} dB (step "
          f"{hist[0]['step']}) -> {hist[-1]['psnr']:.2f} dB (step "
          f"{hist[-1]['step']})")
    print(f"launches while training the hash grid: {launches}")
    check(trainer.state.step == HASH_STEPS, "trained every step")
    check(all(math.isfinite(r["loss"]) for r in hist), "finite losses")
    check(hist[-1]["psnr"] >= hist[0]["psnr"] + 1.0, "hash train PSNR rose")
    check(all(v > 0 for v in launches.values()), launches)
    check(mlp_kernel.composed_calls == 0,
          ("every bf16 MLP3D call took the kernels", mlp_kernel.composed_calls))
    return trainer, launches


def hash_kernel_checks(trainer, device, tag, train_pts, serve_pts):
    """The Philox kernel bit for bit, and the hash forward and backward
    kernels against their plain versions on three point sets: the training
    path's (``hash_path_points``), as many uniform random points, and a
    served frame's chunk (exact forward only, the serving path's one
    kernel).  The forward and the stochastic corner bits bit for bit, the
    backward (stochastic from the kernel's bits) within the sum-order
    tolerance.  Returns {record name: (max_abs_err, ms, plain_ms, library_ms,
    bound)}: uniform_bits, and the hash kernels per point set in the path's
    mode (stochastic on training and random points, exact serving), the
    error over both modes."""
    from human_body_reconstruction_tpu_torch.ops import rng_kernel
    from human_body_reconstruction_tpu_torch.utils.config import fine_scales

    h, scene = trainer.cfg.hash, trainer.scene
    table = trainer.state.field.table.detach()
    L, F, n = h.num_hashed_levels, h.features_per_level, HASH_POINTS
    gen = torch.Generator(device).manual_seed(SEED + 5)
    xn = torch.rand((n, 3), generator=gen, device=device) * 1.5 - 0.25
    pts = scene["mu"] + xn * scene["sigma"]
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=device,
                         dtype=torch.int32)
    shape = (3, L, n)
    out = {}
    with torch.no_grad():
        bits = rng_kernel.uniform_bits(seed, shape)
        u = rng_kernel.uniform(seed, shape)
        same = (torch.equal(bits, rng_kernel.uniform_plain(seed, shape, False))
                and torch.equal(u, rng_kernel.uniform_plain(seed, shape)))
        m = u.numel()
        mean = float(u.double().mean())
        counts = torch.bincount((u * 256).long().reshape(-1),
                                minlength=256).double()
        chi2 = float(((counts - m / 256) ** 2 / (m / 256)).sum())
        ms = time_ms(lambda: rng_kernel.uniform(seed, shape))
        plain_ms = time_ms(lambda: rng_kernel.uniform_plain(seed, shape),
                           reps=5)
        lib_ms = time_ms(lambda: torch.rand(shape, device=device))
        del bits
    bnd = bound(nbytes(seed, u), m * PHILOX_OPS_PER_VALUE, INT32_OPS_PER_S)
    print(f"kernel uniform_bits: {m} values, bit for bit {same}, mean "
          f"{mean:.6f} (|mean - 0.5| bound {6 / math.sqrt(12 * m):.2e}), "
          f"chi2 {chi2:.1f} (256 bins, bound {255 + 6 * math.sqrt(510):.1f}), "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, torch.rand {lib_ms:.4f} "
          f"ms, bound {bnd[0]:.4f} ms ({bnd[1]}) {tag}")
    check(same, "Philox kernel equals its plain version bit for bit")
    check(abs(mean - 0.5) < 6 / math.sqrt(12 * m)
          and chi2 < 255 + 6 * math.sqrt(510), ("Philox mean, chi2", mean, chi2))
    out["uniform_bits"] = (0.0, ms, plain_ms, lib_ms, bnd)

    check(train_pts.shape == (n, 3), ("hash train path", train_pts.shape))
    visits = cells_per_point(train_pts, scene, fine_scales(h), HASH_RUN)
    print("hash train path: cells a point visits per level (runs of "
          f"{HASH_RUN}), levels 0-{L - 1}: "
          + " ".join(f"{v:.3f}" for v in visits)
          + f"; mean {sum(visits) / L:.3f}")
    g = torch.randn((n, L * F + 3), generator=gen, device=device)[:, 3:]
    for kind, at in (("train_path", train_pts), ("random", pts),
                     ("serving_path", serve_pts)):
        errs, rec = [], {}
        for mode in (("exact",) if kind == "serving_path"
                     else ("exact", "stochastic")):
            fwd, bwd = hash_mode_check(
                table, at, scene, h, g, u if mode == "stochastic" else None,
                kind, tag, backward=kind != "serving_path")
            errs.append(fwd[0])
            rec["hash_forward"] = (max(errs), *fwd[1:])
            if bwd is not None:
                prev = rec.get("hash_backward", (0.0,))[0]
                rec["hash_backward"] = (max(prev, bwd[0]), *bwd[1:])
        for nm, r in rec.items():
            out[f"{nm}/{kind}"] = r
    return out


def hash_mode_check(table, at, scene, h, g, u, kind: str, tag: str,
                    backward: bool = True, scales=None):
    """The hash forward kernel against its plain version on the points
    ``at`` (stochastic with the uniforms ``u``, else exact): features and
    the stochastic corner bits bit for bit, beside ``embedding_bag`` given
    the rows and weights; with ``backward`` the backward kernel (from the
    kernel's bits) against its plain version with the cotangent ``g``,
    within the sum-order tolerance, beside ``index_add_`` given the rows and
    terms.  ``scales`` (a level slice's, with ``h`` of as many levels) runs
    the kernels on a level shard's table.  Returns (forward record,
    backward record or None), a record being (max_abs_err, ms, plain_ms,
    library_ms, bound)."""
    from human_body_reconstruction_tpu_torch.ops import cuda_lib, hash_kernel

    stoch = u is not None
    mode = "stochastic" if stoch else "exact"
    L, F = h.num_hashed_levels, h.features_per_level
    a = (table, at, scene["mu"], scene["sigma"], h)
    xa = (at - scene["mu"]) / scene["sigma"]
    outside = float(((xa < 0) | (xa > 1)).any(-1).float().mean())
    ops_f = forward_ops("hash_forward", table, h, at.shape[0], stoch)
    sc = {"scales": scales}
    with torch.no_grad():
        got = hash_kernel.hash_encode_kernel(*a, u=u, **sc)
        want = hash_kernel.hash_encode_plain(*a, u=u, **sc)
        torch.cuda.synchronize()
        (feats, cb), (wf, wb) = ((got, want) if stoch
                                 else ((got, None), (want, None)))
        same = torch.equal(feats, wf) and (not stoch or torch.equal(cb, wb))
        err_f = float((feats - wf).abs().max())
        check(bool(torch.isfinite(feats).all()), "hash forward output finite")
        ms_f = time_ms(lambda: hash_kernel.hash_encode_kernel(*a, u=u, **sc))
        plain_f = time_ms(lambda: hash_kernel.hash_encode_plain(*a, u=u,
                                                                **sc),
                          reps=3)
        bnd_f = bound(nbytes(at, table, feats, *((u, cb) if stoch else ())),
                      ops_f)
        rows, w = hash_rows_weights(at, scene["mu"], scene["sigma"], h,
                                    cb if stoch else None, scales)
        lib = embedding_bag_call(table, rows, w)
        lib_err = float((lib().reshape(feats.shape) - wf).abs().max())
        lib_f = time_ms(lib)
    print(f"kernel hash_forward ({mode}): {at.shape[0]} {kind} points "
          f"({outside:.3f} outside the box), out {tuple(feats.shape)}"
          f"{', bits ' + str(tuple(cb.shape)) if stoch else ''}, bit "
          f"for bit {same} (max_abs_err {err_f:.3e}), {ms_f:.4f} ms vs "
          f"plain {plain_f:.4f} ms, embedding_bag given rows and "
          f"weights {lib_f:.4f} ms (max_abs_err {lib_err:.1e}), bound "
          f"{bnd_f[0]:.4f} ms ({bnd_f[1]}) {tag}")
    check(same, ("hash_forward bit for bit", kind, mode, err_f))
    check(lib_err <= 1e-5, ("embedding_bag computes the hash forward", kind,
                            mode, lib_err))
    fwd = (err_f, ms_f, plain_f, lib_f, bnd_f)
    if not backward:
        return fwd, None
    with torch.no_grad():
        gb = hash_kernel.hash_encode_backward_kernel(*a, g, bits=cb, **sc)
        want_b = hash_kernel.hash_encode_plain_backward(*a, g, bits=wb, **sc)
        abs_sum = hash_kernel.hash_encode_plain_backward(*a, g.abs(),
                                                         bits=wb, **sc)
        torch.cuda.synchronize()
        err_b = float((gb - want_b).abs().max())
        ratio = float(((gb - want_b).abs() / cuda_lib.sum_order_tolerance(
            want_b, abs_sum, False)).max())
        ms_b = time_ms(lambda: hash_kernel.hash_encode_backward_kernel(
            *a, g, bits=cb, **sc))
        plain_b = time_ms(lambda: hash_kernel.hash_encode_plain_backward(
            *a, g, bits=wb, **sc), reps=3)
        bnd_b = bound(nbytes(at, g, gb, *((cb,) if stoch else ())),
                      ops_f + at.shape[0] * L * F)
        lib = index_add_call(table, rows, w, g)
        lib_b = time_ms(lib, reps=5)
        del rows, w, lib
    print(f"kernel hash_backward ({mode}): {at.shape[0]} {kind} "
          f"points{', from the bits' if stoch else ''}, max_abs_err "
          f"{err_b:.3e}, worst |err| / tolerance {ratio:.3f} (tol 1), "
          f"{ms_b:.4f} ms vs plain {plain_b:.4f} ms, index_add_ given "
          f"rows and terms {lib_b:.4f} ms, bound {bnd_b[0]:.4f} ms "
          f"({bnd_b[1]}) {tag}")
    check(bool(torch.isfinite(gb).all()) and ratio <= 1.0,
          ("hash_backward", kind, mode, err_b, ratio))
    return fwd, (err_b, ms_b, plain_b, lib_b, bnd_b)


def hash_step_on_card_vs_cpu(trainer, ds, device):
    """One stochastic training step's loss and gradients from the same
    params, batch, ladder t and encoder uniforms: kernels on the card,
    plain versions on the CPU."""
    from human_body_reconstruction_tpu_torch.ops import hash_encoding, sampling
    from human_body_reconstruction_tpu_torch.train import step

    cfg, st, r = trainer.cfg, trainer.state, trainer.cfg.render
    gen = torch.Generator(device).manual_seed(SEED + 6)
    batch = step.sample_ray_batch(ds["images"], ds["c2ws"], ds["K"],
                                  cfg.train.ray_batch, gen)
    t = sampling.stratified_ts((cfg.train.ray_batch,), r.near, r.far,
                               r.num_samples, r.log_sampling, device,
                               jitter=True, per_ray_jitter=r.per_ray_jitter,
                               generator=gen)
    enc_u = hash_encoding.stoch_uniform(
        (3, cfg.hash.num_hashed_levels, t.numel()), cfg.hash, device, gen)

    def loss_and_grads(field, dev):
        move = (lambda v: v.to(dev))
        field.zero_grad(set_to_none=True)
        loss, _ = step.loss_fn(
            field, {k: move(v) for k, v in trainer.scene.items()},
            [move(v) for v in batch], cfg, None, torch.bfloat16,
            step=st.step, draws={"enc_u": move(enc_u)},
            placement=(move(t), None))
        loss.backward()
        grads = {"table": field.table.grad.reshape(-1).cpu(),
                 "mlp": torch.cat([p.grad.reshape(-1)
                                   for p in field.mlp.parameters()]).cpu()}
        field.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    card_loss, card = loss_and_grads(st.field, device)
    cpu = torch.device("cpu")
    cpu_loss, ref = loss_and_grads(copy.deepcopy(st.field).to(cpu), cpu)
    rel = {k: float(torch.linalg.vector_norm(card[k] - ref[k])
                    / torch.linalg.vector_norm(ref[k])) for k in ref}
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"hash step {st.step} card vs CPU ({cfg.train.ray_batch} rays x "
          f"{r.num_samples} samples, stochastic corners): loss "
          f"{card_loss:.7f} vs {cpu_loss:.7f} (rel {loss_rel:.2e}, tol "
          f"{STEP_LOSS_RTOL:g}); gradient rel norm "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (tol {STEP_GRAD_RTOL:g})")
    check(loss_rel <= STEP_LOSS_RTOL, ("hash step loss", card_loss, cpu_loss))
    check(all(v <= STEP_GRAD_RTOL for v in rel.values()),
          ("hash step grads", rel))


def forward_ops(nm: str, tables, h, n: int, stochastic: bool = False):
    """Scalar operations of the forward kernel ``nm`` on n points (the CP
    forward over its len(tables) levels)."""
    F = h.features_per_level
    per_point = {"cp_forward": len(tables) * (h.cp_rank * 11 + 3 * 6),
                 "dense_forward": h.dense_levels * (28 + 17 * F),
                 "hash_forward": h.num_hashed_levels * (
                     15 + (11 if stochastic else 8 * (10 + 2 * F)))}[nm]
    return n * per_point


def written_bytes(out) -> int:
    """Bytes a kernel must write for the 2-D output view ``out``: its own
    when contiguous; the whole 32-byte sectors each row covers when it is a
    column slice of a wider matrix (the DRAM's least unit of a write)."""
    if out.is_contiguous():
        return nbytes(out)
    size = out.element_size()
    first = (out.data_ptr()
             + torch.arange(out.shape[0], dtype=torch.int64)
             * out.stride(0) * size)
    last = first + out.shape[1] * size - 1
    return int(((last // 32) - (first // 32) + 1).sum()) * 32


def plain_forward(nm: str):
    """The plain PyTorch version of the forward kernel ``nm``."""
    from human_body_reconstruction_tpu_torch.ops import (
        cp_kernel, dense_kernel, hash_kernel)

    return {"cp_forward": cp_kernel.cp_encode_plain,
            "dense_forward": dense_kernel.dense_encode_plain,
            "hash_forward": hash_kernel.hash_encode_plain}[nm]


def encoder_parts(field):
    """(forward kernel's name, tables) of the field's encoders in the
    columns' order of the encoder's (N, out_dim) matrix: dense, then the CP
    lines or the hash table."""
    parts = []
    if len(field.dense):
        parts.append(("dense_forward", list(field.dense)))
    if len(field.lines):
        parts.append(("cp_forward", list(field.lines)))
    if field.table is not None:
        parts.append(("hash_forward", field.table.detach()))
    return parts


def forward_check(nm, tables, pts, scene, h, *, matrix: bool, tol: float,
                  label: str, tag: str, plain_reps: int = 20):
    """The forward kernel ``nm`` against its plain version on ``pts``.
    With ``matrix`` the kernel writes its columns of a NaN-filled (N,
    out_dim) matrix, as the encoder hands them to it on every path (dense
    first, then the CP or hash columns), and the other columns must stay
    NaN; without, it writes a contiguous output.  The bound counts the
    output as that layout writes it.  Returns (max_abs_err, ms, plain_ms,
    library_ms, bound)."""
    kern, plain = dict(wrappers(nm))[nm], plain_forward(nm)
    a = (tables, pts, scene["mu"], scene["sigma"], h)
    n = pts.shape[0]
    d = h.dense_levels * h.features_per_level
    xa = (pts - scene["mu"]) / scene["sigma"]
    outside = float(((xa < 0) | (xa > 1)).any(-1).float().mean())
    kw, where = {}, "contiguous"
    if matrix:
        mat = torch.full((n, h.out_dim), float("nan"), device=pts.device)
        cols = slice(0, d) if nm == "dense_forward" else slice(d, h.out_dim)
        kw = {"out": mat[:, cols]}
        where = (f"into columns {cols.start}:{cols.stop} of the (N, "
                 f"{h.out_dim}) matrix")
    extra = ""
    with torch.no_grad():
        got, want = kern(*a, **kw), plain(*a)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        same = torch.equal(got, want)
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
              f"{nm} output finite, of the plain version's shape")
        if matrix:
            rest = torch.ones(h.out_dim, dtype=torch.bool)
            rest[cols] = False
            check(bool(mat[:, rest.to(mat.device)].isnan().all()),
                  (nm, "the matrix's other columns untouched"))
        ms = time_ms(lambda: kern(*a, **kw))
        plain_ms = time_ms(lambda: plain(*a), reps=plain_reps)
        lib_ms = None
        if nm == "dense_forward":
            lib_ms = time_ms(lambda gs=grid_sample_inputs(*a): (
                grid_sample_levels(gs)))
            extra += f", grid_sample {lib_ms:.4f} ms"
        if nm == "hash_forward":
            rows, w = hash_rows_weights(pts, scene["mu"], scene["sigma"], h)
            lib_ms = time_ms(embedding_bag_call(tables, rows, w))
            extra += f", embedding_bag given rows and weights {lib_ms:.4f} ms"
            del rows, w
        if nm == "cp_forward":
            flat, rows, w = cp_bag_inputs(tables, pts, scene["mu"],
                                          scene["sigma"], h)
            lib = cp_embedding_bag_call(flat, rows, w)
            lib_err = float((lib().reshape(3, n, -1).prod(0) - want).abs()
                            .max()) / max(1.0, float(want.abs().max()))
            lib_ms = time_ms(lib)
            extra += (f", embedding_bag given rows and weights (f32 lines) "
                      f"{lib_ms:.4f} ms (its product's max_abs_err "
                      f"{lib_err:.3e} of max(1, |plain|))")
            check(lib_err <= 1e-5, ("embedding_bag computes the CP forward",
                                    label, lib_err))
            del flat, rows, w, lib
        if matrix and not kw["out"].is_contiguous():
            extra += f", contiguous {time_ms(lambda: kern(*a)):.4f} ms"
    bnd = bound(nbytes(pts, *(tables if isinstance(tables, list)
                              else [tables])) + written_bytes(got),
                forward_ops(nm, tables, h, n))
    print(f"kernel {nm}: {n} {label} ({outside:.3f} outside the box) "
          f"{where}, bit for bit {same} (max_abs_err {err:.3e}, tol "
          f"{tol:g}), {ms:.4f} ms vs plain {plain_ms:.4f} ms{extra}, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}) {tag}")
    check(err <= tol, (nm, label, err))
    return err, ms, plain_ms, lib_ms, bnd


def counted(kernels, fn):
    """fn() with every kernel's launch count set to 0 just before it; returns
    (fn's result, launches of each kernel during it)."""
    for _, kern in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, {nm: kern.launches for nm, kern in kernels}


def quality_phase(work: str, device: torch.device, tag: str,
                  scene: str = "textured"):
    """The 4-pose holdout protocol through its CLI, cut to QUALITY_STEPS
    steps at the 6000-step horizon: the default mode on the textured scene
    (its holdout above QUALITY_FLOOR_DB), or the record's mode on the
    held-back tangle (scene seed TANGLE_SEED), whose field must compute on
    the card."""
    from human_body_reconstruction_tpu_torch.cli import quality_holdout
    from human_body_reconstruction_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    argv = ["--scene", scene, "--steps", str(QUALITY_STEPS), "--device",
            str(device), "--out", f"{work}/quality_{scene}.json"]
    tangle = scene == "tangle"
    if tangle:
        argv += ["--scene_seed", str(TANGLE_SEED), "--mode", TANGLE_MODE]
    devices, field = set(), synthetic.tangle_field

    def tangle_field(pts, **kw):
        devices.add(pts.device.type)
        return field(pts, **kw)

    synthetic.tangle_field = tangle_field
    try:
        row, launches = counted(wrappers(*TRAIN_KERNELS),
                                lambda: quality_holdout.main(argv))
    finally:
        synthetic.tangle_field = field
    wall = time.perf_counter() - t0
    floor = None if tangle else QUALITY_FLOOR_DB
    print(f"quality protocol ({row['mode']}, {row['scene']}"
          f"{f' seed {TANGLE_SEED}' if tangle else ''}, horizon 6000): "
          f"{row['steps']} steps, {1e3 * 16384 / row['rays_per_sec']:.2f} "
          f"ms/step and {row['rays_per_sec']} rays/s on the protocol's clock "
          f"({row['budget_s']} s), occ_frac {row['occ_frac']} (by refresh "
          f"{row['occ_trace']}), train PSNR "
          f"{row['train_psnr']} dB; holdout "
          + ", ".join(f"{k} {v}" for k, v in row["holdout_per_pose"].items())
          + f" dB, mean {row['holdout_psnr']}, min {row['holdout_min']} "
          f"(floor {floor}); {wall:.1f} s with the ground truth {tag}")
    print(f"launches in the quality protocol ({scene}): {launches}")
    vals = [row[k] for k in JAX_ROW_KEYS if k not in ("mode", "scene",
                                                     "holdout_per_pose")]
    check(all(k in row for k in JAX_ROW_KEYS)
          and all(math.isfinite(v) for v in vals + list(
              row["holdout_per_pose"].values())), ("quality row", row))
    check(row["steps"] == QUALITY_STEPS, ("quality steps", row["steps"]))
    check(0.0 < row["occ_frac"] < 1.0, ("occ_frac", row["occ_frac"]))
    check(floor is None or row["holdout_psnr"] > floor,
          ("holdout mean", row["holdout_psnr"]))
    check(all(n > 0 for n in launches.values()), launches)
    if tangle:
        print(f"tangle field computed on: {sorted(devices)}")
        check(row["scene"] == "tangle" and row["scene_seed"] == TANGLE_SEED,
              ("tangle row", row["scene"], row.get("scene_seed")))
        check(devices == {"cuda"}, ("the tangle field on the card", devices))


def render_phase(train_dir: str, work: str, device: torch.device, tag: str):
    """cli/render.py over the trained flagship run: four orbit frames,
    guided by the saved grid; frame 0 against render_image."""
    from human_body_reconstruction_tpu_torch.cli import render
    from human_body_reconstruction_tpu_torch.data import png
    from human_body_reconstruction_tpu_torch.pipeline import restore
    from human_body_reconstruction_tpu_torch.train import step

    argv = ["--ckpt_dir", train_dir, "--model_name", "flagship", "--orbit",
            "4", "--use_occ", "--eval_guided", "64", "--out_dir",
            f"{work}/renders", "--device", str(device)]
    summary, launches = counted(wrappers("cp_forward", "dense_forward"),
                                lambda: render.main(argv))
    n = summary["num_views"]
    print(f"render CLI: {n} x {summary['H']}x{summary['W']}, eval_guided "
          f"{summary['eval_guided']} of {summary['num_samples']} probes, "
          f"{summary['wall_s']} s ({summary['wall_s'] / n:.3f} s a frame), "
          f"{summary['rays_per_sec']} rays/s {tag}")
    print(f"launches in the render CLI: {launches}")
    frames = [png.read_png(v["path"]) for v in summary["views"]]
    check(n == 4 and all(f.shape == (summary["H"], summary["W"], 3)
                         for f in frames), "the render CLI's PNGs decode")
    args = render.build_parser().parse_args(argv)
    c2ws, K, H, W, _ = render.cameras_from_args(args)
    res = restore.restore(train_dir, "flagship", device=device,
                          with_occ=True, log_fn=lambda s: None)
    cfg = dataclasses.replace(res.cfg, render=dataclasses.replace(
        res.cfg.render, eval_guided=64))
    img = step.render_image(res.field, res.scene, H, W,
                            torch.as_tensor(K, device=device),
                            torch.as_tensor(c2ws[0], device=device), cfg,
                            occ=res.occ, num_samples=args.num_samples)
    want = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    same = np.array_equal(frames[0], want)
    print(f"render CLI frame 0 equals render_image bit for bit: {same}; "
          f"frames std {float(np.std(frames[0])):.2f}")
    check(same and np.std(frames[0]) > 1.0, "render CLI frame 0")
    check(all(n > 0 for n in launches.values()), launches)


def plain_sweep_grid(res, R: int) -> np.ndarray:
    """The sweep's (R, R, R, 4) grid as ``density_rgb_grid`` lays it out,
    every chunk through the plain encoders instead of the kernels."""
    from human_body_reconstruction_tpu_torch.pipeline import mesh_export

    field, scene, cfg = res.field, res.scene, res.cfg
    lo = scene["min_bound"]
    dirs = mesh_export.view_encoding(cfg, lo.device).expand(SWEEP_CHUNK, -1)
    rgb8, sig16 = [], []
    with torch.no_grad():
        for start in range(0, R ** 3, SWEEP_CHUNK):
            pts = mesh_export.sweep_points(start, R, SWEEP_CHUNK, lo,
                                           scene["max_bound"] - lo)
            feats = torch.cat([plain_forward(nm)(
                tables, pts, scene["mu"], scene["sigma"], cfg.hash)
                for nm, tables in encoder_parts(field)], -1)
            r, s = mesh_export.quantise(*field.mlp(feats, dirs,
                                                   torch.bfloat16))
            rgb8.append(r.cpu())
            sig16.append(s.cpu())
    rgb = torch.cat(rgb8)[:R ** 3].numpy().astype(np.float32) / 255.0
    sigma = torch.cat(sig16)[:R ** 3].numpy().astype(np.float32)
    return np.concatenate([rgb, sigma[:, None]], axis=-1).reshape(R, R, R, 4)


def mesh_phase(train_dir: str, hash_dir: str, work: str, device: torch.device,
               tag: str):
    """cli/nerf2mesh.py on both trained run directories; the sweep's grid
    and mesh against the same sweep through the plain encoders, and one
    chunk of each sweep through each forward kernel, into its columns of
    the encoder's matrix, against the plain version.  Returns {record name:
    (record, launches during the sweep, R)}."""
    from human_body_reconstruction_tpu_torch.cli import nerf2mesh
    from human_body_reconstruction_tpu_torch.pipeline import mesh_export, restore

    report = {}
    for model, run_dir in (("flagship", train_dir), ("hash", hash_dir)):
        R = MESH_RES[model]
        res = restore.restore(run_dir, model, device=device,
                              log_fn=lambda s: None)
        kerns = wrappers(*(nm for nm, _ in encoder_parts(res.field)))
        cache = f"{work}/{model}_grid.npy"
        argv = ["--ckpt_dir", run_dir, "--model_name", model, "--resolution",
                str(R), "--cache", cache, "--out", f"{work}/{model}.ply",
                "--device", str(device)]
        stats, launches = counted(kerns, lambda: nerf2mesh.main(
            argv + ["--iso", "30"]))
        sigma = np.load(cache, mmap_mode="r")[..., 3]
        q = np.percentile(sigma, [50, 99, 99.9, 100])
        # the smoke's models are trained 200 and 150 steps: their density
        # stays below the reference's iso 30 (max 19.8 and 5.5 in the
        # first card runs), so the mesh is also cut at half the sweep's
        # 99.9th percentile, from the cache the first export wrote
        level = round(0.5 * float(q[2]), 3)
        low, relaunch = counted(kerns, lambda: nerf2mesh.main(
            argv + ["--iso", str(level)]))
        lo, hi = (res.scene[k].cpu().numpy() for k in ("min_bound",
                                                        "max_bound"))
        chunks = R ** 3 // SWEEP_CHUNK
        t0 = time.perf_counter()         # the chunks alone: no host copies
        for start in range(0, R ** 3, SWEEP_CHUNK):
            mesh_export.sweep_chunk(res.field, res.scene, res.cfg, start, R,
                                    SWEEP_CHUNK)
        torch.cuda.synchronize()
        chunks_s = time.perf_counter() - t0
        print(f"mesh export {model} {R}^3: sweep {stats['sweep_seconds']:.3f}"
              f" s ({chunks} chunks; {chunks_s:.3f} s of them computing the "
              f"chunks, the rest copies and host arrays); sigma median "
              f"{q[0]:.3f}, 99% {q[1]:.3f}, 99.9% {q[2]:.3f}, max {q[3]:.3f}; "
              f"launches in the sweep: {launches}; from the cache: "
              f"{relaunch} {tag}")
        for iso, st in ((30.0, stats), (level, low)):
            v = st["verts"]
            inside = bool((v.min(0) >= lo - 1e-4).all()
                          and (v.max(0) <= hi + 1e-4).all()) if len(v) else None
            print(f"mesh export {model} {R}^3 iso {iso:g}: marching "
                  f"{st['marching_seconds']:.3f} s, {st['num_verts']} verts, "
                  f"{st['num_faces']} faces, inside the scene bounds "
                  f"{inside} {tag}")
            check(inside is not False, (model, iso, "mesh outside the bounds"))
        check(low["num_faces"] > 0, (model, "mesh", level, low["num_faces"]))
        check(all(n == chunks for n in launches.values())
              and not any(relaunch.values()),
              (model, "sweep launches", launches, relaunch, chunks))

        # the reference: the same sweep through the plain encoders, meshed
        # at the same level by the same extractor
        plain_cache = f"{work}/{model}_plain_grid.npy"
        grid = plain_sweep_grid(res, R)
        same_grid = np.array_equal(grid, np.load(cache))
        np.save(plain_cache, grid)
        ref = mesh_export.export_mesh(
            res.field, res.scene, res.cfg, resolution=R, iso=level,
            cache_path=plain_cache, out_path=f"{work}/{model}_plain.ply",
            verbose=False)
        same_mesh = all(np.array_equal(low[k], ref[k])
                        for k in ("verts", "faces", "colors"))
        print(f"mesh export {model} {R}^3: the sweep's rgb8 and sigma16 grid "
              f"equals the plain encoders' bit for bit: {same_grid}; its iso "
              f"{level:g} mesh equals theirs ({ref['num_verts']} verts, "
              f"{ref['num_faces']} faces): {same_mesh}")
        check(same_grid and same_mesh, (model, "sweep against plain"))

        start = (chunks // 2) * SWEEP_CHUNK
        pts = mesh_export.sweep_points(start, R, SWEEP_CHUNK, res.scene[
            "min_bound"], res.scene["max_bound"] - res.scene["min_bound"])
        for nm, tables in encoder_parts(res.field):
            rec = forward_check(
                nm, tables, pts, res.scene, res.cfg.hash, matrix=True,
                tol=0.0, label=f"lattice points of a sweep chunk from {start}"
                f" of {R}^3", tag=tag, plain_reps=5)
            report[f"{nm}/sweep_chunk"] = (rec, launches[nm], R)
        del res
    return report


def protocol_mode_phase(mode: str, work: str, device: torch.device,
                        tag: str):
    """``quality_holdout --mode mode --save_params`` on the textured scene,
    cut to MODE_STEPS[mode] steps.  Returns (row, launches of the encoder
    kernels during the run (the hash pair for the hash mode), the saved run
    restored with its grid)."""
    from human_body_reconstruction_tpu_torch.cli import quality_holdout
    from human_body_reconstruction_tpu_torch.pipeline import restore

    argv = ["--mode", mode, "--scene", "textured", "--steps",
            str(MODE_STEPS[mode]), "--device", str(device), "--out",
            f"{work}/{mode}.json", "--save_params"]
    kernels = (("hash_forward", "hash_backward") if mode == HASH_MODE
               else TRAIN_KERNELS)
    t0 = time.perf_counter()
    row, launches = counted(wrappers(*kernels),
                            lambda: quality_holdout.main(argv))
    sdf = ""
    if "var_b" in row:
        sdf = f", eikonal {row['eikonal']}, var_b {row['var_b']}"
    print(f"quality protocol ({mode}, {row['scene']}): {row['steps']} steps, "
          f"{1e3 * PROTOCOL_RAYS / row['rays_per_sec']:.2f} ms/step and "
          f"{row['rays_per_sec']} rays/s on the protocol's clock "
          f"({row['budget_s']} s), train PSNR {row['train_psnr']} dB{sdf}, "
          f"occ_frac {row.get('occ_frac')} (by refresh {row.get('occ_trace')})"
          "; holdout "
          + ", ".join(f"{k} {v}" for k, v in row["holdout_per_pose"].items())
          + f" dB, mean {row['holdout_psnr']}, min {row['holdout_min']}; "
          f"{time.perf_counter() - t0:.1f} s with the ground truth {tag}")
    print(f"launches in the {mode} run: {launches}")
    check(row["steps"] == MODE_STEPS[mode], (mode, "steps", row["steps"]))
    check(all(math.isfinite(v) for v in row["holdout_per_pose"].values())
          and row["holdout_psnr"] > 10.0, (mode, "holdout", row))
    check("var_b" not in row or (math.isfinite(row["eikonal"])
                                 and row["var_b"] != 0.5), (mode, row))
    check(all(n > 0 for n in launches.values()), launches)
    res = restore.restore(  # the second pass is the caller's choice
        f"{work}/{mode}", mode, device=device, with_occ=True,
        hierarchical=quality_holdout.make_modes()[mode].render.hierarchical,
        log_fn=lambda s: None)
    return row, launches, res


def serve_sdf_run(work: str, device: torch.device, tag: str):
    """The SDF protocol run served through ``cli/serve.py --use_sdf``: an
    SDF model restored, one 200x200 frame answered through the forward
    kernels, its PNG finite and not flat."""
    from human_body_reconstruction_tpu_torch.cli import serve
    from human_body_reconstruction_tpu_torch.data import png

    server = serve.RenderServer(serve.build_parser().parse_args([
        "--ckpt_dir", f"{work}/{SDF_MODE}", "--model_name", SDF_MODE,
        "--use_sdf", "--use_occ", "--height", "200", "--width", "200",
        "--device", str(device)]))
    check(server.base_cfg.render.use_sdf, "serve --use_sdf: an SDF model")
    resp, launches = counted(wrappers("cp_forward", "dense_forward"),
                             lambda: server.handle({"orbit": {"index": 1,
                                                              "count": 4}}))
    img = (png.decode_png(base64.b64decode(resp["image_b64"]))
           if resp.get("ok") else None)
    std = None if img is None else float(img.std())
    print(f"served the {SDF_MODE} run through serve --use_sdf: "
          f"{resp.get('wall_s')} s, launches {launches}, frame "
          f"{None if img is None else img.shape}, std {std} {tag}")
    check(img is not None and img.shape == (200, 200, 3) and std > 0.0
          and all(n > 0 for n in launches.values()),
          ("serve --use_sdf", resp.get("error"), launches))


def encoded_points(fn):
    """fn() with every point set that ``nerf.encode_points`` encodes
    recorded, in call order: (fn's result, [points])."""
    from human_body_reconstruction_tpu_torch.models import nerf

    seen, orig = [], nerf.encode_points

    def record(field, scene, pts, cfg, **kw):
        seen.append(pts.detach())
        return orig(field, scene, pts, cfg, **kw)

    nerf.encode_points = record
    try:
        return fn(), seen
    finally:
        nerf.encode_points = orig


def mode_batch(res, data, rays: int, gen):
    """A seeded ray batch of the protocol's training views and the draws of
    one step of the restored mode: its first pass's placement (guided with
    the grid, else the jittered ladder), the eikonal subsample's indices
    and the second pass's quantiles."""
    from human_body_reconstruction_tpu_torch.ops import sampling
    from human_body_reconstruction_tpu_torch.train import step

    cfg, r, scene = res.cfg, res.cfg.render, res.scene
    batch = step.sample_ray_batch(data["train_imgs"], data["train_poses"],
                                  data["K"], rays, gen)
    o, d = batch[:2]
    if r.occ_guided and res.occ is not None:
        placement = sampling.occupancy_guided_ts(
            o, d, res.occ, scene["mu"], scene["sigma"], r.near, r.far,
            r.compact_samples, num_probe=r.occ_probes, dt_mode=r.occ_dt,
            jitter=True, explore_frac=r.occ_explore,
            probe_jitter=r.occ_probe_jitter, stratified=r.occ_stratified,
            generator=gen)
    else:
        placement = (sampling.stratified_ts(
            (rays,), r.near, r.far, r.num_samples, r.log_sampling, o.device,
            jitter=True, per_ray_jitter=r.per_ray_jitter, generator=gen), None)
    draws = {}
    if r.use_sdf:
        n = placement[0].numel()
        draws["eik_idx"] = torch.randint(0, n, (cfg.train.eikonal_subsample,),
                                         generator=gen, device=o.device)
    if r.hierarchical:
        draws["fine_u"] = torch.rand((rays, r.num_fine_samples or
                                      r.num_samples), generator=gen,
                                     device=o.device) * (1.0 - 1e-6)
    return batch, placement, draws


def mode_step_on_card_vs_cpu(mode, res, data, device, rays: int, tag):
    """One training step of the restored mode, loss and every group's
    gradient (the SDF sharpness's included), from the same params, batch,
    placement and draws: kernels on the card, plain versions on the CPU.
    In the mode's numerics (the encoders' bf16 roundings, the MLP in bf16
    compute) and, in SDF mode, also all in f32, which alone is held to
    STEP_GRAD_RTOL there: the eikonal term's gradient is the difference of
    two densities' gradients 1e-3 apart, which cancel to about 1e-3 of
    their size, and each point's cotangent is rounded to bf16 in the
    encoder's backward, so a rounding that the devices' f32 differences
    flip moves it by a few 1e-2 of its norm (an H100 80GB HBM3: dense 4.1e-2
    and 3.2e-2, lines 2.2e-2 and 1.5e-2; reordering the same terms on the
    CPU moves it by 9e-7).  Returns the point sets the card's step in the
    mode's numerics encoded."""
    from human_body_reconstruction_tpu_torch.train import step

    gen = torch.Generator(device).manual_seed(SEED + 9)
    batch, placement, draws = mode_batch(res, data, rays, gen)

    def loss_and_grads(field, dev, cfg, dtype):
        move = (lambda t: None if t is None else t.to(dev))
        field.zero_grad(set_to_none=True)
        loss, aux = step.loss_fn(
            field, {k: move(v) for k, v in res.scene.items()},
            [move(t) for t in batch], cfg,
            None if res.occ is None else type(res.occ)(*map(move, res.occ)),
            dtype, step=MODE_STEPS[mode],
            draws={k: move(v) for k, v in draws.items()},
            placement=[move(t) for t in placement])
        loss.backward()
        groups = {"dense": field.dense, "lines": field.lines,
                  "mlp": list(field.mlp.parameters())}
        if field.var_b is not None:
            groups["var"] = [field.var_b]
        grads = {k: torch.cat([p.grad.reshape(-1) for p in ps]).cpu()
                 for k, ps in groups.items()}
        field.zero_grad(set_to_none=True)
        eik = aux.get("eikonal")
        return (float(loss.detach()),
                None if eik is None else float(eik.detach()), grads)

    sdf = res.cfg.render.use_sdf
    numerics = [("the mode's", res.cfg, torch.bfloat16, not sdf)]
    if sdf:
        numerics.append(("f32", dataclasses.replace(
            res.cfg, hash=dataclasses.replace(res.cfg.hash,
                                              dense_bf16=False)), None, True))
    field_cpu = copy.deepcopy(res.field).to(torch.device("cpu"))
    pts = None
    for name, cfg, dtype, held in numerics:
        (card_loss, card_eik, card), seen = encoded_points(
            lambda: loss_and_grads(res.field, device, cfg, dtype))
        pts = pts or seen
        cpu_loss, cpu_eik, ref = loss_and_grads(
            field_cpu, torch.device("cpu"), cfg, dtype)
        rel = {k: float(torch.linalg.vector_norm(card[k] - ref[k])
                        / torch.linalg.vector_norm(ref[k])) for k in ref}
        loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
        print(f"{mode} step card vs CPU, {name} numerics ({rays} rays, "
              f"points encoded {[p.shape[0] for p in seen]}): loss "
              f"{card_loss:.7f} vs {cpu_loss:.7f} (rel {loss_rel:.2e}, tol "
              f"{STEP_LOSS_RTOL:g}), eikonal {card_eik} vs {cpu_eik}; "
              "gradient rel norm "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
              + (f" (tol {STEP_GRAD_RTOL:g})" if held else " (not held)")
              + f" {tag}")
        check(loss_rel <= STEP_LOSS_RTOL, (mode, "step loss", card_loss,
                                           cpu_loss))
        check(not held or all(v <= STEP_GRAD_RTOL for v in rel.values()),
              (mode, name, "step gradients", rel))
    return pts


def encoder_kernel_checks(res, pts, label, tag, contiguous: bool = False):
    """Each encoder kernel of the restored model against its plain version
    on ``pts``: the forwards into their columns of the encoder's matrix
    (with ``contiguous`` the CP forward also into its own output), bit for
    bit; the backwards from a seeded cotangent, within the sum-order
    tolerance.  Returns {kernel name (``cp_forward_contiguous`` for the
    contiguous output): record}."""
    h, scene, field = res.cfg.hash, res.scene, res.field
    d = h.dense_levels * h.features_per_level
    gen = torch.Generator(pts.device).manual_seed(SEED + 10)
    g = torch.randn((pts.shape[0], h.out_dim + 3), generator=gen,
                    device=pts.device)[:, 3:]
    out = {}
    for nm, tables in encoder_parts(field):
        tables = [t.detach() for t in tables]
        out[nm] = forward_check(nm, tables, pts, scene, h, matrix=True,
                                tol=0.0, label=label, tag=tag, plain_reps=3)
        if contiguous and nm == "cp_forward":
            out[f"{nm}_contiguous"] = forward_check(
                nm, tables, pts, scene, h, matrix=False, tol=0.0,
                label=label, tag=tag, plain_reps=3)
        bw = nm.replace("forward", "backward")
        out[bw] = backward_check(bw, tables, pts, scene, h,
                                 g[:, :d] if bw == "dense_backward"
                                 else g[:, d:], label, tag)
    return out


def wide_mode_phase(mode: str, data, work: str, device: torch.device,
                    tag: str):
    """A few steps of a wide mode through the protocol, then each encoder
    kernel of the trained model against its plain version on the ladder
    points of one seeded full batch (PROTOCOL_RAYS rays x 128 samples, the
    path of those steps): the CP pair at rank 64 (C 384) or on the 12-level
    ladder (9 CP levels, C 288, and D = 3 dense levels), or the corner hash
    grid exact.  Returns (records by kernel name, launches in the run, the
    points, their label)."""
    _, launches, res = protocol_mode_phase(mode, work, device, tag)
    pts = pass_points(res, data, device, 0)
    h = res.cfg.hash
    check(pts.shape[0] == PROTOCOL_RAYS * 128, (mode, pts.shape))
    if mode == HASH_MODE:
        label = (f"ladder points of a {PROTOCOL_RAYS}-ray batch, {mode} "
                 f"(L {h.num_hashed_levels}, F {h.features_per_level}, T "
                 f"2^{h.log2_table_size})")
        gen = torch.Generator(device).manual_seed(SEED + 12)
        g = torch.randn((pts.shape[0], h.out_dim + 3), generator=gen,
                        device=device)[:, 3:]
        fwd, bwd = hash_mode_check(res.field.table.detach(), pts, res.scene,
                                   h, g, None, f"{mode} path", tag)
        recs = {"hash_forward": fwd, "hash_backward": bwd}
    else:
        label = (f"ladder points of a {PROTOCOL_RAYS}-ray batch, {mode} "
                 f"({h.num_levels - h.dense_levels} CP levels of rank "
                 f"{h.cp_rank}, C {(h.num_levels - h.dense_levels) * h.cp_rank}"
                 f", {h.dense_levels} dense levels)")
        recs = encoder_kernel_checks(res, pts, label, tag, contiguous=True)
    del res
    torch.cuda.empty_cache()
    return recs, launches, pts.shape[0], label


def speedrun_phase(work: str, device: torch.device, tag: str):
    """``cli/speedrun.py`` with the record's gating, capped at the first
    guided gate: the JAX record's keys, every gate render finite, the last
    one guided, the encoder kernels launched."""
    from human_body_reconstruction_tpu_torch.cli import speedrun

    t0 = time.perf_counter()
    argv = [*SPEEDRUN_ARGS, "--device", str(device), "--out",
            f"{work}/speedrun.json"]
    res, launches = counted(wrappers(*TRAIN_KERNELS),
                            lambda: speedrun.main(argv, log=lambda s: None))
    print(f"speedrun ({' '.join(SPEEDRUN_ARGS)}): {res['steps']} steps, "
          "gates " + ", ".join(
              f"step {e['steps']} {e['gate']} {e['gate_db']} dB (train "
              f"{e['train_db']}, exact {e['exact_db']}, wall {e['wall_s']} s)"
              for e in res["evals"])
          + f"; crossed {json.dumps(res['crossed'])}; "
          f"{time.perf_counter() - t0:.1f} s with the ground truth {tag}")
    print(f"launches in the speedrun: {launches}")
    check({"target_db", "crossed", "protocol"} <= set(res), sorted(res))
    check(res["evals"] and all(math.isfinite(e["gate_db"])
                               for e in res["evals"]), res["evals"])
    check(res["crossed"] is not None
          or res["evals"][-1]["gate"] == "guided48", res["evals"])
    check(all(n > 0 for n in launches.values()), launches)
    return res


def pass_points(res, data, device, which: int):
    """The points of pass ``which`` of one seeded full batch (PROTOCOL_RAYS
    rays; 0: the first pass, 1: a hierarchical mode's second pass of 64 +
    64 samples), ray-major as ``render_rays`` encodes them."""
    from human_body_reconstruction_tpu_torch.models import nerf

    gen = torch.Generator(device).manual_seed(SEED + 11)
    batch, placement, draws = mode_batch(res, data, PROTOCOL_RAYS, gen)
    with torch.no_grad():
        _, pts = encoded_points(lambda: nerf.render_rays(
            res.field, res.scene, *batch[:3], res.cfg, occ=res.occ,
            compute_dtype=torch.bfloat16, jitter=True, generator=gen,
            draws=draws, placement=placement))
    return pts[which]


def continuation_phase(data, device, tag):
    """The SDF mode's Trainer, full width on the protocol's views with the
    warmup cut to CONT_WARMUP: k steps, ``save``, a fresh Trainer,
    ``load`` (the loaded state equal to the saved one bit for bit), m more
    steps, against k + m steps in one run."""
    from human_body_reconstruction_tpu_torch.cli import quality_holdout
    from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
    from human_body_reconstruction_tpu_torch.train.trainer import Trainer

    cfg = quality_holdout.make_modes()[SDF_MODE]
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ray_batch=PROTOCOL_RAYS, occ_warmup_steps=CONT_WARMUP))
    ds = {"images": data["train_imgs"], "c2ws": data["train_poses"],
          "K": data["K"], "H": data["train_imgs"].shape[1],
          "W": data["train_imgs"].shape[2]}
    k, m = CONT_STEPS

    def trainer(out_dir):
        return Trainer(cfg=cfg, ds=ds, out_dir=out_dir, model_name="c",
                       total_steps=k + m, log_fn=lambda s: None)

    def state_of(tr):
        st = tr.state
        return ([torch.as_tensor(a) for a in ckpt.jax_leaves(st.field)
                 + ckpt.opt_leaves(st.field, st.opt, st.step)]
                + list(st.occ) + [tr.generator.get_state()], st.step)

    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        t0 = time.perf_counter()
        wholes = []
        for _ in range(2):               # the spread of two repeated runs
            wholes.append(trainer(a))
            wholes[-1].run(k + m, log_every=1)
        first = trainer(b)
        first.run(k, log_every=1)
        first.save()
        saved = state_of(first)
        rest = trainer(b)
        rest.load()
        loaded = state_of(rest)
        same = loaded[1] == saved[1] == k and len(loaded[0]) == len(
            saved[0]) and all(torch.equal(x.cpu(), y.cpu())
                              for x, y in zip(loaded[0], saved[0]))
        rest.run(m, log_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def worst(xs, ys):
        return max(abs(x - y) / abs(y) for x, y in zip(xs, ys))

    got = [r["loss"] for r in first.history + rest.history]
    want, again = ([r["loss"] for r in w.history] for w in wholes)
    print(f"continuation ({SDF_MODE}, warmup {CONT_WARMUP}): {k} steps, save, "
          f"load into a fresh Trainer (params, moments, counts, step, grid "
          f"and generator equal bit for bit: {same}; grid installed before "
          f"the save: {first.state.occ is not None}), {m} more; per-step loss "
          f"against {k + m} steps in one run: worst rel {worst(got, want):.2e}"
          f" ({worst(got[:k], want[:k]):.2e} before the save; tol "
          f"{CONT_LOSS_RTOL:g}), a second run of {k + m} steps against the "
          f"first {worst(again, want):.2e}; last loss {got[-1]:.6f}, "
          f"{want[-1]:.6f} and {again[-1]:.6f}; {wall:.1f} s {tag}")
    check(same and first.state.occ is not None, "loaded state equals saved")
    check(len(got) == len(want) == k + m
          and worst(got, want) <= CONT_LOSS_RTOL,
          ("continued losses", worst(got, want)))


def read_ply_vertices(path: str) -> np.ndarray:
    """(V, 3) float32 vertex positions of a binary little-endian PLY whose
    vertices are x, y, z floats then r, g, b uchars."""
    with open(path, "rb") as f:
        head = b""
        while not head.endswith(b"end_header\n"):
            head += f.readline()
        n = int(head.split(b"element vertex ")[1].split()[0])
        dt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
        return np.frombuffer(f.read(n * dt.itemsize), dt)["xyz"].copy()


def mean_nearest(a, b, chunk: int = 4096) -> float:
    """Mean distance from each row of a to its nearest row of b (on the
    card)."""
    return float(torch.cat([torch.cdist(a[s:s + chunk], b).min(1).values
                            for s in range(0, a.shape[0], chunk)]).mean())


def tpu_weights_phase(data, work, device, tag):
    """The TPU's trained SDF weights (the committed quality-matrix params)
    in the port: the 4 holdout poses at 400x400, 128 exact samples, no
    occupancy, against the records and, on every 4th pixel, against the
    JAX package on the CPU; the xla weights meshed at 192^3, iso auto,
    against the TPU's mesh."""
    from human_body_reconstruction_tpu_torch.cli import psnr, quality_holdout
    from human_body_reconstruction_tpu_torch.models.nerf import (
        Field, scene_from_bounds)
    from human_body_reconstruction_tpu_torch.ops import rays
    from human_body_reconstruction_tpu_torch.pipeline import mesh_export
    from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
    from human_body_reconstruction_tpu_torch.train import step

    H = data["train_imgs"].shape[1]
    lo, hi = rays.scene_bounds(H, H, data["K"], data["train_poses"], 2.0, 6.0)
    scene = scene_from_bounds(lo, hi, device=device)
    with open(os.path.join(ROOT, JAX_CPU_SCORES)) as f:
        jax_cpu = json.load(f)
    stride = jax_cpu["stride"]
    fields = {}
    for mode, record in TPU_WEIGHTS.items():
        cfg = quality_holdout.make_modes()[mode]
        eval_cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, occupancy=False, compact_samples=0, occ_guided=False))
        field = ckpt.load_params(os.path.join(ROOT, f"qm_params_{mode}.npz"),
                                 Field(cfg)).to(device)
        fields[mode] = (field, cfg)
        with open(os.path.join(ROOT, record)) as f:
            rec = json.load(f)[mode]["holdout_per_pose"]
        ref = jax_cpu[mode]["per_pose_psnr"]
        full, sub = {}, {}
        t0 = time.perf_counter()
        for name, pose, gt in zip(quality_holdout.HOLDOUT_NAMES,
                                  data["hold_poses"], data["hold_imgs"]):
            img = step.render_image(
                field, scene, H, H, data["K"], pose, eval_cfg,
                num_samples=quality_holdout.HOLDOUT_SAMPLES,
                chunk=quality_holdout.HOLDOUT_CHUNK).cpu().numpy()
            gt = gt.cpu().numpy()
            full[name] = psnr(img, gt)
            sub[name] = psnr(img.reshape(-1, 3)[::stride],
                             gt.reshape(-1, 3)[::stride])
        torch.cuda.synchronize()
        print(f"TPU weights {mode} (var_b {float(field.var_b.detach()):.4f}) on the "
              f"card, 4 poses in {time.perf_counter() - t0:.2f} s: "
              + "; ".join(f"{k} {full[k]:.4f} dB (record {rec[k]}, "
                          f"{full[k] - rec[k]:+.4f}), every {stride}th pixel "
                          f"{sub[k]:.4f} vs JAX on the CPU {ref[k]:.4f} "
                          f"({sub[k] - ref[k]:+.4f})" for k in full)
              + f"; mean {np.mean(list(full.values())):.4f} (record "
              f"{np.mean(list(rec.values())):.4f}) {tag}")
        check(all(abs(sub[k] - ref[k]) <= JAX_CPU_DB for k in sub),
              (mode, "against JAX on the CPU", sub, ref))
    mode, R, ref_ply, ref_json = SDF_MESH
    field, cfg = fields[mode]
    stats = mesh_export.export_mesh(
        field, scene, cfg, resolution=R, iso="auto",
        cache_path=f"{work}/sdf_grid.npy", out_path=f"{work}/sdf.ply")
    iso = mesh_export.resolve_iso(np.load(f"{work}/sdf_grid.npy")[..., 3],
                                  "auto")
    with open(os.path.join(ROOT, ref_json)) as f:
        rec = json.load(f)
    voxel = ((hi - lo) / (R - 1)).to(device)
    a = torch.as_tensor(stats["verts"], device=device) / voxel
    b = torch.as_tensor(read_ply_vertices(os.path.join(ROOT, ref_ply)),
                        device=device) / voxel
    dist = 0.5 * (mean_nearest(a, b) + mean_nearest(b, a))
    n_ref = rec["num_verts"]
    print(f"SDF mesh of {mode} at {R}^3 on the card: iso auto -> {iso:.4f}, "
          f"{stats['num_verts']} verts ({stats['num_verts'] / n_ref - 1:+.2%} "
          f"against the TPU's {n_ref}), {stats['num_faces']} faces (TPU "
          f"{rec['num_faces']}), symmetric mean nearest-vertex distance to "
          f"{ref_ply} {dist:.4f} voxels; sweep {stats['sweep_seconds']:.2f} s,"
          f" marching {stats['marching_seconds']:.2f} s {tag}")
    check(stats["num_faces"] > 0 and dist < 2.0, ("SDF mesh", dist))


def sdf_cli_phase(work: str, device: torch.device, tag: str):
    """The PR 8 flags through the entry points a user calls: ``train_hash
    --use_sdf --hierarchical`` (the flagship preset otherwise) for
    CLI_STEPS steps with the warmup cut, then ``--load`` for CLI_STEPS
    more; ``render --use_sdf --hierarchical`` of two orbit views and
    ``nerf2mesh --use_sdf --hierarchical`` of the run, each with the
    encoder kernels' launches counted."""
    from human_body_reconstruction_tpu_torch.cli import (nerf2mesh, render,
                                                         train_hash)

    run_dir = f"{work}/sdf_cli"
    argv = ["--synthetic", "--synthetic_subject", "textured", "--use_sdf",
            "--hierarchical", "--occ_warmup", str(CLI_STEPS // 2),
            "--steps", str(CLI_STEPS), "--log_every", str(CLI_STEPS),
            "--device", str(device), "--out_dir", run_dir, "--model_name",
            "sdf"]
    t0 = time.perf_counter()
    first, launches = counted(wrappers(*TRAIN_KERNELS),
                              lambda: train_hash.main(argv))
    second = train_hash.main(argv + ["--load"])
    torch.cuda.synchronize()
    cfg = second.cfg
    print(f"train_hash --use_sdf --hierarchical: {CLI_STEPS} steps, then "
          f"--load and {CLI_STEPS} more to step {second.state.step} "
          f"({cfg.render.num_samples} + {cfg.render.num_fine_samples or cfg.render.num_samples} "
          f"samples, grid {'installed' if second.state.occ is not None else 'none'}"
          f"), last loss {second.history[-1]['loss']:.5f}, var_b "
          f"{float(second.state.field.var_b.detach()):.4f}; "
          f"{time.perf_counter() - t0:.1f} s; launches in the first run: "
          f"{launches} {tag}")
    check(first.state.step == CLI_STEPS and second.state.step == 2 * CLI_STEPS
          and all(math.isfinite(r["loss"]) for r in second.history),
          ("train_hash --load", first.state.step, second.state.step))
    check(all(n > 0 for n in launches.values()), launches)
    common = ["--ckpt_dir", run_dir, "--model_name", "sdf", "--use_sdf",
              "--hierarchical", "--device", str(device)]
    summary, r_launches = counted(
        wrappers("cp_forward", "dense_forward"), lambda: render.main(
            common + ["--orbit", "2", "--height", "200", "--width", "200",
                      "--out_dir", f"{work}/sdf_renders"]))
    stats, m_launches = counted(
        wrappers("cp_forward", "dense_forward"), lambda: nerf2mesh.main(
            common + ["--resolution", "128", "--iso", "0", "--cache", "",
                      "--out", f"{work}/sdf_cli.ply"]))
    print(f"render --use_sdf --hierarchical: {summary['num_views']} views "
          f"{summary['H']}x{summary['W']}, {summary['wall_s']} s, launches "
          f"{r_launches}; nerf2mesh --use_sdf at 128^3, iso 0: "
          f"{stats['num_verts']} verts, launches {m_launches} {tag}")
    check(summary["num_views"] == 2 and all(
        n > 0 for n in {**r_launches, **m_launches}.values()),
          ("render/nerf2mesh launches", r_launches, m_launches))


def rotmat2qvec(R) -> np.ndarray:
    """(3, 3) rotation -> COLMAP's (w, x, y, z) unit quaternion, w >= 0
    (COLMAP's own read_write_model.rotmat2qvec)."""
    (rxx, ryx, rzx), (rxy, ryy, rzy), (rxz, ryz, rzz) = np.asarray(R)
    k = np.array([[rxx - ryy - rzz, 0, 0, 0],
                  [ryx + rxy, ryy - rxx - rzz, 0, 0],
                  [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
                  [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def write_colmap_text(text_dir: str, c2ws, names, K, H: int, W: int):
    """A COLMAP text model (one OPENCV camera, no distortion) of NeRF-
    convention c2w poses: the inverse of ``colmap_axes_to_nerf`` (both its
    axis matrices are their own inverses) and of ``colmap_to_c2w``."""
    from human_body_reconstruction_tpu_torch.pipeline import poses

    os.makedirs(text_dir, exist_ok=True)
    with open(f"{text_dir}/cameras.txt", "w") as f:
        f.write(f"1 OPENCV {W} {H} {K[0][0]!r} {K[1][1]!r} {K[0][2]!r} "
                f"{K[1][2]!r} 0 0 0 0\n")
    with open(f"{text_dir}/images.txt", "w") as f:
        for k, (c2w, name) in enumerate(zip(c2ws, names)):
            colmap = (poses._WORLD_PERM @ np.asarray(c2w, np.float64)
                      @ poses._CAM_FLIP)
            w2c = colmap[:3, :3].T
            q, t = rotmat2qvec(w2c), -w2c @ colmap[:3, 3]
            # the poses are float32: their rotations orthonormal to ~1e-7
            check(np.abs(poses.qvec2rotmat(q) - w2c).max() < 1e-6,
                  ("quaternion round trip", k))
            f.write(f"{k + 1} " + " ".join(f"{v:.17g}" for v in (*q, *t))
                    + f" 1 {name}\n{W / 2} {H / 2} -1\n")


def paeth_png(img8: np.ndarray) -> bytes:
    """A PNG of uint8 (H, W, 3) img8 with every row Paeth-filtered (as an
    encoder that filters writes most rows of a photograph)."""
    import struct

    x = img8.astype(np.int32)
    a = np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    b = np.pad(x, ((1, 0), (0, 0), (0, 0)))[:-1]
    c = np.pad(b, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    h, w, _ = img8.shape
    rows = np.concatenate([np.full((h, 1), 4, np.uint8),
                           ((x - pred) & 0xFF).astype(np.uint8).reshape(h, -1)],
                          1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def reconstruct_phase(work: str, device: torch.device, tag: str):
    """The capture front end on the card's machine: render the textured
    humanoid's RECON_VIEWS protocol views at RECON_HW^2, write them as PNG
    frames with a COLMAP text model of their cameras, run ``colmap2nerf
    --text`` (sharpness on) and ``reconstruct --skip_poses
    --segment_backend threshold --steps RECON_STEPS`` at its defaults
    (the flagship encoder, 16000 rays x 64 samples, diagonal
    normalisation, a 256^3 mesh at iso 30), the encoder kernels' launches
    counted.  Checks: the poses equal the rendered ones under the
    normalising similarity, the frames read back exactly, the train PSNR
    rises, a non-empty mesh inside the run's bounds; the four encoder
    kernels against their plain versions on one ray batch of the trained
    run's own points.  Returns {kernel name: record}, the launches and the
    point count."""
    from types import SimpleNamespace

    from human_body_reconstruction_tpu_torch.cli import (
        colmap2nerf, quality_holdout, reconstruct)
    from human_body_reconstruction_tpu_torch.data import datasets, png, synthetic
    from human_body_reconstruction_tpu_torch.models import nerf
    from human_body_reconstruction_tpu_torch.pipeline import segment

    H = W = RECON_HW
    t0 = time.perf_counter()
    c2ws = quality_holdout.protocol_poses(RECON_VIEWS)[0]
    focal = quality_holdout.FOCAL_MULT * H
    K = [[focal, 0.0, W / 2], [0.0, focal, H / 2], [0.0, 0.0, 1.0]]
    K_t = torch.tensor(K, device=device)

    def silhouette(pts):          # white albedo: the render is the opacity
        sigma = synthetic.humanoid_field(pts)[1]
        return torch.ones_like(pts), sigma

    frames, accs = [], []
    for c2w in c2ws:
        pose = torch.as_tensor(c2w, device=device)
        img = synthetic.render_gt_image(
            H, W, K_t, pose, field=synthetic.textured_humanoid_field,
            num_samples=quality_holdout.GT_SAMPLES)
        acc = synthetic.render_gt_image(H, W, K_t, pose, field=silhouette,
                                        num_samples=quality_holdout.GT_SAMPLES)
        frames.append((img.cpu().numpy() * 255).astype(np.uint8))
        accs.append(acc[..., 0].cpu().numpy())
    render_s = time.perf_counter() - t0
    wd = f"{work}/recon"
    os.makedirs(f"{wd}/images")
    names = [f"{k:04d}.png" for k in range(RECON_VIEWS)]
    t0 = time.perf_counter()
    for name, img in zip(names, frames):
        png.write_png(f"{wd}/images/{name}", img)
    write_s = time.perf_counter() - t0
    write_colmap_text(f"{work}/colmap_text", c2ws, names, K, H, W)
    t0 = time.perf_counter()
    for name in names:
        png.read_png(f"{wd}/images/{name}")
    decode_ms = 1e3 * (time.perf_counter() - t0) / len(names)
    filtered = {}
    for shape in ((400, 400), (1080, 1920)):
        img = np.tile(frames[0], (3, 5, 1))[:shape[0], :shape[1]]
        data = paeth_png(img)
        t0 = time.perf_counter()
        back = png.decode_png(data)
        filtered[shape] = 1e3 * (time.perf_counter() - t0)
        check(np.array_equal(back, img), ("Paeth PNG decode", shape))

    t0 = time.perf_counter()
    colmap2nerf.main(["--text", f"{work}/colmap_text", "--images",
                      f"{wd}/images", "--out", f"{wd}/transforms.json"])
    poses_s = time.perf_counter() - t0
    with open(f"{wd}/transforms.json") as f:
        meta = json.load(f)
    got = np.array([fr["transform_matrix"] for fr in meta["frames"]])
    want = np.asarray(c2ws, np.float64)
    rel = lambda p: np.einsum("kji,mjl->kmil", p[:, :3, :3], p[:, :3, :3])
    rot_err = float(np.abs(rel(got) - rel(want)).max())
    pair = lambda p: np.linalg.norm(p[:, None, :3, 3] - p[None, :, :3, 3], axis=-1)
    off = ~np.eye(RECON_VIEWS, dtype=bool)
    ratio = pair(got)[off] / pair(want)[off]
    ratio_spread = float((ratio.max() - ratio.min()) / ratio.mean())
    sharp = [fr["sharpness"] for fr in meta["frames"]]
    ds = datasets.load_nerf_json(f"{wd}/transforms.json")
    same_frames = np.array_equal(
        ds["images"], np.stack(frames).astype(np.float32) / 255.0)
    ious = []
    for img, acc in zip(frames, accs):
        m, s = segment.mask_threshold(img) > 0, acc > 0.5
        ious.append(float((m & s).sum() / (m | s).sum()))
    print(f"reconstruct capture: {RECON_VIEWS} views of the textured humanoid "
          f"at {H}x{W} rendered in {render_s:.2f} s, written as PNG in "
          f"{write_s:.3f} s; PNG decode (host of the card's machine) "
          f"{decode_ms:.2f} ms a frame (unfiltered), every row Paeth "
          + ", ".join(f"{h}x{w} {ms:.1f} ms" for (h, w), ms in filtered.items())
          + f"; colmap2nerf {poses_s:.2f} s: relative rotations within "
          f"{rot_err:.2e} of the rendered ones, camera distance ratio spread "
          f"{ratio_spread:.2e} (scale {ratio.mean():.6f}), sharpness "
          f"{min(sharp):.1f}-{max(sharp):.1f}; frames read back equal the "
          f"written ones: {same_frames}; threshold mask IoU against the "
          f"silhouette acc > 0.5: mean {np.mean(ious):.3f}, min "
          f"{min(ious):.3f} (not gated) {tag}")
    check(rot_err <= 1e-5 and ratio_spread <= 1e-5,
          ("recovered poses", rot_err, ratio_spread))
    check(same_frames, "frames read back by load_nerf_json")
    check(min(sharp) > 0, ("sharpness", sharp))

    argv = ["--workdir", wd, "--skip_poses", "--segment_backend", "threshold",
            "--steps", str(RECON_STEPS), "--device", str(device)]
    out, launches = counted(wrappers(*TRAIN_KERNELS),
                            lambda: reconstruct.main(argv))
    trainer, mesh = out["trainer"], out["mesh"]
    hist, cfg = trainer.history, trainer.cfg
    t0 = time.perf_counter()
    trainer.run(RECON_TIMED, log_every=0)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / RECON_TIMED
    sigma = np.load(f"{wd}/density_grid_w_rgb.npy", mmap_mode="r")[..., 3]
    q = np.percentile(sigma, [50, 99, 99.9, 100])
    lo, hi = np.load(f"{wd}/results/bounds_model.npy")
    v = mesh["verts"]
    inside = bool(len(v)) and bool((v.min(0) >= lo - 1e-4).all()
                                   and (v.max(0) <= hi + 1e-4).all())
    print("reconstruct stages: " + ", ".join(
        f"{k} {v_:.2f} s" for k, v_ in out["seconds"].items())
          + f"; the encoder {cfg.hash.num_levels} levels, n_max "
          f"{cfg.hash.n_max}, rank {cfg.hash.cp_rank}, dense levels "
          f"{cfg.hash.dense_levels}, {cfg.render.num_samples} samples, "
          f"{cfg.train.ray_batch} rays, normalization "
          f"{cfg.render.normalization}; train PSNR {hist[0]['psnr']:.2f} dB at "
          f"step {hist[0]['step']} -> {hist[-1]['psnr']:.2f} at "
          f"{hist[-1]['step']}, occupied {hist[-1].get('occupied_frac')}; "
          f"{step_ms:.2f} ms a step over {RECON_TIMED} more guided steps; "
          f"mesh 256^3 iso 30: sweep {mesh['sweep_seconds']:.3f} s, marching "
          f"{mesh['marching_seconds']:.3f} s, {mesh['num_verts']} verts, "
          f"{mesh['num_faces']} faces, inside the bounds {inside}; sigma "
          f"median {q[0]:.3f}, 99% {q[1]:.3f}, 99.9% {q[2]:.3f}, max "
          f"{q[3]:.3f}; launches in the run {launches} {tag}")
    check((cfg.hash.num_levels, cfg.hash.n_max, cfg.hash.cp_rank,
           cfg.hash.dense_levels, cfg.render.num_samples, cfg.train.ray_batch,
           cfg.render.normalization, trainer.ds["H"], trainer.ds["W"])
          == (7, 1448, 25, 2, 64, 16000, "diagonal", H, W),
          ("reconstruct at full width", cfg))
    check(trainer.state.occ is not None, "occupancy grid installed")
    check(hist[-1]["psnr"] > hist[0]["psnr"], ("train PSNR rises", hist))
    check(mesh["num_verts"] > 0 and inside, ("mesh", mesh["num_verts"]))
    check(all(n > 0 for n in launches.values()), launches)

    # one ray batch of the trained run's own points: guided placement from
    # its grid, ray-major as the training step encodes them
    res = SimpleNamespace(cfg=cfg, scene=trainer.scene,
                          field=trainer.state.field, occ=trainer.state.occ)
    data = {"train_imgs": trainer.ds["images"],
            "train_poses": trainer.ds["c2ws"], "K": trainer.ds["K"]}
    gen = torch.Generator(device).manual_seed(SEED + 12)
    batch, placement, draws = mode_batch(res, data, cfg.train.ray_batch, gen)
    with torch.no_grad():
        _, pts = encoded_points(lambda: nerf.render_rays(
            res.field, res.scene, *batch[:3], cfg, occ=res.occ,
            compute_dtype=torch.bfloat16, jitter=True, generator=gen,
            draws=draws, placement=placement))
    pts = pts[0]
    check(pts.shape == (cfg.train.ray_batch * cfg.render.compact_samples, 3),
          ("reconstruct path points", pts.shape))
    label = (f"points of a {cfg.train.ray_batch}-ray batch of the reconstruct "
             f"run (guided, K {cfg.render.compact_samples}, the COLMAP-derived "
             "diagonal bounds)")
    recs = encoder_kernel_checks(res, pts, label, tag)
    return recs, launches, pts.shape[0]


def hash2d_kernel_checks(res, pix, device, tag):
    """The 2-D build of the hash kernels against their plain versions on the
    image fit's own points: ``pix``, one batch of the run's pixels, and the
    H*W points of ``full_pred``, with the run's trained table.  The forward
    bit for bit, the backward within the sum-order tolerance; beside each,
    one library call given the same rows and weights (terms).  Returns
    {record name: (max_abs_err, ms, plain_ms, library_ms, bound)}."""
    from human_body_reconstruction_tpu_torch.cli import image_fit
    from human_body_reconstruction_tpu_torch.ops import cuda_lib, hash_kernel

    cfg, table, sigma = res["cfg"], res["table"].detach(), res["sigma"]
    L, F, W = cfg.num_hashed_levels, cfg.features_per_level, res["W"]
    mu = torch.zeros((), device=device)
    gen = torch.Generator(device).manual_seed(SEED + 9)
    out = {}
    for kind, p in (("image_fit_batch", pix),
                    ("full_pred", torch.arange(res["H"] * W, device=device))):
        ij = image_fit.pixel_coords(p, W)
        n = ij.shape[0]
        a = (table, ij, mu, sigma, cfg)
        g = torch.randn((n, L * F + 3), generator=gen, device=device)[:, 3:]
        ops = n * L * (10 + 4 * (8 + 2 * F))
        with torch.no_grad():
            got = hash_kernel.hash_encode_kernel(*a)
            want = hash_kernel.hash_encode_plain(*a)
            gb = hash_kernel.hash_encode_backward_kernel(*a, g)
            want_b = hash_kernel.hash_encode_plain_backward(*a, g)
            abs_sum = hash_kernel.hash_encode_plain_backward(*a, g.abs())
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            err_f = float((got - want).abs().max())
            err_b = float((gb - want_b).abs().max())
            ratio = float(((gb - want_b).abs() / cuda_lib.sum_order_tolerance(
                want_b, abs_sum, False)).max())
            rows, w = hash_rows_weights(ij, mu, sigma, cfg)
            lib_fwd = embedding_bag_call(table, rows, w)
            lib_err = float((lib_fwd().reshape(n, -1) - want).abs().max())
            touched = int(torch.unique(rows).numel())
            times = {
                "ms_f": time_ms(lambda: hash_kernel.hash_encode_kernel(*a)),
                "plain_f": time_ms(lambda: hash_kernel.hash_encode_plain(*a),
                                   reps=3),
                "lib_f": time_ms(lib_fwd),
                "ms_b": time_ms(lambda: hash_kernel.hash_encode_backward_kernel(
                    *a, g)),
                "plain_b": time_ms(
                    lambda: hash_kernel.hash_encode_plain_backward(*a, g),
                    reps=3),
                "lib_b": time_ms(index_add_call(table, rows, w, g), reps=5)}
        # the forward reads the rows its points touch, the backward writes
        # the whole gradient table
        bnd_f = bound(nbytes(ij, got) + touched * F * 4, ops)
        bnd_b = bound(nbytes(ij, g, gb), ops + n * L * 4 * F * 2)
        print(f"kernel hash_forward (2-D, exact): {n} {kind} points, out "
              f"{tuple(got.shape)}, {touched} distinct rows of "
              f"{L * cfg.table_size}, bit for bit {same} (max_abs_err "
              f"{err_f:.3e}), {times['ms_f']:.4f} ms vs plain "
              f"{times['plain_f']:.4f} ms, embedding_bag given rows and "
              f"weights {times['lib_f']:.4f} ms (max_abs_err {lib_err:.1e}), "
              f"bound {bnd_f[0]:.4f} ms ({bnd_f[1]}) {tag}")
        print(f"kernel hash_backward (2-D, exact): {n} {kind} points, "
              f"max_abs_err {err_b:.3e}, worst |err| / tolerance {ratio:.3f} "
              f"(tol 1), {times['ms_b']:.4f} ms vs plain "
              f"{times['plain_b']:.4f} ms, index_add_ given rows and terms "
              f"{times['lib_b']:.4f} ms, bound {bnd_b[0]:.4f} ms ({bnd_b[1]}) "
              f"{tag}")
        check(same, ("2-D hash_forward bit for bit", kind, err_f))
        check(lib_err <= 1e-5, ("embedding_bag computes the 2-D forward",
                                lib_err))
        check(bool(torch.isfinite(gb).all()) and ratio <= 1.0,
              ("2-D hash_backward", kind, err_b, ratio))
        out[f"hash_forward/{kind}"] = (err_f, times["ms_f"], times["plain_f"],
                                       times["lib_f"], bnd_f)
        out[f"hash_backward/{kind}"] = (err_b, times["ms_b"],
                                        times["plain_b"], times["lib_b"],
                                        bnd_b)
        del rows, w, lib_fwd
    return out


def image_fit_phase(work: str, device: torch.device, tag: str):
    """(a) The 2-D image fit at the CLI's defaults: ``--synthetic`` (the
    256x256 procedural target, batch 65,536), then ``--image`` on a
    512x512 PNG of the same target written by ``data/png.py`` (batch
    200,000), 500 steps each, the hash kernels' launches counted per run;
    then the 2-D kernels against plain on the image run's first batch and
    its full_pred points.  Returns (kernel records, launches of the image
    run)."""
    from human_body_reconstruction_tpu_torch.cli import image_fit
    from human_body_reconstruction_tpu_torch.data import png

    path = f"{work}/image_fit_target.png"
    png.write_png(path, (np.clip(image_fit.procedural_target(IMAGE_FIT_HW),
                                 0, 1) * 255).astype(np.uint8))
    kernels = wrappers("hash_forward", "hash_backward")
    runs = {}
    for label, argv in (("synthetic", ["--synthetic"]),
                        ("image", ["--image", path])):
        out_dir = f"{work}/image_fit_{label}"
        res, launches = counted(kernels, lambda: image_fit.main(
            argv + ["--device", "cuda", "--out_dir", out_dir,
                    "--log_every", "100"]))
        cfg = res["cfg"]
        print(f"image fit --{label}: {res['H']}x{res['W']}, batch "
              f"{res['batch']}, L {cfg.num_levels}, F "
              f"{cfg.features_per_level}, T 2^{cfg.log2_table_size}, n_max "
              f"{cfg.n_max}: {res['steps']} steps, "
              f"{1e3 * res['train_s'] / res['steps']:.3f} ms a step (first-"
              f"use costs included), final full-image PSNR {res['psnr']:.2f} "
              f"dB (floor {IMAGE_FIT_FLOOR_DB:g}); launches {launches} {tag}")
        final = png.read_png(f"{out_dir}/imagefit_final.png")
        check(final.shape == (res["H"], res["W"], 3),
              ("image fit PNG", final.shape))
        check((cfg.num_levels, cfg.log2_table_size, cfg.n_max, res["steps"])
              == (16, 18, 2 ** 16, 500), "the image fit at its defaults")
        check(res["psnr"] > IMAGE_FIT_FLOOR_DB,
              ("image fit PSNR", label, res["psnr"]))
        # a forward and a backward a step, and one full_pred
        check(launches == {"hash_forward": res["steps"] + 1,
                           "hash_backward": res["steps"]}, (label, launches))
        runs[label] = (res, launches)
    res, launches = runs["image"]
    check(res["batch"] == 200_000
          and (res["H"], res["W"]) == (IMAGE_FIT_HW, IMAGE_FIT_HW),
          "the image run's batch and size")
    # the run's first batch: the CLI's pixel generator, seeded 0
    pix = torch.randint(0, res["H"] * res["W"], (res["batch"],),
                        generator=torch.Generator(device).manual_seed(0),
                        device=device)
    return hash2d_kernel_checks(res, pix, device, tag), launches


def vanilla_phase(work: str, device: torch.device, tag: str):
    """(b) ``train_vanilla --synthetic --write`` at its defaults (8x256,
    1024 rays x 64 samples, 1000 iterations): ms a step, the test view's
    PSNR beside the untrained model's and an all-black image's (printed,
    not held: the reference's recipe, ReLU colours at a rate of 1e-2, ends
    near the black image on this black-background scene in the JAX package
    too), the checkpoint read back; then one step from the CLI's initial
    weights on the card against the CPU from the same image, pixels and
    sample positions."""
    from human_body_reconstruction_tpu_torch.cli import psnr, train_vanilla
    from human_body_reconstruction_tpu_torch.data import png
    from human_body_reconstruction_tpu_torch.models import mlp as mlp_lib
    from human_body_reconstruction_tpu_torch.ops import sampling
    from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
    from human_body_reconstruction_tpu_torch.utils import jax_prng

    out_dir = f"{work}/vanilla"
    argv = ["--synthetic", "--write", "--device", "cuda", "--out_dir",
            out_dir, "--log_every", "250"]
    args = train_vanilla.build_parser().parse_args(argv)
    cfg = train_vanilla.model_config(args)
    ds = train_vanilla.load_data(args, device)
    test = ds["images"].shape[0] - 1
    init = mlp_lib.init_classic_nerf(jax_prng.prng_key(0), cfg)
    psnr0 = psnr(train_vanilla.render_view(
        mlp_lib.classic_nerf_from_jax(init, cfg, device), ds, test,
        args).cpu().numpy(), ds["images"][test].cpu().numpy())
    black = psnr(np.zeros((ds["H"], ds["W"], 3), np.float32),
                 ds["images"][test].cpu().numpy())
    res = train_vanilla.main(argv)
    trained = mlp_lib.classic_nerf_from_jax(
        ckpt.load_pytree(res["path"], init)[0], cfg, device)
    again = psnr(train_vanilla.render_view(trained, ds, test, args)
                 .cpu().numpy(), ds["images"][test].cpu().numpy())
    print(f"vanilla: {cfg.n_layers}x{cfg.d_filter}, {args.batch} rays x "
          f"{args.num_samples} samples, {res['steps']} iterations, "
          f"{1e3 * res['train_s'] / res['steps']:.3f} ms a step; test view "
          f"PSNR {res['test_psnr']:.2f} dB (from the saved checkpoint "
          f"{again:.2f}; untrained {psnr0:.2f}, all black {black:.2f}) {tag}")
    check(res["steps"] == 1000 and (cfg.n_layers, cfg.d_filter) == (8, 256),
          "vanilla at its defaults")
    check(math.isfinite(res["test_psnr"]) and again == res["test_psnr"],
          ("vanilla test view, and again from its checkpoint",
           res["test_psnr"], again))
    check(png.read_png(f"{out_dir}/Nerf_test.png").shape
          == (ds["H"], ds["W"], 3), "the vanilla test view's PNG")
    model = mlp_lib.classic_nerf_from_jax(init, cfg, device)
    gen = torch.Generator().manual_seed(SEED + 10)
    pix = torch.randint(0, ds["H"] * ds["W"], (args.batch,), generator=gen)
    t = sampling.stratified_ts((args.batch,), args.near, args.far,
                               args.num_samples, jitter=True, generator=gen)

    def loss_and_grads(m, dev):
        d = {k: (v.to(dev) if torch.is_tensor(v) else v)
             for k, v in ds.items()}
        m.zero_grad(set_to_none=True)
        loss = train_vanilla.batch_loss(m, d, torch.tensor(3, device=dev),
                                        pix.to(dev), args, t=t.to(dev))
        loss.backward()
        return float(loss.detach()), torch.cat(
            [p.grad.reshape(-1).cpu() for p in m.parameters()])

    card_loss, card = loss_and_grads(model, device)
    cpu_loss, ref = loss_and_grads(copy.deepcopy(model).cpu(),
                                   torch.device("cpu"))
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_rel = float(torch.linalg.vector_norm(card - ref)
                     / torch.linalg.vector_norm(ref))
    print(f"vanilla step card vs CPU (initial weights, {args.batch} rays x "
          f"{args.num_samples}): loss {card_loss:.7f} vs {cpu_loss:.7f} (rel "
          f"{loss_rel:.2e}, tol {STEP_LOSS_RTOL:g}); gradient rel norm "
          f"{grad_rel:.2e} (tol {STEP_GRAD_RTOL:g})")
    check(loss_rel <= STEP_LOSS_RTOL,
          ("vanilla step loss", card_loss, cpu_loss))
    check(grad_rel <= STEP_GRAD_RTOL, ("vanilla step grads", grad_rel))


def plot_grads_phase(work: str, device: torch.device, tag: str):
    """(c) The flagship through ``train_hash --plot_grads --display``
    (textured scene, PLOT_GRADS_STEPS steps, a log every 8 with the probe's
    gradient norms, an eval render every 16 with the preview), then a
    ``TrainConfig(schedule="onecycle")`` trainer of ONECYCLE_STEPS steps on
    the same data, its learning rates read after each step against the
    closed form."""
    from human_body_reconstruction_tpu_torch.cli import train_hash
    from human_body_reconstruction_tpu_torch.data import png
    from human_body_reconstruction_tpu_torch.train import state
    from human_body_reconstruction_tpu_torch.train.trainer import Trainer

    out_dir = f"{work}/plot_grads"
    tr, launches = counted(wrappers(*TRAIN_KERNELS), lambda: train_hash.main([
        "--synthetic", "--synthetic_subject", "textured", "--steps",
        str(PLOT_GRADS_STEPS), "--log_every", "8", "--eval_every", "16",
        "--plot_grads", "--display", "--device", "cuda", "--out_dir",
        out_dir, "--model_name", "pg"]))
    keys = {"grad_norm/dense", "grad_norm/lines", "grad_norm/mlp"}
    for rec in tr.history:
        norms = {k: v for k, v in rec.items() if k.startswith("grad_norm/")}
        print(f"plot_grads step {rec['step']}: loss {rec['loss']:.5f}, "
              + ", ".join(f"{k} {v:.4e}" for k, v in sorted(norms.items())))
        check(set(norms) == keys and all(math.isfinite(v) and v > 0
                                         for v in norms.values()),
              ("grad-norm record", rec))
    preview = png.read_png(f"{out_dir}/pg_preview.png")
    print(f"plot_grads: {len(tr.history)} records, preview {preview.shape} "
          f"read back (mean {preview.mean():.1f}); launches {launches} {tag}")
    check(len(tr.history) == PLOT_GRADS_STEPS // 8
          and preview.shape == (400, 400, 3) and preview.std() > 1.0,
          "the preview PNG")
    check(all(v > 0 for v in launches.values()), launches)

    cfg = dataclasses.replace(tr.cfg, train=dataclasses.replace(
        tr.cfg.train, schedule="onecycle"))
    oc = Trainer(cfg=cfg, ds=tr.ds, out_dir=f"{work}/onecycle",
                 model_name="oc", total_steps=ONECYCLE_STEPS,
                 log_fn=lambda _: None)
    del tr
    want = [state.onecycle(lr, ONECYCLE_STEPS)
            for lr in (cfg.train.lr_hash, cfg.train.lr_mlp)]
    worst, losses = 0.0, []
    for k in range(ONECYCLE_STEPS):
        oc.run(1, log_every=1)
        losses.append(oc.history[-1]["loss"])
        for group, sched, lr in zip(oc.state.opt.groups, want,
                                    (cfg.train.lr_hash, cfg.train.lr_mlp)):
            worst = max(worst, abs(float(group.lr) - sched(k)) / lr)
    peak = int(0.3 * ONECYCLE_STEPS)
    print(f"onecycle: {ONECYCLE_STEPS} steps, table rates "
          + " ".join(f"{want[0](k):.4g}" for k in range(ONECYCLE_STEPS))
          + f" (peak {cfg.train.lr_hash:g} at step {peak}), worst |rate - "
          f"closed form| / base rate {worst:.1e} (the device's f32 schedule "
          f"against the host's f64), losses {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}")
    check(worst <= ONECYCLE_F32_TOL
          and abs(want[0](peak) - cfg.train.lr_hash) <= 1e-12
          and all(math.isfinite(v) for v in losses), "onecycle rates")


# the hash-grid variants: four protocol modes cut in depth (the cell
# grid and the bf16 grid unculled, the int8 ones past their grid's install
# at 256), the int8 speedrun capped after its third gate, and train_hash's
# two sorted scatter strategies for a few steps
VARIANT_MODES = {"cell": 64, "packed_gsub": 64, "int8_dense_guided_lvl": 288,
                 "int8_dense_guided_k32_mass_lpair": 288}
INT8_SPEEDRUN_ARGS = ("--encoder", "int8", "--eval_every", "125",
                      "--max_steps", "375", "--eval_after_train_db", "0")
SCATTER_STEPS = 12
INT8_SWEEP_RES = 256            # the int8 run's mesh sweep: 64 chunks
L2_BUFFER_BYTES = 24 << 20      # an L2-resident buffer, for the L2 read rate
VARIANT_REPLACES = {
    "hash_pack": "none (no TPU kernel: human_body_reconstruction_tpu/ops/"
                 "hash_encoding.py:389,516 pack_table_bf16/int8 in jnp)",
    "packed_forward": "none (no TPU kernel: human_body_reconstruction_tpu/"
                      "ops/hash_encoding.py:312,411,545 packed gathers in "
                      "jnp)",
    "hash_backward": "none (no TPU kernel: human_body_reconstruction_tpu/"
                     "ops/hash_encoding.py:483,589 the subsampled VJP "
                     "scatters)",
    "cell_forward": "none (no TPU kernel: human_body_reconstruction_tpu/ops/"
                    "hash_encoding.py:195 hash_encode_cell, a jnp row gather)",
    "cell_backward": "none (no TPU kernel: the autodiff scatter of "
                     "human_body_reconstruction_tpu/ops/hash_encoding.py:195)",
    "hash_pairs": "none (no TPU kernel: the (index, value) pairs of "
                  "human_body_reconstruction_tpu/ops/hash_encoding.py:483,589)",
    "add_sorted": "none (no TPU kernel: human_body_reconstruction_tpu/ops/"
                  "hash_encoding.py:102 scatter_add_flat, sorted and segsum)"}


def variant_wrappers(*names):
    """(name, wrapper) of the hash-variant kernels (and, by their names in
    ``wrappers``, the earlier kernels), in the order given."""
    from human_body_reconstruction_tpu_torch.ops import hash_variants as hv

    table = {"hash_pack": hv.pack_kernel,
             "packed_forward": hv.packed_encode_kernel,
             "cell_forward": hv.cell_encode_kernel,
             "cell_backward": hv.cell_encode_backward_kernel,
             "hash_pairs": hv.pairs_kernel,
             "add_sorted": hv.add_sorted_kernel}
    return [(nm, table[nm]) if nm in table else wrappers(nm)[0]
            for nm in names]


def variant_mode_phase(mode: str, work: str, device: torch.device, tag: str):
    """``quality_holdout --mode mode --save_params`` cut to
    VARIANT_MODES[mode] steps: finite holdout PSNRs, 0 < occ_frac < 1 where
    the mode culls, and the launches of the kernels of its path.  Returns
    (row, launches, the saved run restored with its grid)."""
    from human_body_reconstruction_tpu_torch.cli import quality_holdout
    from human_body_reconstruction_tpu_torch.pipeline import restore

    steps = VARIANT_MODES[mode]
    cfg = quality_holdout.make_modes()[mode]
    kernels = {"cell": ("cell_forward", "cell_backward")}.get(
        mode, ("uniform_bits", "hash_pack", "packed_forward", "hash_backward")
        + (("dense_forward", "dense_backward") if cfg.hash.dense_levels
           else ()))
    argv = ["--mode", mode, "--steps", str(steps), "--device", str(device),
            "--out", f"{work}/{mode}.json", "--save_params"]
    t0 = time.perf_counter()
    row, launches = counted(variant_wrappers(*kernels),
                            lambda: quality_holdout.main(argv,
                                                         log=lambda s: None))
    print(f"quality protocol ({mode}): {row['steps']} steps, "
          f"{1e3 * PROTOCOL_RAYS / row['rays_per_sec']:.2f} ms/step, "
          f"{row['rays_per_sec']} rays/s, train PSNR {row['train_psnr']} dB, "
          f"occ_frac {row.get('occ_frac')}; holdout "
          + ", ".join(f"{k} {v}" for k, v in row["holdout_per_pose"].items())
          + f" dB, mean {row['holdout_psnr']}; launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s with the ground truth {tag}")
    check(row["steps"] == steps and all(
        math.isfinite(v) for v in row["holdout_per_pose"].values())
        and row["holdout_psnr"] > 10.0, (mode, row))
    check(not cfg.render.occupancy or 0.0 < row.get("occ_frac", 0.0) < 1.0,
          (mode, "occ_frac", row.get("occ_frac")))
    check(all(n > 0 for n in launches.values()), (mode, launches))
    res = restore.restore(f"{work}/{mode}", mode, device=device,
                          with_occ=True, log_fn=lambda s: None)
    return row, launches, res


def variant_record(nm, run, kern, plain, compare, n_bytes, ops, library=None,
                   plain_reps=3):
    """Time kernel ``kern`` against its plain version and the library call;
    ``compare(got, want)`` -> (max_abs_err, passed, note).  Returns
    (max_abs_err, ms, plain_ms, library_ms, bound)."""
    with torch.no_grad():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err, ok, note = compare(got, want)
        ms = time_ms(kern)
        plain_ms = time_ms(plain, reps=plain_reps)
        lib_ms = None if library is None else time_ms(library)
    bnd = bound(n_bytes, ops)
    lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
    print(f"kernel {nm} ({run}): {note}, max_abs_err {err:.3e}, {ms:.4f} ms "
          f"vs plain {plain_ms:.4f} ms{lib}, bound {bnd[0]:.4f} ms "
          f"({bnd[1]})")
    check(ok, (nm, run, err, note))
    return err, ms, plain_ms, lib_ms, bnd


def bit_for_bit(got, want):
    """compare() of a forward or a pack: each tensor equal to its plain
    twin, integers compared as int64 and floats as float64 (an int8 word
    is past float32's 2^24, where a float32 cast hides its low bytes)."""
    pairs = (list(zip(got, want)) if isinstance(got, (tuple, list))
             else [(got, want)])
    same, err = True, 0.0
    for g, w in pairs:
        kinds = g.is_floating_point() == w.is_floating_point()
        wide = torch.float64 if g.is_floating_point() else torch.int64
        g, w = g.to(wide), w.to(wide)
        same = same and kinds and torch.equal(g, w)
        err = max(err, float((g - w).abs().max()))
    return err, same, f"bit for bit {same}"


def within_sum_order(abs_sum):
    """compare() of a backward: within ``cuda_lib.sum_order_tolerance``."""
    from human_body_reconstruction_tpu_torch.ops import cuda_lib

    def compare(got, want):
        ratio = float(((got - want).abs() / cuda_lib.sum_order_tolerance(
            want, abs_sum, False)).max())
        ok = ratio <= 1.0 and bool(torch.isfinite(got).all())
        return (float((got - want).abs().max()), ok,
                f"worst |err| / tolerance {ratio:.3f}")
    return compare


def abs_sums(size, idx, val):
    """The sum of |val| at each index: the tolerance's S of a scatter."""
    return torch.zeros(size, device=val.device).index_add_(
        0, idx.long(), val.abs())


def variant_kernel_checks(hash_pts, hash_scene, runs, device, tag):
    """The hash-variant kernels against their plain versions, timed beside
    their bounds and library calls, and the A/B against the f32 kernels on
    the same points: on the hash path's 1,024,000 points (L 16, F 2, T 2^16:
    the bf16 pack and stochastic forward, its 1-of-2 backward and the full
    one, the pairs and both sorted adds, the cell pair against the exact
    pair), and on the int8 modes' own first-pass points (6 hashed levels, F
    4: the int8 pack, the stochastic and packed-exact forwards, the lvl and
    lpair backwards), and the packed-exact forward on the hash path's points
    (bf16) and on a sweep chunk of the int8 run.  Returns ({record name:
    record}, the A/B times, the int8 modes' point counts, {packed-exact
    record name: (sectors, L2 sector figure in ms)})."""
    from human_body_reconstruction_tpu_torch.ops import (
        hash_encoding, hash_kernel, hash_variants as hv, rng_kernel)
    from human_body_reconstruction_tpu_torch.pipeline import mesh_export

    out, points, sectors = {}, {}, {}
    l2_rate = l2_read_rate(device)
    print(f"L2 read rate (torch.sum over a {L2_BUFFER_BYTES}-byte buffer): "
          f"{l2_rate / 1e12:.3f} TB/s {tag}")

    def sector_figure(key, rows):
        count = corner_sectors(rows)
        sectors[key] = (count, 1e3 * 32 * count / l2_rate)
        print(f"  {key}: {count} sectors ({count / rows.shape[0]:.3f} a "
              f"(point, level)), L2 sector figure {sectors[key][1]:.4f} ms")
    gen = torch.Generator(device).manual_seed(SEED + 20)
    n = hash_pts.shape[0]
    mu, sigma = hash_scene["mu"], hash_scene["sigma"]
    packed = runs["packed_gsub"][2]
    h = packed.cfg.hash
    table = packed.field.table.detach()
    L, T, F = table.shape
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=device,
                         dtype=torch.int32)
    u = rng_kernel.uniform(seed, (3, L, n))
    g = torch.randn((n, L * F + 3), generator=gen, device=device)[:, 3:]
    a = (hash_pts, mu, sigma, h)
    print(f"hash path: {n} points, table {tuple(table.shape)} ({mode_name(h)})")
    # the pack
    words, scale = hv.pack_kernel(table, "bf16")
    out["hash_pack/bf16_table"] = variant_record(
        "hash_pack", "bf16, the packed_gsub table",
        lambda: hv.pack_kernel(table, "bf16")[0],
        lambda: hv.pack_plain(table, "bf16")[0], bit_for_bit,
        nbytes(table, words), L * T * F * 2,
        library=lambda: table.to(torch.bfloat16).view(torch.int32))
    check(torch.equal(table.to(torch.bfloat16).view(torch.int32).reshape(-1),
                      words), "bf16 words are the bf16 cast's bits")
    # the packed stochastic forward vs the f32 stochastic one
    feats, bits = hv.packed_encode_kernel(words, scale, *a, u=u)
    rows, _ = hash_rows_weights(hash_pts, mu, sigma, h, bits)
    unpacked = hv.unpack_plain(words, None, "bf16", 2, 0)
    out["packed_forward/bf16_train_path"] = variant_record(
        "packed_forward", "bf16 stochastic, hash path",
        lambda: hv.packed_encode_kernel(words, scale, *a, u=u),
        lambda: hv.packed_encode_plain(words, scale, *a, u=u), bit_for_bit,
        nbytes(hash_pts, words, u, feats, bits),
        forward_ops("hash_forward", table, h, n, True),
        library=embedding_bag_call(unpacked, rows, None))
    ab = {"hash_forward/stochastic_same_points": time_ms(
        lambda: hash_kernel.hash_encode_kernel(table, *a, u=u))}
    # the packed-exact read of the same words (train_hash --packed_exact)
    xrows, xw = hash_rows_weights(hash_pts, mu, sigma, h)
    xfeats = hv.packed_encode_kernel(words, scale, *a)
    out["packed_forward/bf16_exact_train_path"] = variant_record(
        "packed_forward", "bf16 packed-exact, hash path",
        lambda: hv.packed_encode_kernel(words, scale, *a),
        lambda: hv.packed_encode_plain(words, scale, *a), bit_for_bit,
        nbytes(hash_pts, words, xfeats), forward_ops("hash_forward", table, h, n),
        library=embedding_bag_call(unpacked, xrows, xw))
    sector_figure("packed_forward/bf16_exact_train_path", xrows)
    del xrows, xw, xfeats
    # the 1-of-2 backward vs the full one
    draws = hash_encoding.draw_subsample(
        "hash_encode_stochastic_packed", h, L, n, device, gen)
    pick = draws["pick"]
    idx, val = hv.pairs_kernel(table, *a, g, bits, pick)
    out["hash_backward/bf16_gsub_train_path"] = variant_record(
        "hash_backward", "bf16 1-of-2, hash path",
        lambda: hash_kernel.hash_encode_backward_kernel(table, *a, g, bits,
                                                        pick=pick),
        lambda: hv.scatter_plain(table.numel(), *hv.pairs_plain(
            table, *a, g, bits, pick)).reshape(table.shape),
        within_sum_order(abs_sums(table.numel(), idx, val).reshape(
            table.shape)),
        routed_bytes(hash_pts, table, val.numel()), n * L * 14,
        library=index_add_pairs_call(table.numel(), idx, val))
    ab["hash_backward/stochastic_same_points"] = time_ms(
        lambda: hash_kernel.hash_encode_backward_kernel(table, *a, g, bits))
    ab["hash_backward/bf16_gsub_walk"] = walk_on_routed_grad(table, a, g, bits,
                                                             pick)
    # the pairs and the sorted adds (train_hash --scatter_strategy)
    out["hash_pairs/bf16_gsub_train_path"] = variant_record(
        "hash_pairs", "bf16 1-of-2, hash path",
        lambda: hv.pairs_kernel(table, *a, g, bits, pick),
        lambda: hv.pairs_plain(table, *a, g, bits, pick),
        bit_for_bit, nbytes(hash_pts, g, bits, pick, idx, val), n * L * 14)
    si, sv = hv.sort_pairs(idx, val)
    sort_ms = time_ms(lambda: hv.sort_pairs(idx, val))
    for strategy in ("sorted", "segsum"):
        out[f"add_sorted/{strategy}_train_path"] = variant_record(
            "add_sorted", f"{strategy}, {si.numel()} sorted pairs",
            lambda: hv.add_sorted_kernel(table.numel(), si, sv, strategy),
            lambda: hv.scatter_plain(table.numel(), si, sv, strategy),
            within_sum_order(abs_sums(table.numel(), idx, val)),
            nbytes(si, sv, table), si.numel(),
            library=index_add_pairs_call(table.numel(), si, sv))
    # the cell pair vs the exact pair
    cell = runs["cell"][2]
    ctab = cell.field.table.detach()
    ch = cell.cfg.hash
    ca = (hash_pts, mu, sigma, ch)
    cfeats = hv.cell_encode_kernel(ctab, *ca)
    crow, cw = cell_rows_weights(hash_pts, mu, sigma, ch)
    out["cell_forward/train_path"] = variant_record(
        "cell_forward", "cell, hash path",
        lambda: hv.cell_encode_kernel(ctab, *ca),
        lambda: hv.cell_encode_plain(ctab, *ca), bit_for_bit,
        nbytes(hash_pts, ctab, cfeats), n * L * (15 + 8 * (10 + 2 * F)),
        library=embedding_bag_call(ctab.reshape(-1, F)[None], crow, cw))
    out["cell_backward/train_path"] = variant_record(
        "cell_backward", "cell, hash path",
        lambda: hv.cell_encode_backward_kernel(ctab, *ca, g),
        lambda: hv.cell_encode_plain_backward(ctab, *ca, g),
        within_sum_order(hv.cell_encode_plain_backward(ctab, *ca, g.abs())),
        nbytes(hash_pts, g, ctab), n * L * (15 + 8 * (10 + 2 * F)),
        library=index_add_call(ctab.reshape(-1, F)[None], crow, cw, g))
    del crow, cw
    # the cell backward at the protocol's shape: the cell mode's first-pass
    # points of a PROTOCOL_RAYS batch (128 samples a ray)
    ppts = pass_points(cell, runs["data"], device, 0)
    m = points["cell_protocol"] = ppts.shape[0]
    pa = (ppts, cell.scene["mu"], cell.scene["sigma"], ch)
    pg = torch.randn((m, L * F), generator=gen, device=device)
    prow, pw = cell_rows_weights(*pa)
    pfeats = hv.cell_encode_kernel(ctab, *pa)
    out["cell_forward/protocol_path"] = variant_record(
        "cell_forward", f"cell, {m} protocol points",
        lambda: hv.cell_encode_kernel(ctab, *pa),
        lambda: hv.cell_encode_plain(ctab, *pa), bit_for_bit,
        nbytes(ppts, ctab, pfeats), m * L * (15 + 8 * (10 + 2 * F)),
        library=embedding_bag_call(ctab.reshape(-1, F)[None], prow, pw))
    out["cell_backward/protocol_path"] = variant_record(
        "cell_backward", f"cell, {m} protocol points",
        lambda: hv.cell_encode_backward_kernel(ctab, *pa, pg),
        lambda: hv.cell_encode_plain_backward(ctab, *pa, pg),
        within_sum_order(hv.cell_encode_plain_backward(ctab, *pa, pg.abs())),
        nbytes(ppts, pg, ctab), m * L * (15 + 8 * (10 + 2 * F)),
        library=index_add_call(ctab.reshape(-1, F)[None], prow, pw, pg))
    del ppts, pg, prow, pw, pfeats
    torch.cuda.empty_cache()
    ab["hash_forward/exact_same_points"] = time_ms(
        lambda: hash_kernel.hash_encode_kernel(table, *a))
    ab["hash_backward/exact_same_points"] = time_ms(
        lambda: hash_kernel.hash_encode_backward_kernel(table, *a, g))
    del rows, idx, val, si, sv
    torch.cuda.empty_cache()
    # int8: each mode's own first-pass points
    for mode, kind in (("int8_dense_guided_k32_mass_lpair", "lpair"),
                       ("int8_dense_guided_lvl", "lvl")):
        res, data = runs[mode][2], runs["data"]
        pts = pass_points(res, data, device, 0)
        ih, itab = res.cfg.hash, res.field.table.detach()
        iL, _, iF = itab.shape
        ia = (pts, res.scene["mu"], res.scene["sigma"], ih)
        m = points[f"int8_{kind}"] = pts.shape[0]
        iu = rng_kernel.uniform(seed, (3, iL, m))
        ig = torch.randn((m, iL * iF), generator=gen, device=device)
        iw, isc = hv.pack_kernel(itab, "int8")
        ifeats, ibits = hv.packed_encode_kernel(iw, isc, *ia, u=iu)
        label = f"{mode}'s {m} first-pass points"
        if kind == "lpair":
            print(f"int8 path: {label}, table {tuple(itab.shape)}")
            out["hash_pack/int8_table"] = variant_record(
                "hash_pack", f"int8, the {mode} table",
                lambda: hv.pack_kernel(itab, "int8"),
                lambda: hv.pack_plain(itab, "int8"), bit_for_bit,
                nbytes(itab, iw, isc), itab.numel() * 8)
            irows, _ = hash_rows_weights(pts, ia[1], ia[2], ih, ibits)
            flat = torch.cat([hv.unpack_plain(
                iw.reshape(iL, -1)[l], isc, "int8", iF, l)
                for l in range(iL)])
            out["packed_forward/int8_train_path"] = variant_record(
                "packed_forward", f"int8 stochastic, {label}",
                lambda: hv.packed_encode_kernel(iw, isc, *ia, u=iu),
                lambda: hv.packed_encode_plain(iw, isc, *ia, u=iu),
                bit_for_bit, nbytes(pts, iw, isc, iu, ifeats, ibits),
                forward_ops("hash_forward", itab, ih, m, True),
                library=embedding_bag_call(flat, irows, None))
            erows, ew = hash_rows_weights(pts, ia[1], ia[2], ih)
            efeats = hv.packed_encode_kernel(iw, isc, *ia)
            out["packed_forward/int8_exact_path"] = variant_record(
                "packed_forward", f"int8 packed-exact, {label}",
                lambda: hv.packed_encode_kernel(iw, isc, *ia),
                lambda: hv.packed_encode_plain(iw, isc, *ia), bit_for_bit,
                nbytes(pts, iw, isc, efeats),
                forward_ops("hash_forward", itab, ih, m),
                library=embedding_bag_call(flat, erows, ew))
            sector_figure("packed_forward/int8_exact_path", erows)
            # the middle chunk of the run's mesh sweep
            lo = res.scene["min_bound"]
            spts = mesh_export.sweep_points(
                (INT8_SWEEP_RES ** 3 // SWEEP_CHUNK // 2) * SWEEP_CHUNK,
                INT8_SWEEP_RES, SWEEP_CHUNK, lo, res.scene["max_bound"] - lo)
            sa = (spts, *ia[1:])
            srows, sw = hash_rows_weights(*sa)
            sfeats = hv.packed_encode_kernel(iw, isc, *sa)
            out["packed_forward/int8_exact_sweep_chunk"] = variant_record(
                "packed_forward", f"int8 packed-exact, {mode}'s sweep chunk",
                lambda: hv.packed_encode_kernel(iw, isc, *sa),
                lambda: hv.packed_encode_plain(iw, isc, *sa), bit_for_bit,
                nbytes(spts, iw, isc, sfeats),
                forward_ops("hash_forward", itab, ih, SWEEP_CHUNK),
                library=embedding_bag_call(flat, srows, sw))
            sector_figure("packed_forward/int8_exact_sweep_chunk", srows)
            del irows, erows, ew, flat, spts, srows, sw, sfeats
        sub = hash_encoding.draw_subsample(
            "hash_encode_stochastic_int8", ih, iL, m, device, gen)
        sel = (sub["pick"], sub.get("lsel"), sub.get("psel"))
        iidx, ival = hv.pairs_kernel(itab, *ia, ig, ibits, *sel)
        out[f"hash_backward/int8_{kind}_path"] = variant_record(
            "hash_backward", f"int8 {kind}, {label}",
            lambda: hash_kernel.hash_encode_backward_kernel(
                itab, *ia, ig, ibits, pick=sel[0], lsel=sel[1], psel=sel[2]),
            lambda: hv.scatter_plain(itab.numel(), *hv.pairs_plain(
                itab, *ia, ig, ibits, *sel)).reshape(itab.shape),
            within_sum_order(abs_sums(itab.numel(), iidx, ival)
                             .reshape(itab.shape)),
            routed_bytes(pts, itab, ival.numel(),
                         *[v for v in sel[1:] if v is not None]),
            ival.numel() * 14,
            library=index_add_pairs_call(itab.numel(), iidx, ival))
        ab[f"hash_backward/int8_{kind}_walk"] = walk_on_routed_grad(
            itab, ia, ig, ibits, *sel)
        del pts, iu, ig, iidx, ival
        torch.cuda.empty_cache()
    print("A/B on the hash path's points (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ab.items())
          + f"; torch.sort of the 1-of-2 pairs {sort_ms:.4f} {tag}")
    return out, ab, points, sectors


def mode_name(h) -> str:
    return (f"L {h.num_hashed_levels}, F {h.features_per_level}, T "
            f"2^{h.log2_table_size}, {h.variant}")


def cell_rows_weights(pts, mu, sigma, h):
    """The cell forward as a bag of 8 a (point, level) over the (L*T*8, F)
    view of the cell table: rows (N*L, 8) = row * 8 + c and weights w_c."""
    from human_body_reconstruction_tpu_torch.ops import hash_variants as hv
    from human_body_reconstruction_tpu_torch.ops.dense_grid import normalise

    per_level = hv._cell_rows(normalise(pts, mu, sigma), h)
    c = torch.arange(8, device=pts.device)
    rows = torch.stack([r[:, None] * 8 + c for r, _ in per_level], 1)
    w = torch.stack([torch.stack(ws, -1) for _, ws in per_level], 1)
    return rows.reshape(-1, 8), w.reshape(-1, 8)


def routed_bytes(pts, table, terms: int, *draws) -> int:
    """The bytes a subsampled backward must move: the points, the level
    draws, each drawn term's gradient value, corner bits and feature pick
    (4 + 1 + 1 B), and the table's gradient written once: what the run's
    draws need, not the whole gradient matrix and draw arrays."""
    return nbytes(pts, table, *draws) + 6 * terms


def walk_on_routed_grad(table, a, g, bits, pick, lsel=None, psel=None):
    """ms of the run walk (``hbr_hash_backward`` without draws, the
    unsubsampled stochastic backward) given a subsampled backward's routed
    gradient: the same sum, the undrawn terms zero."""
    from human_body_reconstruction_tpu_torch.ops import hash_kernel

    routed = hash_kernel.routed_grad(g, table.shape[-1], pick, lsel, psel)
    return time_ms(lambda: hash_kernel.hash_encode_backward_kernel(
        table, *a, routed, bits))


def mlp_ratios(got, plain):
    """(share of entries beyond the tolerance, largest |err| / tolerance) of
    each gradient, weights and biases in layer order then the features',
    against ``mlp_kernel.plain_backward``'s; every gradient bf16-exact."""
    from human_body_reconstruction_tpu_torch.ops import cuda_lib

    ref_f, refs, sums, s_f = plain
    out = []
    for g, ref, s in zip(got, [*refs, ref_f], [*sums, s_f]):
        check(torch.equal(g, g.to(torch.bfloat16).float()), "bf16-exact")
        r = (g - ref).abs() / cuda_lib.sum_order_tolerance(ref, s, True)
        out.append((float((r > 1).float().mean()), float(r.max())))
    return out


def mlp_phase(device, tag, launches):
    """The fused MLP3D kernels (csrc/mlp.cu) at the main path's shapes: the
    flagship head (129 features, view encoding 24) forward and backward on
    TRAIN_POINTS (768,000 guided, 2,048,000 unculled) and forward on a
    N_POINTS serving chunk; against the composed ``_linear`` path (the plain
    version: bf16-rounded operands, cuBLAS f32 GEMMs with TF32 off, autograd)
    and, as the library yardstick, the same layers as cuBLAS bf16 GEMMs
    (``F.linear`` on bf16 tensors: the products on the tensor cores, rounded
    to bf16 after each layer, so not the same function).  Held as the card
    tests hold them (tests/test_torch_mlp_kernel.py): the training forward
    (a gradient follows) equal to the composed path's, the serving forward's
    outputs within 1e-5 on all but MLP_FLIP_SHARE and within MLP_OUT_MAX
    everywhere, and the gradients (features, each layer's weights and bias)
    within ``cuda_lib.sum_order_tolerance`` of ``mlp_kernel.plain_backward``
    on all but MLP_GRAD_SHARE of their entries and within MLP_GRAD_MAX (the
    features' MLP_FEAT_MAX) of it everywhere; the composed path's own
    gradients against the same plain backward are printed beside them.
    ``launches`` gives each row's: the kernels' host calls in the main
    path's run (the training run's guided and unculled phases, the served
    requests).  Bound: the bytes the function must move (features, view
    encodings and outputs once; the backward's cotangents and feature
    gradient) over 3.35 TB/s against the products' FLOPs over 989
    TFLOP/s."""
    import torch.nn.functional as F
    from human_body_reconstruction_tpu_torch.models import mlp
    from human_body_reconstruction_tpu_torch.ops import mlp_kernel
    from human_body_reconstruction_tpu_torch.utils import config as C

    bf16 = torch.bfloat16
    m = mlp.MLP3D(C.MLPConfig(), 129, 24,
                  generator=torch.Generator().manual_seed(SEED)).to(device)
    layers = list(m.sig) + list(m.col)
    params = [p for l in layers for p in (l.weight, l.bias)]
    flops = 2 * sum(l.in_features * l.out_features for l in layers)
    gen = torch.Generator(device).manual_seed(SEED + 40)
    report = []
    for label, n, bwd in (("guided_train", TRAIN_POINTS[0], True),
                          ("unculled_train", TRAIN_POINTS[1], True),
                          ("serving_chunk", N_POINTS, False)):
        feats = torch.randn((n, 129), generator=gen, device=device) * 0.3
        dirs = torch.rand((n, 24), generator=gen, device=device) * 2 - 1
        cot = (torch.randn((n, 3), generator=gen, device=device),
               torch.randn((n,), generator=gen, device=device))
        f = feats.clone().requires_grad_(bwd)

        def plain_head(x):
            raw, geo = m._density(x, bf16)
            return (m.color(geo, dirs, bf16),
                    mlp.apply_density_activation(raw, m.cfg)[..., 0])

        def library_head(x):
            h = x.to(bf16)
            for i, l in enumerate(m.sig):
                h = F.linear(h, l.weight.to(bf16), l.bias.to(bf16))
                h = torch.relu(h) if i < len(m.sig) - 1 else h
            raw, h = h[:, :1], torch.cat([h[:, 1:], dirs.to(bf16)], dim=-1)
            for i, l in enumerate(m.col):
                h = F.linear(h, l.weight.to(bf16), l.bias.to(bf16))
                h = torch.relu(h) if i < len(m.col) - 1 else h
            return torch.sigmoid(h), F.leaky_relu(raw, 0.01)[:, 0]

        def run(head):
            def call():
                for p in m.parameters():
                    p.grad = None
                f.grad = None
                if not bwd:
                    with torch.no_grad():
                        return head(f)
                outs = head(f)
                torch.autograd.backward(outs, cot)
                return outs
            return call

        with torch.no_grad():
            ref = plain_head(feats)
        got = run(lambda x: m(x, dirs, bf16))()
        gaps = [(a.detach() - b).abs() for a, b in zip(got, ref)]
        err = max(float(g.max()) for g in gaps)
        flips = max(float((g > 1e-5).float().mean()) for g in gaps)
        grads = ""
        if bwd:
            check(err == 0, ("training forward equals _linear", label, err))
            plain = mlp_kernel.plain_backward(m, feats, dirs, cot)
            kern = mlp_ratios([*(p.grad for p in params), f.grad], plain)
            run(plain_head)()
            comp = mlp_ratios([*(p.grad for p in params), f.grad], plain)
            del plain
            for i, (share, worst) in enumerate(kern):
                most = MLP_GRAD_MAX if i < len(kern) - 1 else MLP_FEAT_MAX
                check(share <= MLP_GRAD_SHARE and worst <= most,
                      ("gradient within the order tolerance", label, i,
                       share, worst))
            fmt = (lambda r: f"features {r[-1][0]:.2e} / {r[-1][1]:.3f}, "
                   f"weights and biases {max(x[0] for x in r[:-1]):.2e} / "
                   f"{max(x[1] for x in r[:-1]):.3f}")
            grads = (f"; gradients against the plain backward (share beyond "
                     f"the tolerance / largest ratio): kernel {fmt(kern)}; "
                     f"composed _linear {fmt(comp)}")
        else:
            check(flips <= MLP_FLIP_SHARE and err <= MLP_OUT_MAX,
                  ("serving forward within the order tolerance", flips, err))
        del got, gaps
        ms = time_ms(run(lambda x: m(x, dirs, bf16)))
        plain_ms = time_ms(run(plain_head), reps=5)
        library_ms = time_ms(run(library_head), reps=5)
        n_bytes = 4 * n * (129 + 24 + 4 + ((4 + 129) if bwd else 0))
        bnd = bound(n_bytes, flops * n * (3 if bwd else 1), BF16_OPS_PER_S)
        what = "forward and backward" if bwd else "forward"
        print(f"mlp {label} ({n} points, {what}): kernel {ms:.4f} ms, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}), composed _linear {plain_ms:.4f} "
              f"ms, cuBLAS bf16 layers {library_ms:.4f} ms; forward max_abs_err "
              f"{err:.3e} (share beyond 1e-5 {flips:.2e}){grads}; launches in "
              f"the main path's run {launches[label]} {tag}")
        report.append(entry(
            f"mlp3d/{label}", MLP_SOURCE, MLP_REPLACES, launches[label], err,
            ms, plain_ms, library_ms, bnd,
            f"{n} points, 129 features, view encoding 24, width 64, {what}; "
            "launches: " + ("the flagship training run's "
                            + label.split("_")[0] + " phase" if bwd else
                            "the served requests of the restored model")))
        del feats, dirs, cot, f
        for p in m.parameters():
            p.grad = None
        torch.cuda.empty_cache()
    return report


def launch_list_phase(device, tag):
    """The device operations that one call of the int8 pack (the lpair
    mode's table), the cell forward, the pairs kernel (1-of-2, L 16, F 2)
    and the packed-exact forward (the lpair mode's int8 words) runs on
    HASH_POINTS seeded points, by torch.profiler, before any other phase
    profiles: each its one kernel, by name, and no memset or copy.  A
    profiler that records nothing fails the check."""
    from human_body_reconstruction_tpu_torch.cli import quality_holdout
    from human_body_reconstruction_tpu_torch.ops import (
        hash_encoding, hash_variants as hv)

    modes = quality_holdout.make_modes()
    gen = torch.Generator(device).manual_seed(SEED + 30)
    n = HASH_POINTS
    x = torch.rand((n, 3), generator=gen, device=device)
    mu, sigma = torch.zeros(3, device=device), torch.ones(3, device=device)

    def table(h, width):
        return torch.randn((h.num_hashed_levels, h.table_size, width),
                           generator=gen, device=device)

    ih, ch, ph = (modes[m].hash for m in (
        "int8_dense_guided_k32_mass_lpair", "cell", "packed_gsub"))
    itab = table(ih, ih.features_per_level)
    ctab = table(ch, 8 * ch.features_per_level)
    ptab = table(ph, ph.features_per_level)
    L, F = ph.num_hashed_levels, ph.features_per_level
    bits = torch.randint(0, 8, (L, n), generator=gen, device=device,
                         dtype=torch.uint8)
    pick = hash_encoding.draw_subsample("hash_encode_stochastic_packed", ph,
                                        L, n, device, gen)["pick"]
    g = torch.randn((n, L * F), generator=gen, device=device)
    iw, isc = hv.pack_kernel(itab, "int8")
    calls = {"int8 pack": ("pack_int8_kernel",
                           lambda: hv.pack_kernel(itab, "int8")),
             "cell forward": ("cell_forward_kernel",
                              lambda: hv.cell_encode_kernel(ctab, x, mu,
                                                            sigma, ch)),
             "pairs": ("pairs_kernel",
                       lambda: hv.pairs_kernel(ptab, x, mu, sigma, ph, g,
                                               bits, pick)),
             "packed-exact forward": (
                 "packed_exact_forward_kernel",
                 lambda: hv.packed_encode_kernel(iw, isc, x, mu, sigma, ih))}
    for what, (name, fn) in calls.items():
        fn()                      # first use (attributes) outside the profile
        ops = device_ops(fn)
        print(f"{what} on the stream: {ops} {tag}")
        check(ops is not None and len(ops) == 1 and name in ops[0]
              and "memset" not in ops[0].lower(),
              (f"{what}: one kernel, no memset or copy", ops))


def device_ops(fn):
    """The names of the device operations (kernels, memsets, copies) that
    one call of fn runs, by torch.profiler; None where the profiler records
    none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return names or None


def index_add_pairs_call(size, idx, val):
    """A backward's pairs added by one library call, ``index_add_``."""
    acc = torch.zeros(size, device=val.device)
    idx = idx.long()
    return lambda: acc.index_add_(0, idx, val)


def variants_phase(work: str, device: torch.device, tag: str, hash_pts,
                   hash_scene):
    """Phase 22: the hash-grid variants through their entry points, then
    their kernels held to their plain versions.  Returns (kernel records by
    name with their launches and shapes, the A/B times)."""
    from human_body_reconstruction_tpu_torch.cli import (
        nerf2mesh, quality_holdout, serve, speedrun, train_hash)

    t0 = time.perf_counter()
    runs = {mode: variant_mode_phase(mode, work, device, tag)
            for mode in VARIANT_MODES}
    launches = {m: r[1] for m, r in runs.items()}
    # the int8 speedrun, capped after its third gate (the grid at 256)
    argv = [*INT8_SPEEDRUN_ARGS, "--device", str(device), "--out",
            f"{work}/speedrun_int8.json"]
    res, launches["speedrun_int8"] = counted(
        variant_wrappers("hash_pack", "packed_forward", "hash_backward"),
        lambda: speedrun.main(argv, log=lambda s: None))
    print(f"speedrun ({' '.join(INT8_SPEEDRUN_ARGS)}): {res['steps']} steps, "
          "gates " + ", ".join(f"step {e['steps']} {e['gate']} {e['gate_db']}"
                               f" dB" for e in res["evals"])
          + f"; crossed {json.dumps(res['crossed'])}; launches "
          f"{launches['speedrun_int8']} {tag}")
    check(len(res["evals"]) == 3 and all(
        math.isfinite(e["gate_db"]) for e in res["evals"]), res["evals"])
    check(all(v > 0 for v in launches["speedrun_int8"].values()),
          launches["speedrun_int8"])
    # train_hash's sorted strategies
    for strategy in ("sorted", "segsum"):
        out_dir = f"{work}/scatter_{strategy}"
        args = ["--synthetic", "--synthetic_subject", "textured",
                "--stochastic", "--hw_rng", "--packed", "--grad_subsample",
                "--scatter_strategy", strategy, "--steps", str(SCATTER_STEPS),
                "--log_every", str(SCATTER_STEPS), "--device", str(device),
                "--out_dir", out_dir, "--model_name", "s"]
        tr, n = counted(variant_wrappers("hash_pairs", "add_sorted",
                                         "packed_forward"),
                        lambda: train_hash.main(args))
        launches[f"train_hash_{strategy}"] = n
        print(f"train_hash --packed --grad_subsample --scatter_strategy "
              f"{strategy}: {tr.state.step} steps, PSNR "
              f"{tr.history[-1]['psnr']:.2f} dB, launches {n} {tag}")
        check(tr.state.step == SCATTER_STEPS and all(
            math.isfinite(r["loss"]) for r in tr.history)
            and all(v >= SCATTER_STEPS for v in n.values()), (strategy, n))
        del tr
    # train_hash --packed_exact: the bf16 words read by the packed-exact
    # forward, one launch a step, the gradient the f32 table's
    args = ["--synthetic", "--synthetic_subject", "textured", "--packed_exact",
            "--steps", str(SCATTER_STEPS), "--log_every", str(SCATTER_STEPS),
            "--device", str(device), "--out_dir", f"{work}/packed_exact",
            "--model_name", "px"]
    t1 = time.perf_counter()
    tr, n = counted(variant_wrappers("hash_pack", "packed_forward",
                                     "hash_backward"),
                    lambda: train_hash.main(args))
    launches["train_hash_packed_exact"] = n
    print(f"train_hash --packed_exact: {tr.state.step} steps, PSNR "
          f"{tr.history[-1]['psnr']:.2f} dB, launches {n}, "
          f"{time.perf_counter() - t1:.1f} s {tag}")
    check(tr.state.step == SCATTER_STEPS and all(
        math.isfinite(r["loss"]) for r in tr.history)
        and all(v >= SCATTER_STEPS for v in n.values()), ("packed_exact", n))
    del tr
    # a frame of the int8 run served through the packed-exact read
    lpair = "int8_dense_guided_k32_mass_lpair"
    server = serve.RenderServer(serve.build_parser().parse_args([
        "--ckpt_dir", f"{work}/{lpair}", "--model_name", lpair,
        "--device", str(device)]))
    resp, launches["serve_int8"] = counted(
        variant_wrappers("hash_pack", "packed_forward"),
        lambda: server.handle({"orbit": {"index": 0, "count": 4},
                               "no_image": True}))
    print(f"served the {lpair} run: {resp.get('wall_s')} s, "
          f"{resp.get('rays_per_sec')} rays/s, launches "
          f"{launches['serve_int8']} {tag}")
    check(resp["ok"] and all(v > 0 for v in launches["serve_int8"].values()),
          (resp, launches["serve_int8"]))
    del server
    # the int8 run meshed: its sweep reads the packed-exact route, a chunk a
    # launch
    stats, launches["sweep_int8"] = counted(
        variant_wrappers("hash_pack", "packed_forward"),
        lambda: nerf2mesh.main([
            "--ckpt_dir", f"{work}/{lpair}", "--model_name", lpair,
            "--resolution", str(INT8_SWEEP_RES), "--cache", "", "--out",
            f"{work}/{lpair}.ply", "--device", str(device)]))
    chunks = INT8_SWEEP_RES ** 3 // SWEEP_CHUNK
    print(f"nerf2mesh of the {lpair} run at {INT8_SWEEP_RES}^3: sweep "
          f"{stats['sweep_seconds']:.3f} s ({chunks} chunks), marching "
          f"{stats['marching_seconds']:.3f} s, {stats['num_faces']} faces; "
          f"launches {launches['sweep_int8']} {tag}")
    check(launches["sweep_int8"]["packed_forward"] == chunks
          and launches["sweep_int8"]["hash_pack"] > 0,
          ("int8 sweep launches", launches["sweep_int8"], chunks))
    runs["data"] = quality_holdout.protocol_data(400, 400, 20, "textured",
                                                 device)
    recs, ab, points, sectors = variant_kernel_checks(hash_pts, hash_scene,
                                                      runs, device, tag)
    del runs
    torch.cuda.empty_cache()
    which = {"hash_pack/bf16_table": "packed_gsub",
             "packed_forward/bf16_train_path": "packed_gsub",
             "hash_backward/bf16_gsub_train_path": "packed_gsub",
             "cell_forward/train_path": "cell",
             "cell_forward/protocol_path": "cell",
             "cell_backward/train_path": "cell",
             "cell_backward/protocol_path": "cell",
             "hash_pack/int8_table": lpair,
             "packed_forward/int8_train_path": lpair,
             "packed_forward/int8_exact_path": "serve_int8",
             "packed_forward/bf16_exact_train_path": "train_hash_packed_exact",
             "packed_forward/int8_exact_sweep_chunk": "sweep_int8",
             "hash_backward/int8_lpair_path": lpair,
             "hash_backward/int8_lvl_path": "int8_dense_guided_lvl",
             "hash_pairs/bf16_gsub_train_path": "train_hash_segsum",
             "add_sorted/sorted_train_path": "train_hash_sorted",
             "add_sorted/segsum_train_path": "train_hash_segsum"}
    report = []
    for key, rec in recs.items():
        nm, run = key.split("/")[0], which[key]
        report.append(entry(
            key, HASH_SOURCE, VARIANT_REPLACES[nm], launches[run][nm], *rec,
            f"{run_shape(key, points)}; launches in the {run} run"))
        if key in sectors:
            report[-1].update(zip(("sectors", "l2_sector_ms"), sectors[key]))
    print(f"hash-variant phase: {time.perf_counter() - t0:.1f} s")
    return report, ab


def run_shape(key: str, points: dict) -> str:
    """The shape of a phase-22 record: ``points`` {"int8_lpair": count,
    "int8_lvl": count, "cell_protocol": count} of the int8 modes' and the
    cell mode's first-pass points."""
    table = " (the table)" if key.startswith("hash_pack") else ""
    if key.endswith("/int8_exact_sweep_chunk"):
        return (f"{SWEEP_CHUNK} lattice points (k fastest) of the middle chunk"
                f" of an {INT8_SWEEP_RES}^3 mesh sweep of the "
                "int8_dense_guided_k32_mass_lpair run, 6 hashed levels, F 4, T "
                "2^16, packed-exact")
    if key.endswith("/protocol_path"):
        return (f"{points['cell_protocol']} first-pass points of a "
                f"{PROTOCOL_RAYS}-ray batch of cell (128 samples a ray), L "
                f"16, F 2, T 2^16")
    if "int8" not in key:
        return (f"{HASH_POINTS} points of a hash-grid training step (16000 "
                f"rays x 64 samples), L 16, F 2, T 2^16{table}")
    kind = "int8_lvl" if key.endswith("lvl_path") else "int8_lpair"
    mode = ("int8_dense_guided_lvl" if kind == "int8_lvl"
            else "int8_dense_guided_k32_mass_lpair")
    return (f"{points[kind]} first-pass points of a {PROTOCOL_RAYS}-ray batch "
            f"of {mode} (guided placement), 6 hashed levels, F 4, T "
            f"2^16{table}")


# the parallel slice (PR 12): the world-1 NCCL data-parallel runs (the
# flagship cut to DP_STEPS with its warmup at DP_WARMUP, and the hash grid),
# the world-1 level-parallel steps, the level and rank shards of LP_EXTENTS,
# the sample-split render of a 400x400 frame at 1024 samples, and
# multi-scene fitting
DP_STEPS, DP_WARMUP, DP_HASH_STEPS = 48, 16, 16
LP_EXTENTS = (2, 4)
LP_CP_RANK = 32                 # the speedrun's rank, which 2 and 4 divide
LP_CP_TV = 1e-2                 # the speedrun's factor-line TV weight
SP_HW, SP_SAMPLES, SP_SEGMENTS, SP_CHUNK = 400, 1024, (2, 4, 8), 1024
SP_TOL = 1e-5
MS_SCENES, MS_STEPS = 2, 4
# multi-scene vs single-scene runs: the float-atomic backwards make the two
# runs' steps after the first differ, as CONT_LOSS_RTOL's do (a parameter
# group within 7.6e-5 to 1.29e-4 of its norm after 4 steps on the card);
# the group limit sits below what one skipped update moves a group, which
# the check reads in the same run and holds above it
MS_LOSS_RTOL, MS_PARAM_RTOL = 1e-3, 5e-4


def parallel_cli(argv, kernels, work: str, name: str, tag: str):
    """``train_hash --data_parallel`` through its ``main`` (a world of one:
    NCCL in this process), the kernels' launch counts reset just before.
    Returns (trainer, launches)."""
    import torch.distributed as dist

    from human_body_reconstruction_tpu_torch.cli import train_hash

    t0 = time.perf_counter()
    trainer, launches = counted(kernels, lambda: train_hash.main([
        "--synthetic", "--synthetic_subject", "textured", "--device", "cuda",
        "--data_parallel", "--out_dir", f"{work}/{name}", "--model_name",
        name, *argv]))
    sec = time.perf_counter() - t0
    check(trainer is not None and trainer.mesh.shape == (1, 1)
          and trainer._step_fn is not None,
          "--data_parallel ran the data-parallel step in a world of one")
    check(not dist.is_initialized(), "the CLI left its NCCL world")
    hist = trainer.history
    check(all(math.isfinite(r["loss"]) for r in hist), "finite losses")
    check(all(n > 0 for n in launches.values()), (name, launches))
    print(f"parallel {name}: train_hash --data_parallel {' '.join(argv)}: "
          f"{trainer.state.step} steps in {sec:.2f} s (dataset render "
          f"included), PSNR {hist[0]['psnr']:.2f} dB (step {hist[0]['step']})"
          f" -> {hist[-1]['psnr']:.2f} dB (step {hist[-1]['step']}), "
          f"{hist[-1]['rays_per_sec']:.1f} rays/s at the last log; launches "
          f"{launches} {tag}")
    return trainer, launches


def clone_state(state, cfg, total: int):
    """A copy of a single-device train state: field, Adam moments, step,
    grid."""
    from human_body_reconstruction_tpu_torch.train import state as state_lib

    field = copy.deepcopy(state.field)
    st = state_lib.create_train_state(field, cfg.train, total, occ=state.occ)
    for p, q in zip(state.field.parameters(), field.parameters()):
        st.opt.set_moments(q, state.step, *state.opt.moments(p))
    st.step = state.step
    return st


@contextlib.contextmanager
def nccl_world():
    """A world of one on NCCL in this process, left on exit."""
    import torch.distributed as dist

    from human_body_reconstruction_tpu_torch.parallel import comm

    rdzv = tempfile.mkdtemp()
    comm.init("cuda", rank=0, world_size=1,
              init_method=f"file://{rdzv}/rendezvous")
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdzv, ignore_errors=True)


def backward_sites():
    """{backward kernel: (module, attribute)}: where the encoder's backward
    looks each wrapper up."""
    from human_body_reconstruction_tpu_torch.ops import (
        cp_kernel, dense_kernel, hash_kernel)

    return {"cp_backward": (cp_kernel, "cp_encode_backward_kernel"),
            "dense_backward": (dense_kernel, "dense_encode_backward_kernel"),
            "hash_backward": (hash_kernel, "hash_encode_backward_kernel")}


def recorded_plain(nm, args, kw, grad):
    """The plain version of a recorded backward call on cotangent ``grad``:
    a list of table gradients."""
    from human_body_reconstruction_tpu_torch.ops import hash_kernel

    if nm == "hash_backward":
        table, x, mu, sigma, h = args[:5]
        bits = args[6] if len(args) > 6 else kw.get("bits")
        return [hash_kernel.hash_encode_plain_backward(
            table, x, mu, sigma, h, grad, bits=bits, scales=kw.get("scales"))]
    tables, x, mu, sigma, h = args[:5]
    return list(plain_backward(nm)(tables, x, mu, sigma, h, grad))


def step_vs_single(label, states, single_fn, par_fn, kernels, tag):
    """One step of ``par_fn`` (a parallel step, on a world-1 NCCL group)
    against ``single_fn`` (``train_step``) from the same generator states,
    each on its own copy of one train state: ``states`` = (single,
    replayed, launched).  The backward kernels ``kernels`` add in float
    atomics, so two runs of one step differ in those sums' last bits: the
    replayed parallel step is handed the single-device step's backward-kernel
    results (after checking that its cotangents into them are the same bit
    for bit), and then every metric, gradient and updated parameter must be
    the same bit for bit; the launched one launches its kernels, and its
    metrics, MLP gradients and MLP parameters must be the same bit for bit,
    its cotangents into the backward kernels too, and each kernel's sums,
    like the single-device step's, within the sum-order tolerance of the
    plain sums.  Returns the metrics of the launched step."""
    from human_body_reconstruction_tpu_torch.ops import cuda_lib

    sites = backward_sites()
    originals = {nm: getattr(*sites[nm]) for nm in kernels}
    taken, launched, replayed = [], [], []

    def install(make):
        for nm in kernels:
            setattr(*sites[nm], make(nm))

    def clones(out):
        return ([o.clone() for o in out] if isinstance(out, (list, tuple))
                else out.clone())

    def recording(sink):
        def make(nm):
            def spy(*args, **kw):
                out = originals[nm](*args, **kw)
                # the tables as the kernel read them: the update overwrites
                kept = (clones(args[0]), *args[1:])
                sink.append((nm, kept, kw, args[5].clone(), clones(out)))
                return out
            spy.launches = 0    # the wrapper counts on its module's name
            return spy
        return make

    def replaying(nm):
        queue = [r for r in taken if r[0] == nm]

        def spy(*args, **kw):
            rec = queue.pop(0)
            replayed.append(torch.equal(args[5], rec[3]))
            return clones(rec[4])
        spy.launches = 0
        return spy

    single_st, replay_st, par_st = states
    try:
        install(recording(taken))
        single = single_fn(single_st)
        install(replaying)
        replay = par_fn(replay_st)
        install(recording(launched))
        par = par_fn(par_st)
    finally:
        for nm, fn in originals.items():
            setattr(*sites[nm], fn)
    torch.cuda.synchronize()

    def same(a, b):
        return len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))

    check(sorted(r[0] for r in taken) == sorted(kernels)
          and len(replayed) == len(kernels) and all(replayed)
          and [r[0] for r in launched] == [r[0] for r in taken]
          and all(torch.equal(a[3], b[3]) for a, b in zip(taken, launched)),
          (f"{label}: one call of each backward kernel, its cotangents bit "
           "for bit", [r[0] for r in taken], replayed,
           [r[0] for r in launched]))
    params = [list(st.field.parameters())
              for st in (single_st, replay_st, par_st)]
    for name, other in (("replayed", replay), ("launched", par)):
        check(set(single) == set(other)
              and all(torch.equal(single[k], other[k]) for k in single),
              (f"{label}: {name} step's metrics bit for bit", single, other))
    check(same([p.grad for p in params[0]], [p.grad for p in params[1]])
          and same(params[0], params[1]),
          f"{label}: given the same kernel sums, every gradient and updated "
          "parameter bit for bit")
    mlp = [list(st.field.mlp.parameters()) for st in (single_st, par_st)]
    check(same([p.grad for p in mlp[0]], [p.grad for p in mlp[1]])
          and same(*mlp),
          f"{label}: launched, the MLP's gradients and updated parameters "
          "bit for bit")
    ratio = 0.0
    with torch.no_grad():
        for (nm, args, kw, grad, out), rec in zip(taken, launched):
            want = recorded_plain(nm, args, kw, grad)
            tabs = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
            abs_sum = recorded_plain(
                nm, ([t.abs() for t in tabs] if nm != "hash_backward"
                     else args[0], *args[1:]), kw, grad.abs())
            bf16 = nm != "hash_backward" and args[4].dense_bf16
            for got in (out, rec[4]):
                got = got if isinstance(got, list) else [got]
                for g_i, w_i, a_i in zip(got, want, abs_sum):
                    tol = cuda_lib.sum_order_tolerance(w_i, a_i, bf16)
                    ratio = max(ratio, float(((g_i - w_i).abs()
                                              / tol).max()))
    print(f"parallel {label} step: world-1 NCCL vs train_step from one "
          f"generator state: loss {float(par['loss']):.6f}; given the "
          f"single-device step's backward-kernel sums "
          f"({', '.join(kernels)}), every metric, gradient and updated "
          f"parameter bit for bit; launching its own, metrics and MLP "
          f"gradients and parameters bit for bit, the backward kernels' sums "
          f"of both steps at worst |err| / sum-order tolerance of the plain "
          f"sums {ratio:.3f} (tol 1) {tag}")
    check(ratio <= 1.0, (f"{label}: backward kernel sums of the two steps",
                         ratio))
    return par


def dp_step_vs_single(trainer, device, tag):
    """One step of the trained flagship through the data-parallel step on a
    world-1 NCCL group against ``train_step`` on a copy, from the same
    generator state (``step_vs_single``); the group's all-reduce must leave
    a gradient bit for bit."""
    from human_body_reconstruction_tpu_torch.parallel import comm
    from human_body_reconstruction_tpu_torch.parallel import data_parallel as dp
    from human_body_reconstruction_tpu_torch.train import step

    cfg, ds, B = trainer.cfg, trainer.ds, trainer.cfg.train.ray_batch
    data = (trainer.scene, ds["images"], ds["c2ws"], ds["K"])
    states = tuple(clone_state(trainer.state, cfg, trainer.total_steps)
                   for _ in range(3))

    def gen():
        return torch.Generator(device).manual_seed(SEED + 9)

    with nccl_world():
        mesh = dp.make_mesh()
        dp_step = dp.make_dp_train_step(cfg, B, mesh)
        step_vs_single(
            "data-parallel", states,
            lambda st: step.train_step(st, *data, cfg, B, gen()),
            lambda st: dp_step(st, *data, generator=gen()),
            ("cp_backward", "dense_backward"), tag)
        grads = [p.grad.clone() for p in states[0].field.parameters()]
        reduced = [g.clone() for g in grads]
        comm.all_reduce_mean_(reduced, mesh.data_group, 1)
        torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(reduced, grads)),
          "the world-1 NCCL all-reduce leaves the gradient bit for bit")


def lp_steps_vs_single(hash_tr, flag, device, tag):
    """``make_lp_train_step`` on a world-1 NCCL (1, 1) layout, which runs
    the level-parallel encode (``encode_params`` with a shard: the group's
    ``gather_cols`` and, for CP, the block reorder) and the TV's
    ``psum_replicated``, against ``train_step`` (``step_vs_single``): the
    hash grid (``--stochastic --hw_rng``) from its trained state, the
    encoder's uniforms drawn from one generator on both sides; and the
    ``--cp_rank 32`` ladder at the flagship's width from a seeded field
    with the speedrun's TV on, on the flagship's grid."""
    from human_body_reconstruction_tpu_torch.models import nerf
    from human_body_reconstruction_tpu_torch.parallel import level_parallel as lp
    from human_body_reconstruction_tpu_torch.train import state as state_lib
    from human_body_reconstruction_tpu_torch.train import step

    fc = flag.cfg
    cfg32 = dataclasses.replace(
        fc, hash=dataclasses.replace(fc.hash, cp_rank=LP_CP_RANK),
        train=dataclasses.replace(fc.train, cp_tv_weight=LP_CP_TV,
                                  cp_tv_warmup=0))
    st32 = state_lib.create_train_state(
        nerf.Field(cfg32, generator=torch.Generator(device).manual_seed(
            SEED + 15)), cfg32.train, flag.total_steps, occ=flag.state.occ)
    runs = (("hash grid", hash_tr, hash_tr.cfg, hash_tr.state,
             hash_tr.total_steps, ("hash_backward",)),
            (f"cp_rank {LP_CP_RANK}", flag, cfg32, st32, flag.total_steps,
             ("cp_backward", "dense_backward")))

    def gens():
        return (torch.Generator(device).manual_seed(SEED + 16),
                torch.Generator(device).manual_seed(SEED + 17))

    with nccl_world():
        mesh = lp.make_lp_mesh(1, 1)
        for name, tr, cfg, base, total, kernels in runs:
            B, ds = cfg.train.ray_batch, tr.ds
            data = (tr.scene, ds["images"], ds["c2ws"], ds["K"])
            lp_step = lp.make_lp_train_step(cfg, B, mesh)
            single, *rest = (clone_state(base, cfg, total) for _ in range(3))
            rest = [lp.shard_lp_state(st, cfg, mesh, total) for st in rest]
            check(all(st.field.lp is not None and st.field.lp.extent == 1
                      for st in rest), (name, "a level shard of extent 1"))

            def single_fn(st):
                g, e = gens()
                return step.train_step(st, *data, cfg, B, g, e)

            def par_fn(st):
                g, e = gens()
                return lp_step(st, *data, generator=g, enc_generator=e)

            m = step_vs_single(f"level-parallel {name}", (single, *rest),
                               single_fn, par_fn, kernels, tag)
            if cfg.hash.variant == "cp":
                check(float(m["cp_tv"]) > 0.0, "the TV entered the step")


def shard_records(device, tag, hash_trainer, flag_trainer):
    """The level and rank shards at extents LP_EXTENTS: the k level ranks'
    encodes run one after another on the card through
    ``hash_encoding.encode_params`` (a shard without a gather: each rank's
    own columns), joined by ``hash_encoding.join_level_blocks`` as the
    group's gather joins them, and differentiated through the join: the hash
    grid's levels on the hash path's 1,024,000 points (exact, and
    stochastic with each rank's uniforms from a generator of its own,
    Philox at (3, L/k, N)), the ``--cp_rank 32`` ladder's rank columns
    (dense levels beside them) on the flagship's 768,000 guided points.
    The launches of each drive are counted from 0 just before it.  The
    joined forward equals the unsharded kernel's (given the ranks'
    uniforms) bit for bit; the joined backward, like the unsharded
    kernel's, is within the sum-order tolerance of the plain sums.  Each
    shard shape's kernels against their plain versions, timed (the first
    shard).  Returns the kernel records {name: (record, launches,
    shape)}."""
    from human_body_reconstruction_tpu_torch.ops import (
        cp_kernel, cuda_lib, hash_encoding, hash_kernel, rng_kernel)
    from human_body_reconstruction_tpu_torch.utils.config import fine_scales

    he = hash_encoding
    out = {}
    # the hash grid's level shards
    h, scene = hash_trainer.cfg.hash, hash_trainer.scene
    h_lp = dataclasses.replace(h, level_axis="level")
    field = hash_trainer.state.field
    table = field.table.detach()
    dense = [t.detach() for t in field.dense]
    L, F = h.num_hashed_levels, h.features_per_level
    d = len(dense) * F
    pts = hash_path_points(hash_trainer, device)
    n = pts.shape[0]
    mu, sigma = scene["mu"], scene["sigma"]
    gen = torch.Generator(device).manual_seed(SEED + 11)
    g = torch.randn((n, L * F + 3), generator=gen, device=device)[:, 3:]
    g_full = torch.cat([torch.zeros((n, d), device=device), g], dim=1)
    a = (pts, mu, sigma, h)
    scales = fine_scales(h)
    hash_kernels = wrappers("uniform_bits", "hash_forward", "hash_backward")
    for k in LP_EXTENTS:
        per = L // k
        worst, drive_launches = 0.0, {nm: 0 for nm, _ in hash_kernels}
        for m in ("exact", "stochastic"):
            stoch = m == "stochastic"
            parts = [table[i * per:(i + 1) * per].clone().requires_grad_()
                     for i in range(k)]
            gens = [torch.Generator(device).manual_seed(SEED + 30 + i)
                    for i in range(k)]
            replays = []
            for gn in gens:
                rg = torch.Generator(device)
                rg.set_state(gn.get_state())
                replays.append(rg)

            def drive():
                outs = [he.encode_params(
                    {"dense": dense, "table": parts[i]}, pts, mu, sigma, h_lp,
                    stochastic=stoch, generator=gens[i],
                    shard=he.LevelShard(k, scales[i * per:(i + 1) * per]))
                    for i in range(k)]
                joined = he.join_level_blocks(
                    outs[0][:, :d], torch.cat([o[:, d:] for o in outs], 1),
                    0, k)
                return (joined.detach(),
                        torch.autograd.grad(joined, parts, g_full))

            (joined, grads), launches = counted(hash_kernels, drive)
            for nm, c in launches.items():
                drive_launches[nm] += c
            with torch.no_grad():
                u = (torch.cat([he.stoch_uniform((3, per, n), h, device, rg)
                                for rg in replays], dim=1) if stoch else None)
                res = hash_kernel.hash_encode_kernel(table, *a, u=u)
                ref, bits = (res, None) if u is None else res
                check(torch.equal(joined[:, d:], ref), (
                    "hash level shards' joined features bit for bit", k, m))
                plain_b = hash_kernel.hash_encode_plain_backward(
                    table, *a, g, bits=bits)
                abs_b = hash_kernel.hash_encode_plain_backward(
                    table, *a, g.abs(), bits=bits)
                tol = cuda_lib.sum_order_tolerance(plain_b, abs_b, False)
                worst = max(worst, float(((torch.cat(grads) - plain_b).abs()
                                          / tol).max()))
        print(f"parallel level shards k={k}: {k} x {per} hash levels on {n} "
              f"hash path points through encode_params, exact and "
              f"stochastic (each rank's own uniforms): joined features bit "
              f"for bit with the unsharded kernel's; joined table gradient "
              f"worst |err| / sum-order tolerance {worst:.3f} (tol 1); "
              f"launches in the serial drive {drive_launches} {tag}")
        check(worst <= 1.0, ("hash level shards' gradient", k, worst))
        check(drive_launches == {"uniform_bits": k, "hash_forward": 2 * k,
                                 "hash_backward": 2 * k},
              ("the level shards' drive launched each rank's kernels", k,
               drive_launches))
        lv = slice(0, per)
        h_k = dataclasses.replace(h, num_levels=per)
        kind = f"level_shard_k{k}"
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                             device=device, dtype=torch.int32)
        u_k = rng_kernel.uniform(seed, (3, per, n))
        fwd = bwd = None
        for uu in (None, u_k):
            f_rec, b_rec = hash_mode_check(
                table[lv], pts, scene, h_k, g[:, :per * F].contiguous(), uu,
                kind, tag, scales=scales[lv])
            fwd = f_rec if fwd is None else (max(fwd[0], f_rec[0]),
                                             *f_rec[1:])
            bwd = b_rec if bwd is None else (max(bwd[0], b_rec[0]),
                                             *b_rec[1:])
        drive = (f"launches: the serial drive of the {k} level ranks' "
                 "encodes (exact and stochastic, forward and backward) "
                 "through encode_params, counted from 0 just before it; no "
                 f"one-card step runs this shape (--level_parallel {k} "
                 f"takes {k} cards)")
        shape = (f"{n} hash path points (16000 rays x 64), a level rank's "
                 f"{per} of 16 levels (--level_parallel {k} with "
                 f"--stochastic --hw_rng), stochastic; {drive}")
        out[f"hash_forward/{kind}"] = (fwd, drive_launches["hash_forward"],
                                       shape)
        out[f"hash_backward/{kind}"] = (bwd, drive_launches["hash_backward"],
                                        shape)
        shp = (3, per, n)
        bits_k = rng_kernel.uniform_bits(seed, shp)
        same = torch.equal(bits_k, rng_kernel.uniform_plain(seed, shp,
                                                            False))
        ms = time_ms(lambda: rng_kernel.uniform(seed, shp))
        plain_ms = time_ms(lambda: rng_kernel.uniform_plain(seed, shp),
                           reps=5)
        lib_ms = time_ms(lambda: torch.rand(shp, device=device))
        bnd = bound(nbytes(seed, u_k), u_k.numel() * PHILOX_OPS_PER_VALUE,
                    INT32_OPS_PER_S)
        print(f"kernel uniform_bits: a level rank's {shp}, bit for bit "
              f"{same}, {ms:.4f} ms vs plain {plain_ms:.4f} ms, torch.rand "
              f"{lib_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) {tag}")
        check(same, ("Philox at a level rank's shape", k))
        out[f"uniform_bits/{kind}"] = (
            (0.0, ms, plain_ms, lib_ms, bnd), drive_launches["uniform_bits"],
            f"{shp}: a level rank's draw (--level_parallel {k}); {drive}")
        del bits_k, u_k
    torch.cuda.empty_cache()

    # the --cp_rank 32 ladder's rank shards
    h32 = dataclasses.replace(flag_trainer.cfg.hash, cp_rank=LP_CP_RANK)
    h32_lp = dataclasses.replace(h32, level_axis="level")
    scene = flag_trainer.scene
    mu, sigma = scene["mu"], scene["sigma"]
    dense = [t.detach() for t in flag_trainer.state.field.dense]
    d = len(dense) * h32.features_per_level
    pts = training_path_points(flag_trainer, device)["guided"]
    n, R = pts.shape[0], LP_CP_RANK
    gen = torch.Generator(device).manual_seed(SEED + 12)
    lines = [torch.empty((3, g_l, R), device=device).uniform_(
        -0.6, 0.6, generator=gen) for g_l in
        cp_kernel.cp_line_sizes(h32)]
    n_lv = len(lines)
    g = torch.randn((n, n_lv * R), generator=gen, device=device)
    g_full = torch.cat([torch.zeros((n, d), device=device), g], dim=1)
    a = (pts, mu, sigma)
    cp_kernels = wrappers("cp_forward", "dense_forward", "cp_backward")
    with torch.no_grad():
        whole = he.encode_params({"dense": dense, "lines": lines}, *a, h32)
        plain_b = cp_kernel.cp_encode_plain_backward(lines, *a, h32, g)
        abs_b = cp_kernel.cp_encode_plain_backward(
            [t.abs() for t in lines], *a, h32, g.abs())
    for k in LP_EXTENTS:
        rl = R // k
        h_k = dataclasses.replace(h32, cp_rank=rl)
        parts = [[ln[..., i * rl:(i + 1) * rl].contiguous().requires_grad_()
                  for ln in lines] for i in range(k)]

        def drive():
            outs = [he.encode_params({"dense": dense, "lines": parts[i]}, *a,
                                     h32_lp, shard=he.LevelShard(k))
                    for i in range(k)]
            joined = he.join_level_blocks(
                outs[0][:, :d], torch.cat([o[:, d:] for o in outs], 1), n_lv,
                k)
            return joined.detach(), torch.autograd.grad(
                joined, [p for part in parts for p in part], g_full)

        (joined, grads), launches = counted(cp_kernels, drive)
        check(torch.equal(joined, whole),
              ("CP rank shards' joined features bit for bit", k))
        check(launches == {"cp_forward": k, "dense_forward": k,
                           "cp_backward": k},
              ("the rank shards' drive launched each rank's kernels", k,
               launches))
        worst = 0.0
        with torch.no_grad():
            for lvl in range(n_lv):
                gj = torch.cat([grads[i * n_lv + lvl] for i in range(k)],
                               dim=-1)
                tol = cuda_lib.sum_order_tolerance(plain_b[lvl], abs_b[lvl],
                                                   h32.dense_bf16)
                worst = max(worst, float(((gj - plain_b[lvl]).abs()
                                          / tol).max()))
        print(f"parallel rank shards k={k}: {k} x {rl} of rank {R} on {n} "
              f"guided points ({n_lv} CP levels, C {n_lv * rl} a rank) "
              f"through encode_params: joined features (dense columns "
              f"beside them) bit for bit with the unsharded encode's; joined "
              f"line gradient worst |err| / sum-order tolerance {worst:.3f} "
              f"(tol 1); launches in the serial drive {launches} {tag}")
        check(worst <= 1.0, ("CP rank shards' gradient", k, worst))
        part = [ln[..., :rl].contiguous() for ln in lines]
        kind = f"rank_shard_k{k}"
        f_rec = forward_check("cp_forward", part, pts, scene, h_k,
                              matrix=False, tol=FWD_TOL["cp_forward"],
                              label=f"guided points, a rank shard of {rl} "
                              "columns", tag=tag)
        b_rec = backward_check(
            "cp_backward", part, pts, scene, h_k,
            g.reshape(n, n_lv, R)[..., :rl].reshape(n, n_lv * rl),
            f"guided points, a rank shard of {rl} columns", tag)
        shape = (f"{n} guided points (16000 rays x 48), a level rank's {rl} "
                 f"of rank {R} over {n_lv} CP levels (C {n_lv * rl}; "
                 f"--level_parallel {k} --cp_rank {R}); launches: the serial "
                 f"drive of the {k} level ranks' encodes (forward and "
                 "backward) through encode_params, counted from 0 just "
                 f"before it; no one-card step runs this shape "
                 f"(--level_parallel {k} takes {k} cards)")
        out[f"cp_forward/{kind}"] = (f_rec, launches["cp_forward"], shape)
        out[f"cp_backward/{kind}"] = (b_rec, launches["cp_backward"], shape)
    return out


def sample_split_check(device, tag):
    """The sample-split render's algebra on the card: a 400x400 frame at
    SP_SAMPLES samples (density mode with occupancy and a white background,
    SDF mode with occupancy, flagship width, seeded weights), its
    SP_SEGMENTS segmentings rendered one segment after another and
    combined (``render_segments``) against the one-pass render of the same
    rays, within SP_TOL."""
    from human_body_reconstruction_tpu_torch.data.synthetic import orbit_poses
    from human_body_reconstruction_tpu_torch.models import nerf
    from human_body_reconstruction_tpu_torch.ops import occupancy, rays
    from human_body_reconstruction_tpu_torch.parallel import sample_parallel as sp
    from human_body_reconstruction_tpu_torch.utils import config as C

    base = C.flagship_config()
    base = dataclasses.replace(base, render=dataclasses.replace(
        base.render, eval_guided=0, log_sampling=False))
    f, c = float(SP_HW), SP_HW / 2.0
    K = torch.tensor([[f, 0, c], [0, f, c], [0, 0, 1]], device=device)
    poses = torch.as_tensor(orbit_poses(4), device=device)
    lo, hi = rays.scene_bounds(SP_HW, SP_HW, K, poses, base.render.near,
                               base.render.far)
    scene = nerf.scene_from_bounds(lo, hi)
    g = base.render.occupancy_resolution
    c = (torch.arange(g, device=device) + 0.5) / g
    cells = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1)
    mask = (torch.linalg.vector_norm(lo + cells * scene["sigma"], dim=-1)
            < 1.2).to(torch.float32)
    occ = occupancy.OccupancyGrid(mask, mask, torch.tensor(0.01,
                                                           device=device))
    o, d, dn = (t.reshape(-1, t.shape[-1]) for t in rays.full_image_rays(
        SP_HW, SP_HW, K, poses[1]))
    for mode in ("density", "sdf"):
        cfg = dataclasses.replace(
            base, mlp=dataclasses.replace(
                base.mlp, density_activation="sdf" if mode == "sdf"
                else base.mlp.density_activation),
            render=dataclasses.replace(base.render, use_sdf=mode == "sdf",
                                       white_background=mode == "density"))
        gen = torch.Generator().manual_seed(SEED + 13)
        field = nerf.Field(cfg, generator=gen)
        with torch.no_grad():
            for t in field.dense:
                t.mul_(5000.0)
            for ln in field.lines:
                ln.mul_(6.0)
            field.mlp.sig[-1].bias[0] += 2.0
            if field.var_b is not None:
                field.var_b.fill_(8.0)
        field.to(device)
        errs = {n: 0.0 for n in SP_SEGMENTS}
        t0 = time.perf_counter()
        img = []
        with torch.no_grad():
            for s in range(0, o.shape[0], SP_CHUNK):
                args = (o[s:s + SP_CHUNK], d[s:s + SP_CHUNK],
                        dn[s:s + SP_CHUNK])
                one = nerf.render_rays(field, scene, *args, cfg,
                                       num_samples=SP_SAMPLES, occ=occ)["fine"]
                img.append(one)
                for n in SP_SEGMENTS:
                    seg = sp.render_segments(field, scene, *args, cfg,
                                             SP_SAMPLES, n, occ=occ)
                    errs[n] = max(errs[n], float((seg - one).abs().max()))
        torch.cuda.synchronize()
        img = torch.cat(img)
        print(f"parallel sample split ({mode}): {SP_HW}x{SP_HW} frame x "
              f"{SP_SAMPLES} samples, segments {SP_SEGMENTS} rendered one "
              f"after another and combined vs one pass: max_abs_err "
              + ", ".join(f"n={n} {e:.2e}" for n, e in errs.items())
              + f" (tol {SP_TOL:g}); frame range [{float(img.min()):.4f}, "
              f"{float(img.max()):.4f}]; {time.perf_counter() - t0:.2f} s "
              f"{tag}")
        check(bool(torch.isfinite(img).all()) and float(img.std()) > 1e-3,
              ("sample-split frame finite, not blank", mode))
        check(max(errs.values()) <= SP_TOL, ("sample split", mode, errs))


def multi_scene_check(flag_trainer, device, tag):
    """MS_SCENES flagship-width fields (seeded apart) fitted together for
    MS_STEPS unculled steps by ``multi_scene.make_multi_train_step`` (one
    grouped optimizer, a loop of launches) against each scene's own
    single-scene ``train_step`` run from the same generator: the first
    step's losses bit for bit, every step's mean loss within MS_LOSS_RTOL,
    each parameter group after within MS_PARAM_RTOL of its norm, a limit
    below what each group's last update moves it in the single-scene runs
    (the reading of a fault that skips it).  Returns the encoder kernels'
    launches in the multi-scene run."""
    from human_body_reconstruction_tpu_torch.models import nerf
    from human_body_reconstruction_tpu_torch.parallel import multi_scene as ms
    from human_body_reconstruction_tpu_torch.train import state as state_lib
    from human_body_reconstruction_tpu_torch.train import step
    from human_body_reconstruction_tpu_torch.utils.observability import (
        param_groups)

    cfg = dataclasses.replace(flag_trainer.cfg, render=dataclasses.replace(
        flag_trainer.cfg.render, occupancy=False))
    ds, scene, B = flag_trainer.ds, flag_trainer.scene, cfg.train.ray_batch
    gen = torch.Generator(device).manual_seed(SEED + 14)
    fields = [nerf.Field(cfg, generator=gen) for _ in range(MS_SCENES)]
    data = [ds["images"]] * MS_SCENES, [ds["c2ws"]] * MS_SCENES, \
        [ds["K"]] * MS_SCENES
    multi = ms.create_multi_state([copy.deepcopy(f) for f in fields], cfg,
                                  MS_STEPS)
    step_fn = ms.make_multi_train_step(cfg, B)
    gens = [torch.Generator(device).manual_seed(SEED + 20 + s)
            for s in range(MS_SCENES)]

    def run_multi():
        return [step_fn(multi, [scene] * MS_SCENES, *data, gens)["loss"]
                for _ in range(MS_STEPS)]

    t0 = time.perf_counter()
    m_losses, launches = counted(wrappers(*TRAIN_KERNELS), run_multi)
    sec = time.perf_counter() - t0
    def rel_norm(ps, qs):
        num = sum(float(((p - q) ** 2).sum().detach()) for p, q in zip(ps, qs))
        return math.sqrt(num / sum(float((p ** 2).sum().detach())
                                   for p in ps))

    singles, skipped = [], {}
    for s in range(MS_SCENES):
        st = state_lib.create_train_state(copy.deepcopy(fields[s]), cfg.train,
                                          MS_STEPS)
        g_s = torch.Generator(device).manual_seed(SEED + 20 + s)
        losses = []
        for i in range(MS_STEPS):
            if i == MS_STEPS - 1:       # a fault's reading: the last update
                before = {key: [p.detach().clone() for p in ps] for key, ps
                          in param_groups(st.field).items()}
            losses.append(step.train_step(st, scene, ds["images"],
                                          ds["c2ws"], ds["K"], cfg, B,
                                          g_s)["loss"])
        for key, ps in param_groups(st.field).items():
            skipped[key] = min(skipped.get(key, math.inf),
                               rel_norm(ps, before[key]))
        singles.append((st, losses))
    torch.cuda.synchronize()
    means = [torch.stack([ls[i] for _, ls in singles]).mean()
             for i in range(MS_STEPS)]
    rel = [abs(float(a) / float(b) - 1.0) for a, b in zip(m_losses, means)]
    worst = max(rel_norm(ps, param_groups(f)[key])
                for (st, _), f in zip(singles, multi.fields)
                for key, ps in param_groups(st.field).items())
    print(f"parallel multi-scene: {MS_SCENES} flagship-width scenes, "
          f"{MS_STEPS} unculled steps of {B} rays each in {sec:.2f} s "
          f"({1e3 * sec / MS_STEPS:.2f} ms/step); vs single-scene runs: "
          f"first step's mean loss bit for bit "
          f"{torch.equal(m_losses[0], means[0])}, worst loss rel "
          f"{max(rel):.2e} (tol {MS_LOSS_RTOL:g}), worst parameter group "
          f"rel {worst:.2e} (tol {MS_PARAM_RTOL:g}; a group's last update, "
          f"which a skipped one would leave out, moves it "
          + ", ".join(f"{k} {v:.2e}" for k, v in skipped.items())
          + f"); launches {launches} {tag}")
    check(torch.equal(m_losses[0], means[0]), "multi-scene first step")
    check(max(rel) <= MS_LOSS_RTOL and worst <= MS_PARAM_RTOL,
          ("multi-scene vs single-scene runs", rel, worst))
    check(MS_PARAM_RTOL < min(skipped.values()),
          ("a skipped update would pass the group limit", skipped))
    check(all(n > 0 for n in launches.values()), launches)
    return launches


def parallel_phase(work: str, device: torch.device, tag: str):
    """The parallel slice on the one card: (a) ``train_hash
    --data_parallel`` at the flagship's full width and with ``--stochastic
    --hw_rng``, each a world of one on NCCL, one data-parallel step and the
    level-parallel steps (hash grid, ``--cp_rank 32``) on a world of one
    against ``train_step``; (b) the level and rank shards; (c) the
    sample-split render; (d) multi-scene fitting.  Returns the shard
    shapes' kernel records and the launches of each run."""
    flag, flag_launches = parallel_cli(
        ["--steps", str(DP_STEPS), "--occ_warmup", str(DP_WARMUP),
         "--log_every", "16"], wrappers(*TRAIN_KERNELS), work, "dp_flagship",
        tag)
    cfg = flag.cfg
    check((cfg.hash.num_levels, cfg.hash.n_max, cfg.hash.cp_rank,
           cfg.hash.dense_levels, cfg.train.ray_batch)
          == (7, 1448, 25, 2, 16000) and flag.state.occ is not None,
          "the flagship at full width, past its warmup")
    hash_tr, hash_launches = parallel_cli(
        ["--stochastic", "--hw_rng", "--steps", str(DP_HASH_STEPS),
         "--log_every", "8"],
        wrappers("uniform_bits", "hash_forward", "hash_backward"), work,
        "dp_hash", tag)
    dp_step_vs_single(flag, device, tag)
    lp_steps_vs_single(hash_tr, flag, device, tag)
    records = shard_records(device, tag, hash_tr, flag)
    del hash_tr
    torch.cuda.empty_cache()
    sample_split_check(device, tag)
    ms_launches = multi_scene_check(flag, device, tag)
    return records, {"dp_flagship": flag_launches, "dp_hash": hash_launches,
                     "multi_scene": ms_launches}


# the one-dispatch paths: windows of steps as replays of one
# captured step, the fused frame and pose batch
WINDOW_STEPS = {"guided": 25, "unculled": 25, "hash": 8, "dp_guided": 25,
                "lp_hash": 8, "lp_cp32": 8}
WINDOW_TRAINER_STEPS = 50       # Trainer.run with steps_per_call 25 (flagship)
WINDOW_HASH_TRAINER_STEPS = 16  # and with 8 (the hash grid)
SPEEDRUN_WINDOW = 25
PW_CLI_WINDOW = 25              # train_hash --data_parallel --steps_per_call


def snapshot(st, gen) -> dict:
    """A train state's parameters, moments, count, grid and its generator's
    state, copied."""
    return {"params": [p.detach().clone() for p in st.field.parameters()],
            "moments": [m.clone() for g in st.opt.groups
                        for m in (*g.exp_avg, *g.exp_avg_sq)],
            "step": st.step, "gen": gen.get_state(),
            "occ": None if st.occ is None else [x.clone() for x in st.occ]}


@torch.no_grad()
def restore_into(st, gen, snap: dict):
    """Write a snapshot into a train state's own tensors (the addresses a
    captured step reads) and its generator."""
    for p, q in zip(st.field.parameters(), snap["params"]):
        p.copy_(q)
    for m, q in zip([m for g in st.opt.groups
                     for m in (*g.exp_avg, *g.exp_avg_sq)], snap["moments"]):
        m.copy_(q)
    st.step = snap["step"]
    st.opt.set_count(st.step)
    if snap["occ"] is not None:
        for x, q in zip(st.occ, snap["occ"]):
            x.copy_(q)
    gen.set_state(snap["gen"])


def state_from(snap: dict, field, cfg, total: int):
    """A new train state (its own field, optimizer, grid) and generator
    holding a snapshot."""
    from human_body_reconstruction_tpu_torch.ops import occupancy
    from human_body_reconstruction_tpu_torch.train import state as state_lib

    occ = (None if snap["occ"] is None else
           occupancy.OccupancyGrid(*(x.clone() for x in snap["occ"])))
    st = state_lib.create_train_state(copy.deepcopy(field), cfg.train, total,
                                      occ=occ)
    gen = torch.Generator(snap["params"][0].device)
    restore_into(st, gen, snap)
    return st, gen


@contextlib.contextmanager
def recording(st, base: int, n: int, store: dict, sums=None, grads_at=None):
    """Record what each step of a run from update count ``base`` draws and
    computes into ``store`` (slot = the device count - base, written on the
    device, so a captured step records every replay): the batch's image and
    pixel indices and pixels, every uniform the sampler draws, the Philox
    seeds, the loss and its aux metrics, and the gradients of the step at
    count ``grads_at`` (the first step's by default).
    With ``sums`` True, also every backward kernel's sums of every step;
    given another run's store as ``sums``, the backward kernels are not
    launched and hand back that run's sums of the same step (read at the
    device count, so a captured step reads each replay's)."""
    from human_body_reconstruction_tpu_torch.ops import rng_kernel, sampling
    from human_body_reconstruction_tpu_torch.train import step as step_lib

    orig = (step_lib.sample_ray_batch, sampling._uniform, rng_kernel.uniform,
            step_lib.loss_fn, st.opt.step)
    calls = {"uniform": 0, "seed": 0, "sums": {}}
    sites = backward_sites() if sums is not None else {}
    kernels = {nm: getattr(*site) for nm, site in sites.items()}

    def slot():
        return (st.opt.count - base).long().reshape(1)

    def put(name, x):
        x = x.detach()
        if name not in store:
            store[name] = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype,
                                      device=x.device)
        store[name].index_copy_(0, slot(), x.unsqueeze(0))

    def batch(images, c2ws, K, size, generator=None, img_idx=None,
              pix_idx=None):
        calls["uniform"] = calls["seed"] = 0
        calls["sums"] = {}
        N, H, W = images.shape[:3]
        if img_idx is None:
            img_idx = torch.randint(0, N, (size,), generator=generator,
                                    device=images.device)
        if pix_idx is None:
            pix_idx = torch.randint(0, H * W, (size,), generator=generator,
                                    device=images.device)
        out = orig[0](images, c2ws, K, size, img_idx=img_idx,
                      pix_idx=pix_idx)
        put("img_idx", img_idx)
        put("pix_idx", pix_idx)
        put("pixels", out[3])
        return out

    def uniform(*a, **k):
        u = orig[1](*a, **k)
        put(f"uniform{calls['uniform']}", u)
        calls["uniform"] += 1
        return u

    def philox(seed, shape):
        put(f"seed{calls['seed']}", seed)
        calls["seed"] += 1
        return orig[2](seed, shape)

    def loss(*a, **k):
        value, aux = orig[3](*a, **k)
        put("loss", value)
        for key, v in aux.items():
            put(f"aux_{key}", v)
        return value, aux

    def opt_step(count=None):
        first = st.opt.count == (base if grads_at is None else grads_at)
        for i, p in enumerate(st.field.parameters()):
            name = f"grad{i}"
            if name not in store:
                store[name] = torch.zeros_like(p.grad)
            store[name].copy_(torch.where(first, p.grad, store[name]))
        return orig[4](count)

    def backward(nm):
        def spy(*args, **kw):
            i = calls["sums"][nm] = calls["sums"].get(nm, -1) + 1
            key = f"sum_{nm}{i}"
            if sums is True:
                out = kernels[nm](*args, **kw)
                parts = list(out) if isinstance(out, (list, tuple)) else [out]
                for j, t in enumerate(parts):
                    put(f"{key}_{j}", t)
                store[f"{key}_parts"] = (len(parts), type(out))
                return out
            k, kind = sums[f"{key}_parts"]
            parts = [sums[f"{key}_{j}"].index_select(0, slot()).squeeze(0)
                     for j in range(k)]
            return kind(parts) if kind in (list, tuple) else parts[0]
        spy.launches = 0        # the wrapper counts on its module's name
        return spy

    step_lib.sample_ray_batch, sampling._uniform = batch, uniform
    rng_kernel.uniform, step_lib.loss_fn = philox, loss
    st.opt.step = opt_step
    for nm, site in sites.items():
        setattr(*site, backward(nm))
    try:
        yield store
    finally:
        (step_lib.sample_ray_batch, sampling._uniform, rng_kernel.uniform,
         step_lib.loss_fn) = orig[:4]
        del st.opt.step
        for nm, site in sites.items():
            setattr(*site, kernels[nm])


def state_vector(st) -> torch.Tensor:
    """Parameters and Adam moments, flattened into one f32 vector."""
    return torch.cat([t.detach().reshape(-1).float() for t in (
        *st.field.parameters(),
        *[m for g in st.opt.groups for m in (*g.exp_avg, *g.exp_avg_sq)])])


def profile_kernels(fn):
    """(kernel names, device-busy ms) of one call of fn by torch.profiler
    (kernels only: no memsets or copies); (None, None) where it records no
    device operation."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.name.lower().startswith(("memset", "memcpy"))]
    if not ev:
        return None, None
    busy = _union([(e.time_range.start, e.time_range.end) for e in ev])[0]
    return [e.name for e in ev], busy / 1e3


PORT_KERNELS = ("cp_forward_kernel", "cp_backward_kernel",
                "dense_forward_kernel", "dense_backward_kernel",
                "hash_forward_kernel", "hash_backward_kernel",
                "uniform_bits_kernel")


def kernel_summary(names, per: int = 1) -> str:
    """The port's own kernels by count, then the number of other kernels
    and of their distinct names, each count over ``per`` (steps)."""
    if names is None:
        return "not measured (the profiler recorded no device kernel)"
    mine = {k: sum(k in n for n in names) / per for k in PORT_KERNELS}
    other = [n for n in names if not any(k in n for k in PORT_KERNELS)]
    return (", ".join(f"{k} x{v:g}" for k, v in mine.items() if v)
            + f"; {len(other) / per:g} other kernels of {len(set(other))} "
            "names")


class SingleRunner:
    """The single-device step (``train_step``) and its window
    (``train_step_multi`` on a ``step.WindowGraph``), for window_check."""

    parallel = False

    def __init__(self, field, scene, data, cfg, total: int):
        self.field, self.scene, self.data, self.cfg = field, scene, data, cfg
        self.total = total

    def state(self, snap):
        return state_from(snap, self.field, self.cfg, self.total)

    def step(self, st, gen):
        from human_body_reconstruction_tpu_torch.train import step as step_lib

        return step_lib.train_step(st, self.scene, *self.data, self.cfg,
                                   self.cfg.train.ray_batch, gen)

    def window(self, n: int):
        from human_body_reconstruction_tpu_torch.train import step as step_lib

        graph = step_lib.WindowGraph()

        def run(st, gen):
            return step_lib.train_step_multi(
                st, self.scene, *self.data, self.cfg,
                self.cfg.train.ray_batch, n, gen, graph=graph)
        run.graph = graph
        return run


class ParallelRunner(SingleRunner):
    """A data- or level-parallel step (``make``: ``make_dp_train_step`` or
    ``make_lp_train_step``) on a world-1 NCCL mesh and its window
    (``steps_per_call`` n), each step drawing from its own folded
    generators; a level-parallel state is this rank's shard."""

    parallel = True

    def __init__(self, make, mesh, field, scene, data, cfg, total: int,
                 lp=None):
        super().__init__(field, scene, data, cfg, total)
        self.make, self.mesh, self.lp = make, mesh, lp
        self.one = make(cfg, cfg.train.ray_batch, mesh)

    def state(self, snap):
        st, gen = super().state(snap)
        if self.lp is not None:
            st = self.lp.shard_lp_state(st, self.cfg, self.mesh, self.total)
        return st, gen

    def step(self, st, gen):
        return self.one(st, self.scene, *self.data)

    def agree_ms(self, reps: int = 20) -> float:
        """Host ms of the ranks' agreement that opens a window
        (``comm.mesh_any``: an all-reduce a group and the read of its
        result)."""
        from human_body_reconstruction_tpu_torch.parallel import comm

        device = self.data[0].device
        comm.mesh_any(False, self.mesh, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            comm.mesh_any(False, self.mesh, device)
        return 1e3 * (time.perf_counter() - t0) / reps

    def window(self, n: int):
        win = self.make(self.cfg, self.cfg.train.ray_batch, self.mesh,
                        steps_per_call=n)

        def run(st, gen):
            return win(st, self.scene, *self.data)
        run.graph = win.graph
        return run


@contextlib.contextmanager
def collective_calls(log: list):
    """Record each all-reduce and all-gather the host calls as (name,
    whether the current stream is capturing)."""
    import torch.distributed as dist

    orig = {nm: getattr(dist, nm) for nm in ("all_reduce",
                                             "all_gather_into_tensor")}

    def spy(nm):
        def call(*a, **k):
            log.append((nm, torch.cuda.is_current_stream_capturing()))
            return orig[nm](*a, **k)
        return call

    for nm in orig:
        setattr(dist, nm, spy(nm))
    try:
        yield log
    finally:
        for nm, fn in orig.items():
            setattr(dist, nm, fn)


def window_check(label, st0, gen0, runner, n, tag, refresh=None):
    """One window of n steps against n eager steps, through ``runner``
    (``SingleRunner`` or ``ParallelRunner``).  A graph run G is captured by
    a first window from a snapshot of (st0, gen0) (with ``refresh``, its
    grid then refreshed in place); every other run starts from the state
    that window left, so G's recorded window is replays only, n steps past
    its capture: a recorded eager run A (its backward kernels' sums of
    every step kept), an unrecorded eager run A2 (timed), a graph run R
    handed A's backward-kernel sums at every step.  Checks: R's parameters
    and moments after n steps, and every step's draws, loss and aux, bit
    for bit with A's, and its window mean the mean of A's steps; G's draws
    of every step bit for bit with A's, its first step's loss bit for bit
    and gradients within the sum-order tolerance (or twice the
    eager-vs-eager spread), its window mean the mean of its steps; for a
    parallel step, its collectives called while the capture stream
    captured (the warm-up step's as many, eagerly) and, in the replayed
    window, none but the ranks' agreement to keep the graph.  Launching
    their own float-atomic sums, runs branch apart at random steps, so G's
    and A2's distances from A after n steps are printed beside one update's,
    not bounded.  Then a clean graph (no recording) timed over a window
    and profiled over one, beside one eager step.
    Returns the timing record."""
    from human_body_reconstruction_tpu_torch.ops import cuda_lib, occupancy

    cfg = runner.cfg
    B = cfg.train.ray_batch
    # G: captured from the snapshot by a first window; every run below
    # starts from the state that window left, so G's recorded window is
    # replays only, n steps past its capture
    stG, genG = runner.state(snapshot(st0, gen0))
    run, calls, recG = runner.window(n), [], {}
    # the graph records in place: slots 0..n-1 by the capture window,
    # n..2n-1 by the recorded window, the gradients of its first step
    with recording(stG, stG.step, 2 * n, recG, grads_at=stG.step + n):
        with collective_calls(calls):
            run(stG, genG)                  # warm-up, capture, replays
    capture_calls = list(calls)
    check(run.graph.captures == 1,
          f"{label}: one capture ({run.graph.captures})")
    if refresh is not None:     # after the capture: written in place
        with torch.no_grad():
            new = refresh(stG)
        changed = int((new.mask != stG.occ.mask).sum())
        check(changed > 0, f"{label}: the refresh changed the grid")
        occupancy.write_(stG.occ, new)
    snap = snapshot(stG, genG)

    def eager(st, gen, record):
        store, ms, last = {}, [], None
        ctx = (recording(st, snap["step"], n, store, sums=True) if record
               else contextlib.nullcontext())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx:
            for i in range(n):
                if record and i == n - 1:
                    last = state_vector(st)
                ms.append(runner.step(st, gen))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        return store, ms, sec, last

    def metric_keys(m):
        return ["loss" if k == "loss" else f"aux_{k}" for k in m]

    stA, genA = runner.state(snap)
    recA, _, _, before_last = eager(stA, genA, True)
    stA2, genA2 = runner.state(snap)
    _, msA2, sec_eager, _ = eager(stA2, genA2, False)
    draw_keys = ("img_idx", "pix_idx", "pixels", "uniform", "seed")
    draws = sorted(k for k in recA if k.startswith(draw_keys))

    # R: a graph handed A's backward-kernel sums at every step (their float
    # atomics are the only run-to-run freedom): its one window (warm-up
    # step, capture, n - 1 replays) must leave A's state bit for bit
    stR, genR = runner.state(snap)
    runR, recR = runner.window(n), {}
    with recording(stR, snap["step"], n, recR, sums=recA):
        mR = runR(stR, genR)
    torch.cuda.synchronize()
    vecA = state_vector(stA)
    check(runR.graph.captures == 1 and torch.equal(state_vector(stR), vecA),
          (f"{label}: given eager's backward sums, the window's parameters "
           "and moments bit for bit", runR.graph.captures,
           float((state_vector(stR) - vecA).abs().max())))
    for k in (*draws, *metric_keys(mR)):
        check(torch.equal(recR[k], recA[k]),
              f"{label}: given eager's backward sums, {k} of every step bit "
              "for bit")
    f32_sum = n * 2.0 ** -24
    eager_mean = {k: float(recA[key].double().mean())
                  for k, key in zip(mR, metric_keys(mR))}
    mean_err_r = max(abs(float(mR[k]) - eager_mean[k]) / abs(eager_mean[k])
                     for k in mR)
    check(mean_err_r <= f32_sum,
          (f"{label}: given eager's sums, the window mean", mean_err_r))
    del stR, recR, runR
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    calls.clear()
    t0 = time.perf_counter()
    with collective_calls(calls):
        mG = run(stG, genG)
    torch.cuda.synchronize()
    sec_rec = time.perf_counter() - t0
    recG = {k: v[n:] if k.startswith((*draw_keys, "loss", "aux_")) else v
            for k, v in recG.items()}
    check(run.graph.captures == 1,
          f"{label}: no second capture ({run.graph.captures})")
    collectives = ""
    if runner.parallel:
        captured = sum(c for _, c in capture_calls)
        agreement = 2               # comm.mesh_any: one on each group
        check(captured > 0 and len(capture_calls) == 2 * captured + agreement
              and len(calls) == agreement and not any(c for _, c in calls),
              (f"{label}: the step's collectives captured, none eager in "
               "the replayed window", capture_calls, calls))
        collectives = (f"; collectives called while capturing {captured} "
                       f"({', '.join(nm for nm, c in capture_calls if c)}), "
                       f"in a replayed window {len(calls)} (the ranks' "
                       "agreement, eager)")
    check(set(draws) == {k for k in recG if k.startswith(draw_keys)},
          f"{label}: the same draws recorded")
    for k in draws:
        check(torch.equal(recA[k], recG[k]),
              f"{label}: draws {k} of every step equal eager's")
    check(torch.equal(recA["loss"][0], recG["loss"][0]),
          (f"{label}: the first step's loss", float(recA["loss"][0]),
           float(recG["loss"][0])))
    # the first step's gradients: eager A2 recomputed unrecorded has none;
    # hold G to A within the sum-order tolerance of |grad| sums, or within
    # twice what a second eager step moves them
    recA2 = {}
    stB, genB = runner.state(snap)
    with recording(stB, snap["step"], 1, recA2):
        runner.step(stB, genB)
    del stB
    worst = []
    for i in range(sum(k.startswith("grad") for k in recA)):
        gA, gG, gB = (r[f"grad{i}"] for r in (recA, recG, recA2))
        tol = cuda_lib.sum_order_tolerance(gA, gA.abs(), True)
        spread = float((gB - gA).abs().max())
        err = float((gG - gA).abs().max())
        worst.append((err, spread))
        check(bool(((gG - gA).abs() <= torch.maximum(
            tol, torch.full_like(tol, 2.0 * spread))).all()),
              (f"{label}: first-step gradient {i}", err, spread))
    if "seed0" in recA:
        seeds = recG["seed0"].reshape(-1)
        check(bool((seeds[1:] != seeds[:-1]).all()),
              f"{label}: consecutive replays drew different Philox seeds")
    # launching its own float-atomic sums, the runs branch apart at random
    # steps: the distances after n steps are printed, not bounded
    d_graph = float((state_vector(stG) - vecA).norm())
    d_eager = float((state_vector(stA2) - vecA).norm())
    d_update = float((vecA - before_last).norm())
    norm = float(vecA.norm())
    # the window's mean against the f64 mean of its own recorded steps:
    # within the rounding of an f32 sum of n terms (n ulps)
    own = {k: float(recG[key].double().mean())
           for k, key in zip(mG, metric_keys(mG))}
    mean_err = max(abs(float(mG[k]) - own[k]) / abs(own[k]) for k in mG)
    check(mean_err <= f32_sum, (f"{label}: window mean", mean_err))
    eager2_mean = {k: sum(float(m[k]) for m in msA2) / n for k in mG}
    vs_eager = max(abs(float(mG[k]) - eager_mean[k]) / abs(eager_mean[k])
                   for k in mG)
    vs_eager2 = max(abs(eager2_mean[k] - eager_mean[k]) / abs(eager_mean[k])
                    for k in mG)
    del stA, stA2, vecA, before_last, recA, recG, recA2
    run = None
    torch.cuda.empty_cache()

    # timing: a clean graph (no recording) on G's state
    clean = runner.window(n)
    clean(stG, genG)                        # the capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clean(stG, genG)
    torch.cuda.synchronize()
    sec_graph = time.perf_counter() - t0
    # one whole window (the replays and the window's own sums, count write
    # and means), per step; one eager step
    g_names, g_busy = profile_kernels(lambda: clean(stG, genG))
    e_names, e_busy = profile_kernels(lambda: runner.step(stG, genG))
    nccl = (None if g_names is None else
            sum("nccl" in nm.lower() for nm in g_names) / n)
    rec = {"eager_ms": 1e3 * sec_eager / n, "graph_ms": 1e3 * sec_graph / n,
           "eager_busy_ms": e_busy,
           "graph_busy_ms": None if g_busy is None else g_busy / n,
           "eager_launches": None if e_names is None else len(e_names),
           "graph_launches": None if g_names is None else len(g_names) / n,
           "capture_s": clean.graph.capture_s}
    agree = ""
    if runner.parallel:
        rec["graph_nccl_kernels"] = nccl
        rec["agree_ms"] = runner.agree_ms()
        agree = (f"; the ranks' agreement opening each window "
                 f"{rec['agree_ms']:.3f} ms")
    print(f"window {label}: {n} steps from step {snap['step']}, {n} past "
          f"the capture ({B} rays): draws of every step bit for bit "
          f"({', '.join(draws)});"
          f" first-step loss bit for bit {float(mG['loss']):.6g} (window mean)"
          f", first-step gradients worst |graph - eager| / |eager2 - eager|"
          f" {max(w[0] for w in worst):.3e} / {max(w[1] for w in worst):.3e};"
          f" after {n} steps |graph - eager| {d_graph:.4e}, |eager2 - "
          f"eager| {d_eager:.4e}, one update {d_update:.4e} (of norm "
          f"{norm:.4e}); given eager's backward sums, the state and every "
          f"step's metrics bit for bit, the window mean vs eager's steps "
          f"{mean_err_r:.2e}; window mean vs its steps {mean_err:.2e}, vs "
          f"eager's mean {vs_eager:.2e} (eager2 {vs_eager2:.2e}); recorded "
          f"window {1e3 * sec_rec / n:.3f} "
          f"ms/step{collectives}")
    print(f"window {label} timing: eager {rec['eager_ms']:.3f} ms/step, "
          f"graphed {rec['graph_ms']:.3f} ms/step (host wall around whole "
          f"windows of {n} ending in a synchronise); device busy a step: "
          f"eager {e_busy} ms, graphed {rec['graph_busy_ms']} ms (a window's"
          f" over {n}); kernels a step: eager {rec['eager_launches']}, "
          f"graphed {rec['graph_launches']}"
          + (f" (NCCL kernels {nccl}: a world of one runs its all-reduce "
             "in place with no kernel)" if runner.parallel else "")
          + f"; capture {clean.graph.capture_s:.2f} s (warm-up step "
          f"included){agree} {tag}")
    print(f"window {label} captured kernels a step: "
          f"{kernel_summary(g_names, n)}")
    return rec


def window_phase(trainer, tag):
    """The flagship window at full width: culled (the trained grid,
    refreshed in place after the capture) and unculled (the same field with
    no grid: the 128-sample ladder), then Trainer.run with steps_per_call
    25 for WINDOW_TRAINER_STEPS steps (a refresh crossing inside), the
    encoder kernels' counts reset just before."""
    from human_body_reconstruction_tpu_torch.ops import occupancy

    cfg, ds = trainer.cfg, trainer.ds
    data = (ds["images"], ds["c2ws"], ds["K"])
    st, gen = trainer.state, trainer.generator
    gen_r = torch.Generator(trainer.device)

    def refresh(s):
        gen_r.manual_seed(SEED + 7)
        return occupancy.update_from_field(s.occ, s.field, trainer.scene,
                                           cfg, generator=gen_r)

    def runner(n, field=st.field, c=cfg, par=None):
        total = st.step + 10 * n
        if par is None:
            return SingleRunner(field, trainer.scene, data, c, total)
        return ParallelRunner(par[0], par[1], field, trainer.scene, data, c,
                              total, lp=par[2] if len(par) > 2 else None)

    n = WINDOW_STEPS["guided"]
    recs = {"guided": window_check("flagship guided", st, gen, runner(n), n,
                                   tag, refresh=refresh)}
    torch.cuda.empty_cache()
    unculled = copy.copy(st)
    unculled.occ = None
    n = WINDOW_STEPS["unculled"]
    recs["unculled"] = window_check("flagship unculled", unculled, gen,
                                    runner(n), n, tag)
    torch.cuda.empty_cache()
    recs.update(parallel_window_phase(trainer, runner, tag))
    grid = trainer.state.occ
    ptrs = [x.data_ptr() for x in grid]
    trainer.steps_per_call = 25
    before = trainer.state.step
    _, launches = counted(wrappers(*TRAIN_KERNELS), lambda: trainer.run(
        WINDOW_TRAINER_STEPS, log_every=25))
    trainer.steps_per_call = 1
    print(f"train --steps_per_call 25: steps {before} -> {trainer.state.step}"
          f", {trainer._window.captures} capture(s), logs "
          f"{[(r['step'], round(r['psnr'], 2)) for r in trainer.history[-2:]]}"
          f"; host launch counts (warm-up and capture only: replays are not "
          f"counted by the wrappers) {launches}")
    check(trainer.state.step == before + WINDOW_TRAINER_STEPS
          and trainer.state.occ is grid
          and [x.data_ptr() for x in grid] == ptrs,
          "the windowed run refreshed the grid in place")
    check(all(v > 0 for v in launches.values()), launches)
    check(all(math.isfinite(r["loss"]) for r in trainer.history[-2:]),
          "finite window losses")
    return recs


def window_hash_phase(trainer, tag):
    """The hash grid's window (``--stochastic --hw_rng``, 8 steps), then
    Trainer.run with steps_per_call 8."""
    from human_body_reconstruction_tpu_torch.parallel import level_parallel as lp

    ds, st, n = trainer.ds, trainer.state, WINDOW_STEPS["hash"]
    args = (st.field, trainer.scene, (ds["images"], ds["c2ws"], ds["K"]),
            trainer.cfg, st.step + 10 * n)
    rec = window_check("hash", st, trainer.generator, SingleRunner(*args),
                       n, tag)
    with nccl_world():
        mesh = lp.make_lp_mesh(1, 1)
        par = window_check(
            "level-parallel hash", st, trainer.generator,
            ParallelRunner(lp.make_lp_train_step, mesh, *args, lp=lp),
            WINDOW_STEPS["lp_hash"], tag)
    torch.cuda.empty_cache()
    trainer.steps_per_call = 8
    before = trainer.state.step
    _, launches = counted(
        wrappers("uniform_bits", "hash_forward", "hash_backward"),
        lambda: trainer.run(WINDOW_HASH_TRAINER_STEPS, log_every=8))
    trainer.steps_per_call = 1
    print(f"train --stochastic --hw_rng --steps_per_call 8: steps {before} "
          f"-> {trainer.state.step}; host launch counts {launches}")
    check(trainer.state.step == before + WINDOW_HASH_TRAINER_STEPS,
          "the hash window ran its steps")
    check(all(v > 0 for v in launches.values()), launches)
    return rec, par


def parallel_window_cli_phase(work: str, tag: str):
    """``train_hash --data_parallel --steps_per_call 25`` through its
    ``main`` (a world of one on NCCL) at the flagship's full width, its grid
    installed between the two windows, and the same with ``--level_parallel
    1 --stochastic --hw_rng``, each under torch.profiler: the port's
    kernels a step over the run (replays included, which the wrappers'
    host counts miss; the run's dataset render launches none of them), the
    backward kernels once a step."""
    runs = (("dp_window_flagship", ["--steps", str(2 * PW_CLI_WINDOW),
                                    "--occ_warmup", str(PW_CLI_WINDOW)],
             TRAIN_KERNELS, ("cp_backward_kernel", "dense_backward_kernel")),
            ("dp_window_hash", ["--level_parallel", "1", "--stochastic",
                                "--hw_rng", "--steps",
                                str(2 * PW_CLI_WINDOW)],
             ("uniform_bits", "hash_forward", "hash_backward"),
             ("hash_backward_kernel",)))
    out = {}
    for name, argv, kernels, per_step in runs:
        got = {}
        names, busy = profile_kernels(lambda: got.update(run=parallel_cli(
            [*argv, "--steps_per_call", str(PW_CLI_WINDOW), "--log_every",
             str(PW_CLI_WINDOW)], wrappers(*kernels), work, name, tag)))
        trainer, launches = got["run"]
        steps = trainer.state.step
        check(steps == 2 * PW_CLI_WINDOW
              and trainer._window_fn.steps_per_call == PW_CLI_WINDOW
              and [r["step"] for r in trainer.history]
              == [PW_CLI_WINDOW, 2 * PW_CLI_WINDOW],
              (name, steps, [r["step"] for r in trainer.history]))
        counts = (None if names is None else
                  {k: sum(k in nm for nm in names) for k in PORT_KERNELS})
        if counts is not None:
            check(all(counts[k] == steps for k in per_step),
                  (f"{name}: the backward kernels once a step", counts))
        print(f"parallel {name}: {trainer._window_fn.graph.captures} "
              f"capture(s); the port's kernels over the run by the profiler "
              f"{kernel_summary(names)} over {steps} steps ({counts}); "
              f"device busy over the run {busy} ms {tag}")
        out[name] = {"steps": steps, "profiled_kernels": counts,
                     "host_launches": launches}
        del trainer
        torch.cuda.empty_cache()
    return out


def parallel_window_phase(trainer, runner, tag):
    """The parallel windows on the trained flagship, each a world-1 NCCL
    step (its collectives captured with it) against eager parallel steps
    from one snapshot (``window_check``): the data-parallel guided step
    (768,000 points, 25 steps) and the ``--cp_rank 32`` ladder's
    rank-parallel step with the TV on (a seeded field on the flagship's
    grid, 8 steps)."""
    from human_body_reconstruction_tpu_torch.models import nerf
    from human_body_reconstruction_tpu_torch.parallel import data_parallel as dp
    from human_body_reconstruction_tpu_torch.parallel import level_parallel as lp
    from human_body_reconstruction_tpu_torch.train import state as state_lib

    fc, st, gen = trainer.cfg, trainer.state, trainer.generator
    cfg32 = dataclasses.replace(
        fc, hash=dataclasses.replace(fc.hash, cp_rank=LP_CP_RANK),
        train=dataclasses.replace(fc.train, cp_tv_weight=LP_CP_TV,
                                  cp_tv_warmup=0))
    recs = {}
    with nccl_world():
        n = WINDOW_STEPS["dp_guided"]
        recs["dp_guided"] = window_check(
            "data-parallel flagship guided", st, gen,
            runner(n, par=(dp.make_dp_train_step, dp.make_mesh())), n, tag)
        torch.cuda.empty_cache()
        st32 = state_lib.create_train_state(
            nerf.Field(cfg32, generator=torch.Generator(
                trainer.device).manual_seed(SEED + 15)), cfg32.train,
            trainer.total_steps, occ=st.occ)
        st32.step = st.step
        n = WINDOW_STEPS["lp_cp32"]
        recs["lp_cp32"] = window_check(
            f"rank-parallel cp_rank {LP_CP_RANK}", st32, gen,
            runner(n, st32.field, cfg32,
                   (lp.make_lp_train_step, lp.make_lp_mesh(1, 1), lp)),
            n, tag)
    del st32
    torch.cuda.empty_cache()
    return recs


def fused_phase(work: str, device: torch.device, tag: str):
    """The fused renders on the flagship weights (write_run_dir): the
    server's default (fused) 400x400 frame and 4-pose batch against its
    --no_fused eager ones bit for bit, and against a render_poses of each
    pose alone; ``render --fused`` against ``render``; wall_s of each with
    the capture excluded (a first request of the shape captures), the
    capture's seconds printed apart, and the kernels of one replayed frame
    by torch.profiler."""
    from human_body_reconstruction_tpu_torch.cli import render, serve
    from human_body_reconstruction_tpu_torch.data import png
    from human_body_reconstruction_tpu_torch.data.synthetic import orbit_poses
    from human_body_reconstruction_tpu_torch.train import step

    run_dir = f"{work}/fused"
    os.makedirs(run_dir, exist_ok=True)
    write_run_dir(run_dir, device)
    base = ["--ckpt_dir", run_dir, "--model_name", "flagship", "--use_occ",
            "--device", "cuda"]
    fused = serve.RenderServer(serve.build_parser().parse_args(base))
    eager = serve.RenderServer(serve.build_parser().parse_args(
        base + ["--no_fused"]))
    reqs = {"frame": {"orbit": {"index": 1, "count": 4}, "num_samples": 128,
                      "eval_guided": 64, "no_image": True},
            "batch": {"batch": True, "orbit": {"count": 4},
                      "num_samples": 128, "eval_guided": 64,
                      "no_image": True}}
    walls = {}
    for name, req in reqs.items():
        for srv, kind in ((fused, "fused"), (eager, "eager")):
            check(srv.handle(req)["ok"], (name, kind))     # first use
            resp = srv.handle(req)
            check(resp["ok"], resp)
            walls[f"{name}_{kind}"] = resp["wall_s"]
    cfg = fused._cfg_for(64)
    focal = 400 / (2.0 * math.tan(fused.args.camera_angle_x / 2.0))
    K = torch.tensor([[focal, 0, 200.0], [0, focal, 200.0], [0, 0, 1]],
                     dtype=torch.float32, device=device)
    poses = torch.as_tensor(orbit_poses(4), device=device)
    kw = dict(occ=fused.occ, num_samples=128, bf16=True)
    frame_f = step.render_poses_fused(fused.field, fused.scene, 400, 400, K,
                                      poses[1:2], cfg, chunk=16384,
                                      graphs=fused.frames, **kw)
    frame_e = step.render_poses(fused.field, fused.scene, 400, 400, K,
                                poses[1:2], cfg, chunk=16384, **kw)
    batch_f = step.render_poses_fused(fused.field, fused.scene, 400, 400, K,
                                      poses, cfg, chunk=16384,
                                      graphs=fused.frames, **kw)
    batch_e = step.render_poses(fused.field, fused.scene, 400, 400, K, poses,
                                cfg, chunk=16384, **kw)
    singles = torch.cat([step.render_poses(
        fused.field, fused.scene, 400, 400, K, poses[i:i + 1], cfg,
        chunk=16384, **kw) for i in range(4)])
    torch.cuda.synchronize()
    check(torch.equal(frame_f, frame_e), "fused 400x400 frame == eager")
    check(torch.equal(batch_f, batch_e), "fused 4-pose batch == eager batch")
    single_err = float((batch_f - singles).abs().max())
    check(single_err <= FRAME_TOL, ("batch vs single frames", single_err))
    check(bool(torch.isfinite(batch_f).all()) and float(batch_f.std()) > 1e-3,
          "fused frames finite, not blank")
    names, busy = profile_kernels(lambda: step.render_poses_fused(
        fused.field, fused.scene, 400, 400, K, poses[1:2], cfg, chunk=16384,
        graphs=fused.frames, **kw))
    e_names, e_busy = profile_kernels(lambda: step.render_poses(
        fused.field, fused.scene, 400, 400, K, poses[1:2], cfg, chunk=16384,
        **kw))
    # the render CLI: --fused against eager, the PNGs equal
    outs = {}
    for flag in ([], ["--fused"]):
        d = f"{work}/render{'_fused' if flag else ''}"
        outs[bool(flag)] = render.main([
            "--ckpt_dir", run_dir, "--model_name", "flagship", "--orbit",
            "2", "--use_occ", "--eval_guided", "64", "--num_samples", "128",
            "--bf16", "--device", "cuda", "--out_dir", d] + flag)
    for a, b in zip(outs[True]["views"], outs[False]["views"]):
        with open(a["path"], "rb") as fa, open(b["path"], "rb") as fb:
            check(np.array_equal(png.decode_png(fa.read()),
                                 png.decode_png(fb.read())),
                  "render --fused PNG == render PNG")
    print(f"fused render 400x400 (128-sample ladder, eval_guided 64, bf16): "
          f"frame and 4-pose batch bit for bit with the eager chunks; batch "
          f"vs single frames max_abs_err {single_err:.3e}; server wall_s "
          f"(capture excluded): frame fused {walls['frame_fused']} eager "
          f"{walls['frame_eager']}, batch fused {walls['batch_fused']} eager "
          f"{walls['batch_eager']}; {fused.frames.captures} captures "
          f"{fused.frames.capture_s:.2f} s; render CLI 2 views wall_s fused "
          f"{outs[True]['wall_s']} (its first frame's capture included) "
          f"eager {outs[False]['wall_s']} {tag}")
    print(f"fused frame kernels: {kernel_summary(names)}; device busy "
          f"{busy} ms, eager {e_busy} ms ({None if e_names is None else len(e_names)} kernels)")
    return walls


def speedrun_window_phase(work: str, device: torch.device, tag: str, eager):
    """``cli/speedrun.py`` with the record's command, ``--steps_per_call
    25``, capped as the eager phase is; its crossing beside the eager
    run's."""
    from human_body_reconstruction_tpu_torch.cli import speedrun

    argv = [*SPEEDRUN_ARGS, "--steps_per_call", str(SPEEDRUN_WINDOW),
            "--device", str(device), "--out", f"{work}/speedrun_window.json"]
    t0 = time.perf_counter()
    res, launches = counted(wrappers(*TRAIN_KERNELS),
                            lambda: speedrun.main(argv, log=lambda s: None))
    print(f"speedrun --steps_per_call {SPEEDRUN_WINDOW}: {res['steps']} "
          "steps, gates " + ", ".join(
              f"step {e['steps']} {e['gate']} {e['gate_db']} dB (train "
              f"{e['train_db']}, exact {e['exact_db']}, wall {e['wall_s']} s)"
              for e in res["evals"])
          + f"; crossed {json.dumps(res['crossed'])} (eager: "
          f"{json.dumps(eager['crossed'])}, last gate "
          f"{eager['evals'][-1]['gate_db']} dB at step "
          f"{eager['evals'][-1]['steps']}); {time.perf_counter() - t0:.1f} s "
          f"{tag}")
    check(res["protocol"].endswith("(exact-confirmed crossing)")
          and f"{SPEEDRUN_WINDOW} steps/dispatch" in res["protocol"],
          res["protocol"])
    check(res["evals"] and all(math.isfinite(e["gate_db"])
                               for e in res["evals"]), res["evals"])
    check([e["steps"] for e in res["evals"]]
          == [e["steps"] for e in eager["evals"]]
          or res["crossed"] is not None, (res["evals"], eager["evals"]))
    check(all(n > 0 for n in launches.values()), launches)


NEURALANGELO_STAGE = 85_000     # the first update with all 16 levels active
NEURALANGELO_TIMED = 100        # timed steps after the stage change


def neuralangelo_phase(device, tag):
    """Neuralangelo at its published widths (``config.neuralangelo_config``)
    on the textured scene through ``Trainer.run`` with 25-step windows from
    step NEURALANGELO_STAGE - 50: the first window captures, the second
    crosses the stage change at NEURALANGELO_STAGE (traced: the
    ``hbr.train.stage`` span) with no new capture, then NEURALANGELO_TIMED
    timed steps; the F 8 hash kernels' launches counted over those windows
    (host calls: the capture's) and their kernels in the traced window (the
    replays'); one eager step traced for the ``hbr.sdf.*`` spans; the
    point counters and the MLP kernels' composed count (the head never calls
    them); then the F 8 hash kernels against their plain versions on a
    step's centre and tap points (917,504 at the cell's 1,024 rays x 128
    samples) in the 2^22-entry table.  Returns the kernel records."""
    from torch.profiler import ProfilerActivity, profile

    from human_body_reconstruction_tpu_torch.data import synthetic
    from human_body_reconstruction_tpu_torch.models import sdf_head
    from human_body_reconstruction_tpu_torch.ops import (
        adam_kernel, mlp_kernel, sampling)
    from human_body_reconstruction_tpu_torch.train import step as step_lib
    from human_body_reconstruction_tpu_torch.train.trainer import Trainer
    from human_body_reconstruction_tpu_torch.utils import config as C
    from human_body_reconstruction_tpu_torch.utils import observability as obs

    cfg = C.neuralangelo_config()
    ds = synthetic.make_dataset(
        n_views=20, H=400, W=400, focal=440.0, near=2.0, far=6.0,
        field=synthetic.textured_field, radius=4.0, elevation=0.35,
        gt_samples=384, device=device)
    work = tempfile.TemporaryDirectory()
    torch.cuda.reset_peak_memory_stats(device)
    trainer = Trainer(cfg=cfg, ds=ds, out_dir=work.name, model_name="na",
                      total_steps=500_000, steps_per_call=25,
                      log_fn=lambda line: print(f"  {line}"))
    trainer.state.step = NEURALANGELO_STAGE - 50
    composed = mlp_kernel.composed_calls
    kernels = wrappers("hash_forward", "hash_backward")
    for _, kern in kernels:
        kern.launches = 0
    adam_before = adam_kernel.launches
    t0 = time.perf_counter()
    trainer.run(25, log_every=25)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    adam_first = (adam_kernel.launches - adam_before,
                  adam_kernel.fused_elements)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.run(25, log_every=25)
        torch.cuda.synchronize()
    adam_replayed = adam_kernel.launches - adam_before - adam_first[0]
    stage_spans = obs.span_summary(prof.events()).get("hbr.train.stage")
    replayed = {nm: sum(e.device_type == torch.autograd.DeviceType.CUDA
                        and f"{nm}_kernel" in e.name for e in prof.events())
                for nm, _ in (*kernels, ("hbr_adam_multi_tensor_apply", 0))}
    t0 = time.perf_counter()
    trainer.run(NEURALANGELO_TIMED, log_every=NEURALANGELO_TIMED)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / NEURALANGELO_TIMED
    launches = {nm: kern.launches for nm, kern in kernels}
    win = trainer._window
    rec = trainer.history[-1]
    print(f"neuralangelo: steps {NEURALANGELO_STAGE - 50} -> "
          f"{trainer.state.step} in 25-step windows, {win.captures} capture(s)"
          f", {win.replays} replays, first window (capture) {first_s:.2f} s, "
          f"{ms:.3f} ms/step ({1024 / ms * 1e3:.0f} rays/s) over "
          f"{NEURALANGELO_TIMED} steps, loss {rec['loss']:.5f}, psnr "
          f"{rec['psnr']:.2f}, active levels {rec['active_levels']}, eps "
          f"{rec['normal_eps']:.6g}; hbr.train.stage {stage_spans}; points a "
          f"step {sdf_head.step_points()}; hash launches (host calls) over "
          f"the windows {launches}, kernels in the traced 25-step window "
          f"{replayed}; Adam kernel host launches (launches, fused_elements)"
          f" over the capture's window {adam_first}, over the traced window "
          f"of replays {adam_replayed}; peak memory "
          f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB {tag}")
    groups = trainer.state.opt.groups
    check(win.captures == 1, ("one capture across the stage change",
                              win.captures))
    check(adam_first == (2 * len(groups),
                         sum(q.numel() for q in groups[-1].params))
          and adam_replayed == 0,
          ("one Adam launch a group at the warm-up and the capture, none "
           "replayed", adam_first, adam_replayed, len(groups)))
    check(replayed["hbr_adam_multi_tensor_apply"] == 25 * len(groups),
          ("a replayed step runs the Adam kernel once a group", replayed))
    check(stage_spans is not None and stage_spans["n"] == 1, stage_spans)
    check(rec["active_levels"] == 16 and rec["normal_eps"]
          == 1.0 / 2048 * float(trainer.scene["sigma"]), rec)
    check(all(n > 0 for n in launches.values()), launches)
    check(replayed["hash_forward"] >= 25 and replayed["hash_backward"] >= 25,
          ("the replayed window runs the F 8 hash kernels", replayed))
    check(all(math.isfinite(r["loss"]) for r in trainer.history),
          "finite losses")
    check(mlp_kernel.composed_calls == composed,
          ("the head takes no MLP3D path", mlp_kernel.composed_calls))
    check(sdf_head.step_points() == {"centre": 131072, "taps": 786432,
                                     "upsample": 114688},
          sdf_head.step_points())
    data = (ds["images"], ds["c2ws"], ds["K"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_lib.train_step(trainer.state, trainer.scene, *data, cfg, 1024,
                            trainer.generator)
        torch.cuda.synchronize()
    spans = {k: v for k, v in obs.span_summary(prof.events()).items()
             if k.startswith("hbr.sdf.")}
    print("neuralangelo eager step spans (host_s, idle_s, device_s): "
          + ", ".join(f"{k} {v['host_s'] * 1e3:.2f} / {v['idle_s'] * 1e3:.2f}"
                      f" / {v['device_s'] * 1e3:.2f} ms" for k, v in
                      sorted(spans.items())) + f" {tag}")
    check(set(spans) == {"hbr.sdf.upsample", "hbr.sdf.taps",
                         "hbr.sdf.composite"}, spans)

    # the F 8 hash kernels on a step's centre and tap points
    field, scene = trainer.state.field, trainer.scene
    gen = torch.Generator(device).manual_seed(SEED + 25)
    batch = step_lib.sample_ray_batch(*data, 1024, gen)
    st = sdf_head.stage(cfg, trainer.state.opt.count, 500_000)
    with torch.no_grad():
        t = sdf_head.stratified(1024, cfg, device, jitter=True, generator=gen)
        t = sampling.neus_upsample(
            t, batch[0], batch[1],
            lambda q: sdf_head.sdf_only(field, scene, q, cfg, st), 16, 4)
        x = (batch[0][:, None, :] + batch[1][:, None, :]
             * t[..., None]).reshape(-1, 3)
        at = sdf_head.tap_batch(x, sdf_head.tap_step(st, scene))
        g = torch.randn((at.shape[0], cfg.hash.out_dim), generator=gen,
                        device=device)
    check(at.shape[0] == 917504, at.shape)
    fwd, bwd = hash_mode_check(field.table.detach(), at, scene, cfg.hash, g,
                               None, "neuralangelo step", tag)
    n_table = field.table.numel()
    del trainer, field, at, g, groups
    work.cleanup()
    torch.cuda.empty_cache()
    adam = adam_table_check(n_table, device, tag)
    shape = ("917,504 points: a neuralangelo step's 131,072 centre points "
             "and their six taps (1,024 rays x 128 NeuS samples), F 8, "
             "T 2^22; launches: host calls in the phase's Trainer.run "
             "windows (a replay launches from the graph: "
             f"{replayed['hash_forward']} forward and "
             f"{replayed['hash_backward']} backward kernels in a traced "
             "25-step window)")
    return [entry(f"{nm}/neuralangelo_step", HASH_SOURCE, replaces,
                  launches[nm], *rec, shape) for nm, replaces, rec in (
        ("hash_forward", "none (the JAX package has no such model)", fwd),
        ("hash_backward", "none (the JAX package has no such model)", bwd))
    ] + [entry("adam/neuralangelo_table", "csrc/adam.cu",
               "none (optax's update, which XLA fuses)", adam_first[0], *adam,
               f"{n_table:,} f32 entries: the neuralangelo hash table's group;"
               " launches: host calls over the phase's windows, one a group "
               "at the warm-up and the capture")]


def adam_table_check(n: int, device, tag: str):
    """The Adam kernel alone on a group of one n-entry f32 tensor (the
    neuralangelo table's size), the table group's eps: bit for bit against
    the foreach passes, and the device time of the kernel, of the foreach
    passes and of torch's ``_fused_adam_`` (the same algorithm, not the same
    rounding: it divides by sqrt(v) / sqrt(bc2)), against the bytes the
    update must move (p, g, m and v read, p, m and v written).  Returns
    (max_abs_err, ms, plain_ms, library_ms, bound)."""
    from human_body_reconstruction_tpu_torch.ops import adam_kernel

    gen = torch.Generator(device).manual_seed(SEED + 26)
    p, g, m = (torch.randn(n, generator=gen, device=device)
               for _ in range(3))
    g.mul_(1e-3)
    m.mul_(1e-4)
    v = m * m + 1e-6 * torch.rand(n, generator=gen, device=device)
    c1 = torch.tensor(85_001.0, device=device)
    rate = torch.tensor(1e-4, device=device)
    bc1, bc2 = 1.0 - torch.pow(0.9, c1), 1.0 - torch.pow(0.999, c1)
    ref = [t.clone() for t in (p, m, v)]
    adam_kernel.update([p], [g], [m], [v], rate, bc1, bc2, 1e-15)
    check(adam_kernel.fused_elements == n, adam_kernel.fused_elements)
    adam_kernel.update_plain([ref[0]], [g], [ref[1]], [ref[2]], rate, bc1,
                             bc2, 1e-15)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip((p, m, v), ref))
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip((p, m, v), ref))
    del ref
    torch.cuda.empty_cache()
    ms = time_ms(lambda: adam_kernel.update([p], [g], [m], [v], rate, bc1,
                                            bc2, 1e-15), reps=10)
    plain_ms = time_ms(lambda: adam_kernel.update_plain(
        [p], [g], [m], [v], rate, bc1, bc2, 1e-15), reps=10)
    fused = getattr(torch, "_fused_adam_", None)
    steps = [torch.tensor(85_001.0, device=device)]
    library_ms = None if fused is None else time_ms(lambda: fused(
        [p], [g], [m], [v], [], steps, lr=1e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.0, eps=1e-15, amsgrad=False, maximize=False), reps=10)
    bnd = bound(7 * 4 * n, 15 * n)
    print(f"adam kernel on {n:,} entries: {ms:.4f} ms (bound {bnd[0]:.4f} ms,"
          f" {bnd[1]}: {100 * bnd[0] / ms:.1f}%), foreach passes "
          f"{plain_ms:.4f} ms, torch._fused_adam_ (not the same rounding) "
          f"{library_ms} ms; bit for bit with the foreach passes: {same} "
          f"(max abs err {err:.3g}) {tag}")
    check(same, ("the Adam kernel equals the foreach passes bit for bit",
                 err))
    del p, g, m, v
    torch.cuda.empty_cache()
    return err, ms, plain_ms, library_ms, bnd


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from human_body_reconstruction_tpu_torch.cli import serve
    from human_body_reconstruction_tpu_torch.cli import card_line
    from human_body_reconstruction_tpu_torch.data.synthetic import orbit_poses
    from human_body_reconstruction_tpu_torch.ops import (
        cuda_lib, hash_kernel, marching_cubes, mlp_kernel)
    from human_body_reconstruction_tpu_torch.train import step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    gpu = card_line(device)
    print(gpu)
    tag = f"[{gpu}]"

    t_start = t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:     # g++ beside the nvcc processes
        mc_build = pool.submit(marching_cubes.build)
        lib_path, log = cuda_lib.build()
        mc_path = mc_build.result()
    cuda_lib.library()
    marching_cubes.library()
    print(f"build: {lib_path.name} and {mc_path.name} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    launch_list_phase(device, tag)

    work = tempfile.TemporaryDirectory()
    train_dir, hash_dir = f"{work.name}/flagship", f"{work.name}/hash"
    trainer, ds, train_launches, phase_launches = train(train_dir, device, tag)
    bwd = backward_checks(trainer, device, tag,
                          training_path_points(trainer, device))
    step_on_card_vs_cpu(trainer, ds, device)
    profile_step(trainer, "guided", tag)
    serve_trained(trainer, ds, train_dir, 128, tag)
    window_recs = window_phase(trainer, tag)
    del trainer
    torch.cuda.empty_cache()
    trainer, hash_launches = train_hash_grid(hash_dir, ds, device, tag)
    hash_pts, hash_scene = hash_path_points(trainer, device), trainer.scene
    hash_report = hash_kernel_checks(
        trainer, device, tag, hash_pts,
        serving_chunk_points(trainer.cfg.render, ds["K"], ds["c2ws"][1],
                             device, 64))
    hash_step_on_card_vs_cpu(trainer, ds, device)
    profile_step(trainer, "stochastic hash", tag)
    hash_kernel.hash_encode_kernel.launches = 0
    torch.cuda.synchronize()
    serve_trained(trainer, ds, hash_dir, 64, tag)
    torch.cuda.synchronize()
    hash_launches["hash_forward/serving_path"] = (
        hash_kernel.hash_encode_kernel.launches)
    print("launches while serving the trained hash model (exact "
          f"forward): {hash_launches['hash_forward/serving_path']}")
    check(hash_launches["hash_forward/serving_path"] > 0,
          "the served hash frames went through the forward kernel")
    window_recs["hash"], window_recs["lp_hash"] = window_hash_phase(
        trainer, tag)
    window_recs["cli"] = parallel_window_cli_phase(work.name, tag)
    del trainer, ds
    torch.cuda.empty_cache()

    kernels = wrappers("cp_forward", "dense_forward", "mlp")
    with tempfile.TemporaryDirectory() as run_dir:
        occ_frac = write_run_dir(run_dir, device)
        args = serve.build_parser().parse_args([
            "--ckpt_dir", run_dir, "--model_name", "flagship", "--use_occ",
            "--device", "cuda"])
        server = serve.RenderServer(args)
    cfg = server.base_cfg
    print(f"restored: levels {cfg.hash.num_levels}, n_max {cfg.hash.n_max}, "
          f"rank {cfg.hash.cp_rank}, dense levels {cfg.hash.dense_levels}, "
          f"MLP inputs {cfg.hash.out_dim}, occupied cells {occ_frac:.4f}")
    check((cfg.hash.num_levels, cfg.hash.n_max, cfg.hash.cp_rank,
           cfg.hash.dense_levels, cfg.hash.out_dim) == (7, 1448, 25, 2, 129),
          "full-width model")
    for guided in (0, 64):          # first-use costs (allocator, cuBLAS)
        warm = server.handle({"orbit": {"index": 2, "count": 4},
                              "eval_guided": guided, "no_image": True})
        check(warm["ok"], warm)

    requests = [
        {"id": "ladder128", "orbit": {"index": 0, "count": 4},
         "num_samples": 128, "eval_guided": 0},
        {"id": "guided64", "orbit": {"index": 1, "count": 4},
         "num_samples": 128, "eval_guided": 64},
        {"id": "orbit4", "batch": True, "orbit": {"count": 4},
         "num_samples": 128, "eval_guided": 64},
        {"id": "health", "cmd": "health"},
    ]
    mlp_kernel.composed_calls = 0
    responses, launches = counted(kernels, lambda: [server.handle(r)
                                                    for r in requests])
    check(mlp_kernel.composed_calls == 0,
          ("every bf16 MLP3D call took the kernels", mlp_kernel.composed_calls))
    for req, resp in zip(requests, responses):
        check(resp["ok"], resp)
        if "wall_s" in resp:
            pngs = resp.get("images_b64") or [resp["image_b64"]]
            check(all(base64.b64decode(p)[:8] == b"\x89PNG\r\n\x1a\n"
                      for p in pngs), "PNG payloads")
            print(f"request {req['id']}: {resp.get('frames', 1)} x "
                  f"{resp['H']}x{resp['W']}, samples {resp['num_samples']}, "
                  f"eval_guided {resp['eval_guided']}: wall {resp['wall_s']} s,"
                  f" {resp['rays_per_sec']} rays/s {tag}")
    print(f"health: {json.dumps(responses[-1])}")
    print(f"launches while serving (forward kernels): {launches}")
    check(all(n > 0 for n in launches.values()), launches)
    mlp_report = mlp_phase(device, tag, {
        "guided_train": phase_launches["guided"]["mlp"],
        "unculled_train": phase_launches["unculled"]["mlp"],
        "serving_chunk": launches["mlp"]})

    # each kernel against its plain version at the serving shape, on a chunk
    # of a frame's ladder and on uniform random points
    field, scene = server.field, server.scene
    gen = torch.Generator(device).manual_seed(SEED + 2)
    xn = torch.rand((N_POINTS, 3), generator=gen, device=device) * 1.5 - 0.25
    pts = scene["mu"] + xn * scene["sigma"]
    chunk = serving_chunk_points(
        cfg.render, [[400.0, 0, 200.0], [0, 400.0, 200.0], [0, 0, 1]],
        orbit_poses(4)[0], device, 128)
    check(chunk.shape == (N_POINTS, 3), ("serving chunk", chunk.shape))
    report = []
    for nm, tables in reversed(encoder_parts(field)):    # CP, then dense
        for kind, at in (("path", chunk), ("random", pts)):
            path = kind == "path"
            rec = forward_check(
                nm, tables, at, scene, cfg.hash, matrix=path,
                tol=FWD_TOL[nm], label=f"{kind} points", tag=tag)
            if path:
                shape = (f"{N_POINTS} points: a 16384-ray chunk of a 400x400 "
                         "frame's 128-sample ladder, into the encoder's (N, "
                         f"{cfg.hash.out_dim}) matrix; launches while serving")
                name, n = f"{nm}/serving_path", launches[nm]
            else:
                shape = (f"{N_POINTS} uniform random points, contiguous; "
                         "launches while training")
                name, n = f"{nm}/random", train_launches[nm]
            report.append(entry(name, SOURCE, REPLACES[nm], n, *rec, shape))
    for nm in ("cp_backward", "dense_backward"):
        for (phase, kind), (err, ms, plain_ms, lib_ms, bnd) in bwd[nm].items():
            n = TRAIN_POINTS[0] if phase == "guided" else TRAIN_POINTS[1]
            report.append(entry(
                f"{nm}/{phase}_{kind}", SOURCE, REPLACES[nm],
                phase_launches[phase][nm], err, ms, plain_ms, lib_ms, bnd,
                f"{n} {'path' if kind == 'path' else 'uniform random'} points "
                f"of a {phase} step; launches in the {phase} training steps"))
    report.append(entry(
        "uniform_bits", "human_body_reconstruction_tpu_torch/csrc/rng.cu",
        "human_body_reconstruction_tpu/ops/pallas_rng.py:30",
        hash_launches["uniform_bits"], *hash_report["uniform_bits"]))
    hash_src = HASH_SOURCE
    shapes = {"train_path": f"{HASH_POINTS} points of a hash-grid training "
                            "step's ray batch, stochastic; launches in the "
                            "timed hash training steps",
              "random": f"{HASH_POINTS} uniform random points, stochastic; "
                        "launches in the timed hash training steps",
              "serving_path": f"{16384 * 64} points: a 16384-ray chunk of a "
                              "served 400x400 frame's 64-sample ladder, "
                              "exact; launches while serving the trained "
                              "hash model"}
    for nm, replaces in (
            ("hash_forward", "none (no TPU kernel: human_body_reconstruction_"
             "tpu/ops/hash_encoding.py:232,259 gather in jnp)"),
            ("hash_backward", "none (no TPU kernel: the autodiff scatter of "
             "human_body_reconstruction_tpu/ops/hash_encoding.py:232,259)")):
        for kind, shape in shapes.items():
            key = f"{nm}/{kind}"
            if key in hash_report:
                report.append(entry(
                    key, hash_src, replaces,
                    hash_launches.get(key, hash_launches[nm]),
                    *hash_report[key], shape))

    report += neuralangelo_phase(device, tag)

    # a whole frame through the kernels (card) vs the plain versions (CPU)
    K = torch.tensor([[185.0, 0, 64.0], [0, 185.0, 64.0], [0, 0, 1]])

    c2w = torch.as_tensor(orbit_poses(4)[3])
    frame_cfg = server._cfg_for(64)
    img = step.render_image(field, scene, 128, 128, K.to(device),
                            c2w.to(device), frame_cfg, occ=server.occ,
                            num_samples=128, bf16=True).cpu()
    cpu = torch.device("cpu")
    field_cpu = copy.deepcopy(field).to(cpu)
    ref = step.render_image(
        field_cpu, {k: v.to(cpu) for k, v in scene.items()}, 128, 128, K,
        c2w, frame_cfg, occ=type(server.occ)(*(t.to(cpu) for t in server.occ)),
        num_samples=128, bf16=True)
    frame_err = float((img - ref).abs().max())
    print(f"frame 128x128 eval_guided 64: kernels (card) vs plain (CPU) "
          f"max_abs_err {frame_err:.3e} mean {float((img - ref).abs().mean()):.3e}"
          f" (tol {FRAME_TOL:g}); image range [{float(img.min()):.4f}, "
          f"{float(img.max()):.4f}]")
    check(bool(torch.isfinite(img).all()) and img.shape == (128, 128, 3),
          "frame finite and (128, 128, 3)")
    check(float(img.std()) > 1e-3, "frame not blank")
    check(frame_err <= FRAME_TOL, ("frame", frame_err))

    # the new paths: the quality protocol, the render CLI, mesh export
    del server, field, field_cpu
    torch.cuda.empty_cache()
    fused_walls = fused_phase(work.name, device, tag)
    torch.cuda.empty_cache()
    quality_phase(work.name, device, tag)
    render_phase(train_dir, work.name, device, tag)
    sweep = mesh_phase(train_dir, hash_dir, work.name, device, tag)

    # SDF mode, the hierarchical pass, a continued run, the TPU's weights
    from human_body_reconstruction_tpu_torch.cli import quality_holdout

    data = quality_holdout.protocol_data(400, 400, 20, "textured", device)
    mode_rows = {}
    for mode, rays, label in (
            (SDF_MODE, PROTOCOL_RAYS, "the step's eikonal points (its 16384 "
             "subsampled points at six clipped offsets)"),
            (HIER_MODE, HIER_STEP_RAYS, "the second pass's points of a 16384"
             "-ray batch (64 + 64 samples a ray)")):
        row, launches, res = protocol_mode_phase(mode, work.name, device, tag)
        if mode == SDF_MODE:
            serve_sdf_run(work.name, device, tag)
        pts = mode_step_on_card_vs_cpu(mode, res, data, device, rays, tag)
        if mode == HIER_MODE:
            pts = [pass_points(res, data, device, 1)]
        check(pts[-1].shape[0] == {SDF_MODE: 16384 * 6,
                                   HIER_MODE: PROTOCOL_RAYS * 128}[mode],
              (mode, pts[-1].shape))
        mode_rows[mode] = (encoder_kernel_checks(res, pts[-1], label, tag),
                           launches, pts[-1].shape[0], label)
        del res
        torch.cuda.empty_cache()
    continuation_phase(data, device, tag)
    tpu_weights_phase(data, work.name, device, tag)
    sdf_cli_phase(work.name, device, tag)
    recon = reconstruct_phase(work.name, device, tag)
    torch.cuda.empty_cache()
    # PR 10: the 2-D image fit, the vanilla NeRF, --plot_grads/--display
    # and onecycle
    image_recs, image_launches = image_fit_phase(work.name, device, tag)
    vanilla_phase(work.name, device, tag)
    plot_grads_phase(work.name, device, tag)
    # the held-back tangle, the wide CP ladders and the corner hash grid
    # through the protocol, and the time-to-target run
    quality_phase(work.name, device, tag, scene="tangle")
    wide_rows = {mode: wide_mode_phase(mode, data, work.name, device, tag)
                 for mode in (*WIDE_MODES, HASH_MODE)}
    speedrun_window_phase(work.name, device, tag,
                          speedrun_phase(work.name, device, tag))
    # PR 12: the parallel slice
    shard_recs, parallel_launches = parallel_phase(work.name, device, tag)
    print(f"launches in the parallel phase's runs: {parallel_launches}")
    # the hash-grid variants
    variant_report, _ = variants_phase(work.name, device, tag, hash_pts,
                                       hash_scene)
    del hash_pts
    work.cleanup()
    for key, (rec, launches, R) in sweep.items():
        nm = key.split("/")[0]
        report.append(entry(
            key, hash_src if nm == "hash_forward" else SOURCE, REPLACES[nm],
            launches, *rec,
            f"{SWEEP_CHUNK} lattice points (k fastest) of a {R}^3 mesh sweep"
            f"{', exact' if nm == 'hash_forward' else ''}; launches in the "
            "sweep"))

    for mode, (recs, launches, n, label) in mode_rows.items():
        kind = "eikonal_points" if mode == SDF_MODE else "fine_pass"
        for nm, rec in recs.items():
            report.append(entry(
                f"{nm}/{kind}", SOURCE, REPLACES[nm], launches[nm], *rec,
                f"{n} points: {label}, {mode} at full width; launches in its "
                f"{MODE_STEPS[mode]}-step protocol run"))
    recs, launches, n = recon
    for nm, rec in recs.items():
        report.append(entry(
            f"{nm}/reconstruct_path", SOURCE, REPLACES[nm], launches[nm], *rec,
            f"{n} points of a 16000-ray batch of the reconstruct run (guided, "
            "K 48, 64-sample ladder, the COLMAP-derived diagonal bounds); "
            f"launches in the reconstruct run ({RECON_STEPS} steps, its eval "
            "renders and its 256^3 sweep)"))
    image_shapes = {
        "image_fit_batch": "200000 pixels (x, y) of a 512x512 PNG, 2-D, "
                           "exact, L 16, F 2, T 2^18, n_max 2^16: the image "
                           "fit's first batch",
        "full_pred": f"{IMAGE_FIT_HW ** 2} pixels of the same image in row "
                     "order: the image fit's full_pred"}
    for key, rec in image_recs.items():
        nm, kind = key.split("/")
        report.append(entry(
            f"{nm}_2d/{kind}", hash_src,
            "none (no TPU kernel: human_body_reconstruction_tpu/ops/"
            "hash_encoding.py:259 hash_encode with cfg.dim 2, jnp gather and "
            "its autodiff scatter)", image_launches[nm], *rec,
            f"{image_shapes[kind]}; launches in the 500-step --image run; "
            "library: " + ("embedding_bag given rows and weights"
                           if nm == "hash_forward"
                           else "index_add_ given rows and terms")))
    short = {WIDE_MODES[0]: "r64", WIDE_MODES[1]: "l12", HASH_MODE: "exact"}
    for mode, (recs, launches, n, label) in wide_rows.items():
        for key, rec in recs.items():
            nm = key.removesuffix("_contiguous")
            where = ("its own contiguous output" if key != nm else
                     "the encoder's matrix" if nm.endswith("forward") else
                     "from a seeded cotangent")
            axis = nm == "cp_forward" and mode == WIDE_MODES[1]
            report.append(entry(
                f"{nm}/{short[mode]}_path" + ("_contiguous" if key != nm
                                              else ""),
                HASH_SOURCE if nm.startswith("hash") else SOURCE,
                REPLACES["cp_forward_axis" if axis else nm], launches[nm],
                *rec,
                f"{n} {label}, {where}; launches in its "
                f"{MODE_STEPS[mode]}-step protocol run"))
    for key, (rec, launches, shape) in shard_recs.items():
        nm = key.split("/")[0]
        report.append(entry(
            key, {"uniform_bits": "human_body_reconstruction_tpu_torch/csrc/"
                                  "rng.cu",
                  "hash_forward": HASH_SOURCE,
                  "hash_backward": HASH_SOURCE}.get(nm, SOURCE),
            REPLACES.get(nm, "human_body_reconstruction_tpu/ops/"
                             "pallas_rng.py:30"),
            launches, *rec, shape))
    report.extend(variant_report)
    report.extend(mlp_report)
    print("one-dispatch paths: " + json.dumps(
        {"windows": window_recs, "fused_wall_s": fused_walls}))
    print(f"smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
