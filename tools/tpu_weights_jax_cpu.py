"""Score the TPU-trained SDF weights with the JAX package on the CPU.

Loads ``qm_params_cp_r21_sdf_guided_es16k.npz`` and
``qm_params_cp_r21_sdf_guided_xla_es16k.npz`` (the quality matrix's
``--save_params`` output) into their ``make_modes`` configs and scores the
4-pose holdout as ``scripts/quality_matrix.py`` does (400x400, no
occupancy, 128 exact samples, the ground truth at 384 samples), over every
4th pixel of each pose in row-major order (40,000 rays a pose).  Writes
one JSON object: per mode the per-pose PSNR on those pixels, their mean,
and the record the quality matrix wrote for the same weights.  It is the
reference that ``chip_smoke.py`` holds the port's score of the same
weights on the same pixels to; a CPU measurement, not a speed.

Run:  JAX_PLATFORMS=cpu PYTHONPATH=. python tools/tpu_weights_jax_cpu.py \\
          --out tpu_weights_jax_cpu.json
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"cp_r21_sdf_guided_es16k": "qm_r5_sdf_pallas_600.json",
         "cp_r21_sdf_guided_xla_es16k": "qm_r5_sdf_xla_textured.json"}
H = W = 400
STRIDE = 4
CHUNK = 4096


def quality_matrix():
    spec = importlib.util.spec_from_file_location(
        "quality_matrix", os.path.join(REPO, "scripts", "quality_matrix.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="tpu_weights_jax_cpu.json")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")

    from human_body_reconstruction_tpu.data import synthetic
    from human_body_reconstruction_tpu.ops import dense_grid
    from human_body_reconstruction_tpu.ops import rays as rays_lib
    from human_body_reconstruction_tpu.train import checkpoint
    from human_body_reconstruction_tpu.train import step as step_lib
    from human_body_reconstruction_tpu.train import trainer
    from human_body_reconstruction_tpu.utils import config as C

    qm = quality_matrix()
    focal = 1.1 * H
    K = jnp.asarray([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                    jnp.float32)
    orbit = synthetic.orbit_poses(21, radius=4.0, elevation=0.35)
    hold = np.stack([orbit[20]] + [synthetic.look_at_pose(e)
                                   for e in qm.HOLDOUT_EYES if e is not None])
    lo, hi = rays_lib.scene_bounds(H, W, K, jnp.asarray(orbit[:20]), 2.0, 6.0)
    scene = {"mu": lo, "sigma": jnp.sqrt(jnp.sum((hi - lo) ** 2)),
             "min_bound": lo, "max_bound": hi}
    t0 = time.time()
    gts = [synthetic.render_gt_image(H, W, K, p, field=synthetic.textured_field,
                                     num_samples=384).reshape(-1, 3)[::STRIDE]
           for p in hold]
    print(f"ground truth in {time.time() - t0:.0f} s", flush=True)
    result = {"pixels_per_pose": int(gts[0].shape[0]), "stride": STRIDE,
              "samples": 128, "height": H, "device": "cpu (JAX)"}
    for mode, record in MODES.items():
        cfg = qm.make_modes(C, dense_grid)[mode]
        eval_cfg = dataclasses.replace(
            cfg, hash=dataclasses.replace(cfg.hash, stochastic_train=False),
            render=dataclasses.replace(cfg.render, occupancy=False,
                                       compact_samples=0, occ_guided=False))
        template = trainer.init_params(jax.random.PRNGKey(0), cfg)
        params, _ = checkpoint.load_pytree(
            os.path.join(REPO, f"qm_params_{mode}.npz"), template)
        per_pose = {}
        for name, pose, gt in zip(qm.HOLDOUT_NAMES, hold, gts):
            o, d, n = (a.reshape(-1, a.shape[-1])[::STRIDE] for a in
                       rays_lib.full_image_rays(H, W, K, jnp.asarray(pose)))
            img = np.concatenate([np.asarray(step_lib.render_chunk(
                params, scene, o[s:s + CHUNK], d[s:s + CHUNK],
                n[s:s + CHUNK], jax.random.PRNGKey(0), cfg=eval_cfg,
                num_samples=128)) for s in range(0, o.shape[0], CHUNK)])
            mse = float(np.mean((img - gt) ** 2))
            per_pose[name] = 10 * np.log10(1.0 / max(mse, 1e-12))
            print(f"{mode} {name}: {per_pose[name]:.4f} dB "
                  f"({time.time() - t0:.0f} s)", flush=True)
        with open(os.path.join(REPO, record)) as f:
            rec = json.load(f)[mode]
        result[mode] = {"per_pose_psnr": per_pose,
                        "mean_psnr": float(np.mean(list(per_pose.values()))),
                        "record": record,
                        "record_per_pose": rec["holdout_per_pose"],
                        "record_steps": rec["steps"]}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
