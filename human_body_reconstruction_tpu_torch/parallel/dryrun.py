"""A dry run of every parallel path over whatever world it is given
(counterpart of the JAX ``__graft_entry__.dryrun_multichip``): one
data-parallel step and then a window of 2 (on the card a captured step
replayed, its collectives inside), the sample-split render in density and
SDF mode over a (data, sample) layout, and one level-parallel step and a
window of 2 of the hash grid and of the CP factor lines over a (data,
level) layout, at tiny shapes; each checked finite.  The hash block pins
a level count that the level extent divides, and raises when the kernels'
level limit leaves none (the JAX dry run skipped the block when its 4
levels did not divide).

Run:  python -m human_body_reconstruction_tpu_torch.parallel.dryrun \\
          --world 2 --device cpu
      (or under ``torchrun --nproc_per_node N``, one process per card)
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import torch
import torch.distributed as dist

from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.ops import cuda_lib
from human_body_reconstruction_tpu_torch.parallel import comm
from human_body_reconstruction_tpu_torch.parallel import data_parallel as dp
from human_body_reconstruction_tpu_torch.parallel import level_parallel as lp
from human_body_reconstruction_tpu_torch.parallel import sample_parallel as sp
from human_body_reconstruction_tpu_torch.train import state as state_lib
from human_body_reconstruction_tpu_torch.utils import config as C


WINDOW = 2              # the steps of each path's window


def _check(cond, what):
    if not cond:
        raise RuntimeError(f"dry run: {what}")


def _layout(world: int):
    """(n_data, n_inner): a quarter of the world (at least 1) on data, the
    largest such count that divides the world."""
    n_d = max(world // 4, 1)
    while world % n_d:
        n_d -= 1
    return n_d, world // n_d


def pinned_levels(n_level: int, at_least: int = 4) -> int:
    """The fewest hashed levels, at least ``at_least``, that the level
    extent divides; raises when that passes the kernels' limit."""
    levels = n_level * math.ceil(at_least / n_level)
    if levels > cuda_lib.MAX_LEVELS:
        raise ValueError(f"no level count of at most {cuda_lib.MAX_LEVELS} "
                         f"that the level extent {n_level} divides")
    return levels


def dryrun(device: torch.device) -> dict:
    """Every path once on the current world; returns each path's loss or
    mean colour."""
    world = dist.get_world_size()
    cfg = C.PipelineConfig(
        hash=C.HashConfig(num_levels=4, log2_table_size=10, n_min=4,
                          n_max=64),
        render=C.RenderConfig(num_samples=16),
        train=C.TrainConfig(ray_batch=32 * world))
    gen = torch.Generator(device).manual_seed(0)
    scene = {"mu": torch.full((3,), -4.0, device=device),
             "sigma": torch.tensor(13.8, device=device),
             "min_bound": torch.full((3,), -4.0, device=device),
             "max_bound": torch.full((3,), 4.0, device=device)}
    images = torch.rand((2, 16, 16, 3), generator=gen, device=device)
    c2ws = torch.eye(4, device=device).expand(2, 4, 4).contiguous()
    K = torch.tensor([[20.0, 0, 8.0], [0, 20.0, 8.0], [0, 0, 1]],
                     device=device)
    out = {}

    state = state_lib.create_train_state(nerf.Field(cfg, generator=gen),
                                         cfg.train, 10)
    dp.replicate(state)
    for name, n in (("dp_loss", 1), ("dp_window_loss", WINDOW)):
        step = dp.make_dp_train_step(cfg, cfg.train.ray_batch, dp.make_mesh(),
                                     steps_per_call=n)
        before = state.step
        out[name] = float(step(state, scene, images, c2ws, K)["loss"])
        _check(math.isfinite(out[name]) and state.step == before + n,
               ("data-parallel step", name, out[name], state.step))

    n_d, n_inner = _layout(world)
    mesh = sp.make_sp_mesh(n_d, n_inner)
    B = 8 * n_d
    d = torch.randn((B, 3), generator=gen, device=device)
    dn = torch.linalg.vector_norm(d, dim=-1)
    o = torch.zeros((B, 3), device=device)
    cfg_sdf = dataclasses.replace(
        cfg, mlp=dataclasses.replace(cfg.mlp, density_activation="sdf"),
        render=dataclasses.replace(cfg.render, use_sdf=True))
    for name, c, field in (
            ("sp_density", cfg, state.field),
            ("sp_sdf", cfg_sdf, nerf.Field(cfg_sdf, generator=gen))):
        render = sp.make_sp_render(c, mesh, num_samples=16 * n_inner)
        rgb = render(field, scene, o, d / dn[:, None], dn)
        _check(rgb.shape == (B, 3) and bool(torch.isfinite(rgb).all()),
               (name, tuple(rgb.shape)))
        out[name] = float(rgb.mean())

    mesh = lp.make_lp_mesh(n_d, n_inner)
    hash_cfg = dataclasses.replace(cfg, hash=dataclasses.replace(
        cfg.hash, num_levels=pinned_levels(n_inner)))
    cp_rank = n_inner * math.ceil(8 / n_inner)
    cp_cfg = dataclasses.replace(cfg, hash=dataclasses.replace(
        cfg.hash, variant="cp", cp_rank=cp_rank))
    for name, c in (("lp_hash_loss", hash_cfg), ("lp_cp_loss", cp_cfg)):
        whole = state_lib.create_train_state(nerf.Field(c, generator=gen),
                                             c.train, 10)
        dp.replicate(whole)
        local = lp.shard_lp_state(whole, c, mesh, 10)
        for key, n in ((name, 1), (name.replace("_loss", "_window_loss"),
                                   WINDOW)):
            m = lp.make_lp_train_step(c, c.train.ray_batch, mesh,
                                      steps_per_call=n)(
                local, scene, images, c2ws, K)
            out[key] = float(m["loss"])
            _check(math.isfinite(out[key]), (key, out[key]))
        _check(local.step == 1 + WINDOW, (name, local.step))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, default=2,
                   help="processes to spawn (ignored under torchrun)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if comm.torchrun_env():
        device = comm.init(args.device)
        try:
            results = [dryrun(device)]
        finally:
            dist.destroy_process_group()
    else:
        results = comm.spawn(dryrun, args.world, device_type=args.device)
    print(results[0])
    return results


if __name__ == "__main__":
    main()
