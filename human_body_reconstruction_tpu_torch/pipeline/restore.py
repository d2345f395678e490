"""Run directory -> model (counterpart of the JAX pipeline/restore.py).

Restores, in one call, the pipeline config (``<model_name>_config.json``
preferred, CLI-flag reconstruction as fallback), the scene from the bounds
artifact, the field from a JAX-layout checkpoint (with the SDF sharpness
when the config has SDF mode), and optionally the occupancy grid saved in
the checkpoint's extras, all on ``device``.  near, far and
``hierarchical`` are the caller's (render-time choices), as in JAX.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch

from human_body_reconstruction_tpu_torch.models.nerf import Field, scene_from_bounds
from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt_lib
from human_body_reconstruction_tpu_torch.utils import config as C


@dataclasses.dataclass
class Restored:
    field: Field
    scene: dict
    cfg: C.PipelineConfig
    occ: Any                   # ops.occupancy.OccupancyGrid | None
    ckpt_path: str
    cfg_source: str            # "json" | "flags"


def load_config(ckpt_dir: str, model_name: str, *, near: float = 2.0,
                far: float = 6.0, hierarchical: bool = False,
                use_sdf: bool = False,
                max_res: float = 2048, hash_size: float = 16,
                encoder_variant: Optional[str] = None,
                rgb_elu: bool = False):
    """The persisted training config when present (near/far stay the
    caller's, and so is ``hierarchical``); otherwise one rebuilt from
    flags.  Returns (cfg, source)."""
    cfg_json = os.path.join(ckpt_dir, f"{model_name}_config.json")
    if os.path.exists(cfg_json):
        saved = C.from_json(cfg_json)
        cfg = dataclasses.replace(saved, render=dataclasses.replace(
            saved.render, near=near, far=far, hierarchical=hierarchical))
        source = "json"
    else:
        cfg = C.PipelineConfig(
            hash=C.HashConfig(n_max=int(max_res),
                              log2_table_size=int(hash_size),
                              variant=encoder_variant or "corner"),
            mlp=C.MLPConfig(
                density_activation="sdf" if use_sdf else "leaky_relu",
                rgb_activation="elu" if rgb_elu else "sigmoid"),
            render=C.RenderConfig(near=near, far=far, use_sdf=use_sdf,
                                  hierarchical=hierarchical))
        source = "flags"
    if encoder_variant and encoder_variant != cfg.hash.variant:
        cfg = dataclasses.replace(cfg, hash=dataclasses.replace(
            cfg.hash, variant=encoder_variant))
    return cfg, source


def find_checkpoint(ckpt_dir: str, model_name: str,
                    ckpt_name: str = "N_2048_T_16") -> str:
    """"<model_name>_ckpt.npz" or the reference-style "<ckpt_name>_ckpt.npz"."""
    candidates = [os.path.join(ckpt_dir, f"{model_name}_ckpt.npz"),
                  os.path.join(ckpt_dir, f"{ckpt_name}_ckpt.npz"),
                  f"{model_name}_ckpt.npz"]
    found = next((c for c in candidates if os.path.exists(c)), None)
    if found is None:
        raise FileNotFoundError(f"no checkpoint found in {candidates}")
    return found


def restore(ckpt_dir: str, model_name: str, *, device,
            bound_pth: str = "bounds_model.npy",
            ckpt_name: str = "N_2048_T_16", near: float = 2.0,
            far: float = 6.0, hierarchical: bool = False,
            use_sdf: bool = False, max_res: float = 2048,
            hash_size: float = 16, encoder_variant: Optional[str] = None,
            rgb_elu: bool = False, normalization: Optional[str] = None,
            with_occ: bool = False, log_fn=print) -> Restored:
    """(field, scene, cfg, occ) from a run directory, on ``device``."""
    device = torch.device(device)
    cfg, source = load_config(
        ckpt_dir, model_name, near=near, far=far,
        hierarchical=hierarchical, use_sdf=use_sdf,
        max_res=max_res, hash_size=hash_size,
        encoder_variant=encoder_variant, rgb_elu=rgb_elu)
    if source == "json":
        log_fn(f"restored model config from "
               f"{os.path.join(ckpt_dir, model_name + '_config.json')}")
    norm = normalization or (cfg.render.normalization
                             if source == "json" else "diagonal")
    bound_path = bound_pth
    if not os.path.exists(bound_path):
        bound_path = os.path.join(ckpt_dir, os.path.basename(bound_path))
    lo, hi = ckpt_lib.load_bounds(bound_path)
    scene = scene_from_bounds(lo, hi, norm, device=device)
    ckpt_path = find_checkpoint(ckpt_dir, model_name, ckpt_name)
    field = ckpt_lib.load_params(ckpt_path, Field(cfg)).to(device)
    log_fn(f"loaded {ckpt_path}")
    occ = ckpt_lib.load_occ(ckpt_path, device) if with_occ else None
    return Restored(field=field, scene=scene, cfg=cfg, occ=occ,
                    ckpt_path=ckpt_path, cfg_source=source)
