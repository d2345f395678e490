"""Eval-time image rendering (counterpart of ``render_chunk``,
``render_image_fused`` and ``render_poses_fused`` in the JAX
train/step.py).

The JAX package renders a frame as one compiled dispatch with a ``lax.map``
over chunks; here the chunk loop is eager PyTorch.  Rays are independent,
so the last chunk is simply shorter instead of padded.  ``bf16`` means what
it means in JAX: the MLP runs in bf16 compute with f32 accumulation.  The
training step is not ported yet.
"""

from __future__ import annotations

import torch

from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.ops import rays as rays_lib
from human_body_reconstruction_tpu_torch.utils.config import PipelineConfig


@torch.no_grad()
def render_chunk(field, scene, rays_o, rays_d, dir_norm, cfg: PipelineConfig,
                 occ=None, num_samples: int = 256, bf16: bool = False):
    """Colours (B, 3) of one ray chunk."""
    out = nerf.render_rays(field, scene, rays_o, rays_d, dir_norm, cfg,
                           num_samples=num_samples, occ=occ,
                           compute_dtype=torch.bfloat16 if bf16 else None)
    return out["fine"]


@torch.no_grad()
def render_rays_chunked(field, scene, o, d, n, cfg: PipelineConfig, occ=None,
                        num_samples: int = 256, chunk: int = 16384,
                        bf16: bool = False):
    """Colours (R, 3) of R rays, ``chunk`` rays per pass."""
    outs = [render_chunk(field, scene, o[s:s + chunk], d[s:s + chunk],
                         n[s:s + chunk], cfg, occ=occ,
                         num_samples=num_samples, bf16=bf16)
            for s in range(0, o.shape[0], chunk)]
    return torch.cat(outs)


def render_image(field, scene, H: int, W: int, K, c2w, cfg: PipelineConfig,
                 occ=None, num_samples: int = 256, chunk: int = 16384,
                 bf16: bool = False):
    """(H, W, 3) float32 image on the field's device."""
    o, d, n = rays_lib.full_image_rays(H, W, K, c2w)
    return render_rays_chunked(field, scene, o, d, n, cfg, occ=occ,
                               num_samples=num_samples, chunk=chunk,
                               bf16=bf16).reshape(H, W, 3)


def render_poses(field, scene, H: int, W: int, K, c2ws, cfg: PipelineConfig,
                 occ=None, num_samples: int = 256, chunk: int = 16384,
                 bf16: bool = False):
    """(P, H, W, 3) images of a pose stack (P, 4, 4).  The chunks tile the
    concatenated rays of all poses, so only the batch's last chunk is
    short."""
    o, d, n = rays_lib.full_image_rays(H, W, K, c2ws[:, None, :, :])
    P = c2ws.shape[0]
    img = render_rays_chunked(field, scene, o.reshape(-1, 3),
                              d.reshape(-1, 3), n.reshape(-1, 1), cfg,
                              occ=occ, num_samples=num_samples, chunk=chunk,
                              bf16=bf16)
    return img.reshape(P, H, W, 3)
