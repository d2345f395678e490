"""The training step and eval-time image rendering (counterpart of
``sample_ray_batch``, ``loss_fn``, ``train_step``, ``render_chunk``,
``render_image_fused`` and ``render_poses_fused`` in the JAX
train/step.py).

A training step samples a batch of (image, pixel) rays on the device,
renders them on the training branch of ``nerf.render_rays``, takes the
loss (MSE coarse + MSE fine, the eikonal term in SDF mode, the
factor-line TV after its warmup, the density L1 when weighted), back-propagates through the encoder kernels and
applies the grouped optimizer.  The MLP computes in
``cfg.train.compute_dtype`` (bf16 operands, f32 accumulation).

The JAX package renders a frame as one compiled dispatch with a ``lax.map``
over chunks; here the chunk loop is eager PyTorch.  Rays are independent,
so the last chunk is simply shorter instead of padded.  ``bf16`` means what
it means in JAX: the MLP runs in bf16 compute with f32 accumulation.
"""

from __future__ import annotations

import torch

from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.ops import compositing
from human_body_reconstruction_tpu_torch.ops import rays as rays_lib
from human_body_reconstruction_tpu_torch.utils.config import PipelineConfig


def sample_ray_batch(images, c2ws, K, batch: int, generator=None,
                     img_idx=None, pix_idx=None):
    """Uniformly sample ``batch`` (image, pixel) pairs and build their
    rays.  images (N, H, W, 3) f32 and c2ws (N, 4, 4) on the device;
    ``img_idx``/``pix_idx`` (batch,) replace the draws.  Returns (rays_o,
    rays_d, dir_norm, gt)."""
    N, H, W = images.shape[:3]
    dev = images.device
    if img_idx is None:
        img_idx = torch.randint(0, N, (batch,), generator=generator,
                                device=dev)
    if pix_idx is None:
        pix_idx = torch.randint(0, H * W, (batch,), generator=generator,
                                device=dev)
    j, i = pix_idx // W, pix_idx % W
    o, d, n = rays_lib.rays_for_pixels(i, j, K, c2ws[img_idx])
    return o, d, n, images[img_idx, j, i]


def loss_fn(field, scene, batch, cfg: PipelineConfig, occ=None,
            compute_dtype=None, step=None, generator=None, draws=None,
            placement=None, enc_generator=None):
    """(loss, aux) of one ray batch, as the JAX ``loss_fn``.  ``step``
    (the update count) gates the factor-line TV by ``cfg.train.cp_tv_warmup``;
    ``draws``, ``placement`` and ``enc_generator`` go to ``render_rays``.
    On a rank-parallel field (``field.lp``) the TV of the rank's line
    slices, normalised by the global rank, is summed over the level group
    (``field.lp.psum``), so loss and aux are the single-device values on
    every rank."""
    rays_o, rays_d, dir_norm, gt = batch
    out = nerf.render_rays(field, scene, rays_o, rays_d, dir_norm, cfg,
                           occ=occ, compute_dtype=compute_dtype, jitter=True,
                           generator=generator, draws=draws,
                           placement=placement, enc_generator=enc_generator)
    mse = torch.mean((out["fine"] - gt) ** 2)
    loss = torch.mean((out["coarse"] - gt) ** 2) + mse
    aux = {"mse": mse}
    tc = cfg.train
    if cfg.render.use_sdf:
        eik = nerf.eikonal_loss(out["eikonal_norm"])
        loss = loss + tc.eikonal_weight * eik
        aux["eikonal"] = eik
    if tc.cp_tv_weight > 0.0 and len(field.lines):
        # normalised by the global rank (JAX: exact under rank parallelism)
        rank = cfg.hash.cp_rank
        tv = sum(torch.sum((ln[:, 1:, :] - ln[:, :-1, :]) ** 2)
                 / (ln.shape[0] * (ln.shape[1] - 1) * rank)
                 for ln in field.lines) / len(field.lines)
        if field.lp is not None:
            tv = field.lp.psum(tv)
        if tc.cp_tv_warmup <= 0 or step is None or step >= tc.cp_tv_warmup:
            loss = loss + tc.cp_tv_weight * tv
        aux["cp_tv"] = tv
    if tc.sigma_l1_weight > 0.0:
        sl1 = torch.mean(torch.clamp(out["density"], min=0.0))
        loss = loss + tc.sigma_l1_weight * sl1
        aux["sigma_l1"] = sl1
    aux["psnr"] = compositing.psnr(out["fine"], gt)
    return loss, aux


def train_step(state, scene, images, c2ws, K, cfg: PipelineConfig,
               batch_size: int, generator=None, enc_generator=None):
    """One optimization step, in place on ``state`` (its field, optimizer
    and step count).  Returns the metrics (detached tensors).  The
    stochastic encoder draws from ``enc_generator`` when given, else from
    ``generator``."""
    batch = sample_ray_batch(images, c2ws, K, batch_size, generator)
    state.opt.zero_grad()
    compute_dtype = (torch.bfloat16 if cfg.train.compute_dtype == "bfloat16"
                     else None)
    loss, aux = loss_fn(state.field, scene, batch, cfg, state.occ,
                        compute_dtype, step=state.step, generator=generator,
                        enc_generator=enc_generator)
    loss.backward()
    state.opt.step(state.step)
    state.step += 1
    return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}


@torch.no_grad()
def render_chunk(field, scene, rays_o, rays_d, dir_norm, cfg: PipelineConfig,
                 occ=None, num_samples: int = 256, hierarchical: bool = False,
                 bf16: bool = False, draws=None):
    """Colours (B, 3) of one ray chunk: the second pass's with
    ``hierarchical`` (whose quantiles ``draws["fine_u"]`` may give)."""
    out = nerf.render_rays(field, scene, rays_o, rays_d, dir_norm, cfg,
                           num_samples=num_samples, hierarchical=hierarchical,
                           occ=occ, draws=draws,
                           compute_dtype=torch.bfloat16 if bf16 else None)
    return out["fine"]


def fine_quantiles(cfg: PipelineConfig, num_samples: int, chunk: int, device):
    """The eval second pass's quantiles (chunk, n_fine), U[0, 1 - 1e-6) from
    a generator seeded 0: the JAX render functions hand every chunk one
    fixed key, so every chunk draws the same."""
    n_fine = cfg.render.num_fine_samples or num_samples
    gen = torch.Generator(device).manual_seed(0)
    return torch.rand((chunk, n_fine), generator=gen,
                      device=device) * (1.0 - 1e-6)


@torch.no_grad()
def render_rays_chunked(field, scene, o, d, n, cfg: PipelineConfig, occ=None,
                        num_samples: int = 256, chunk: int = 16384,
                        hierarchical: bool = False, bf16: bool = False):
    """Colours (R, 3) of R rays, ``chunk`` rays per pass."""
    u = (fine_quantiles(cfg, num_samples, min(chunk, o.shape[0]), o.device)
         if hierarchical else None)
    outs = [render_chunk(field, scene, o[s:s + chunk], d[s:s + chunk],
                         n[s:s + chunk], cfg, occ=occ,
                         num_samples=num_samples, hierarchical=hierarchical,
                         bf16=bf16,
                         draws=None if u is None else {
                             "fine_u": u[:o[s:s + chunk].shape[0]]})
            for s in range(0, o.shape[0], chunk)]
    return torch.cat(outs)


def render_image(field, scene, H: int, W: int, K, c2w, cfg: PipelineConfig,
                 occ=None, num_samples: int = 256, hierarchical: bool = False,
                 chunk: int = 16384, bf16: bool = False):
    """(H, W, 3) float32 image on the field's device.  ``hierarchical``
    (not ``cfg.render.hierarchical``, as in JAX) asks for the second
    pass."""
    o, d, n = rays_lib.full_image_rays(H, W, K, c2w)
    return render_rays_chunked(field, scene, o, d, n, cfg, occ=occ,
                               num_samples=num_samples, chunk=chunk,
                               hierarchical=hierarchical,
                               bf16=bf16).reshape(H, W, 3)


def render_poses(field, scene, H: int, W: int, K, c2ws, cfg: PipelineConfig,
                 occ=None, num_samples: int = 256, hierarchical: bool = False,
                 chunk: int = 16384, bf16: bool = False):
    """(P, H, W, 3) images of a pose stack (P, 4, 4).  The chunks tile the
    concatenated rays of all poses, so only the batch's last chunk is
    short."""
    o, d, n = rays_lib.full_image_rays(H, W, K, c2ws[:, None, :, :])
    P = c2ws.shape[0]
    img = render_rays_chunked(field, scene, o.reshape(-1, 3),
                              d.reshape(-1, 3), n.reshape(-1, 1), cfg,
                              occ=occ, num_samples=num_samples, chunk=chunk,
                              hierarchical=hierarchical, bf16=bf16)
    return img.reshape(P, H, W, 3)
