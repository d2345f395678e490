"""Vanilla positional-encoding NeRF trainer (counterpart of the JAX
cli/train_vanilla.py, the working equivalent of the reference's
``train.py``).

Model: ``ClassicNeRF``, 8x256 with the skip concat after layer 4 and the
view-direction branch, over ``positional_encode`` (``--pe_mode``, 10
frequencies) of positions and directions, starting from the JAX CLI's
initial weights (``init_classic_nerf(PRNGKey(0))``, drawn in numpy by
``utils/jax_prng.py``); Adam on ``cosine_to_floor(lr, lr_final,
num_iters)``; each step one random training image and
``--batch`` random pixels of it, ``--num_samples`` stratified samples a
ray.  The flags are the JAX CLI's, plus ``--device`` (default cuda: without
a card the CLI exits unless given ``--device cpu``).

Data: an ``.npz`` with ``images``, ``poses`` and ``focal`` (``--data``,
the reference's ``tiny_nerf_data.npz``) when it exists, else the procedural
scene (10 views of the blobs at 64x64); the last view is the test view.
Writes ``<model>.npz`` in the JAX pytree layout (the JAX ``load_pytree``
reads it) and, with ``--write``, renders the test view in chunks of 4096
rays to ``<model>_test.png`` and prints its PSNR.

Run:  python -m human_body_reconstruction_tpu_torch.cli.train_vanilla \\
          --synthetic --num_iters 300
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description="Train vanilla NeRF")
    p.add_argument("--data", type=str, default="tiny_nerf_data.npz")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num_iters", type=int, default=1000)
    p.add_argument("--num_freq", type=int, default=10)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--near", type=float, default=2.0)
    p.add_argument("--far", type=float, default=6.0)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--lr_final", type=float, default=5e-4)
    p.add_argument("--out_dir", type=str, default="results")
    p.add_argument("--model_name", type=str, default="Nerf")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--write", action="store_true")
    p.add_argument("--pe_mode", type=str, default="linear",
                   choices=["linear", "nerf"],
                   help="'linear' matches the reference encoder exactly")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, or cpu to run without a card)")
    return p


def load_data(args, device):
    """{images (N, H, W, 3), c2ws (N, 4, 4), K (3, 3), H, W} on ``device``."""
    if not args.synthetic and os.path.exists(args.data):
        with np.load(args.data) as data:
            images = np.asarray(data["images"][..., :3], np.float32)
            c2ws = np.asarray(data["poses"], np.float32)
            focal = float(data["focal"])
        H, W = images.shape[1:3]
        K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                     np.float32)
        return {"images": torch.as_tensor(images, device=device),
                "c2ws": torch.as_tensor(c2ws, device=device),
                "K": torch.as_tensor(K, device=device), "H": H, "W": W}
    from human_body_reconstruction_tpu_torch.data import synthetic

    return synthetic.make_dataset(n_views=10, H=64, W=64, near=args.near,
                                  far=args.far, device=device)


def model_config(args):
    from human_body_reconstruction_tpu_torch.utils.config import ClassicNeRFConfig

    d_enc = 3 * args.num_freq * 2
    return ClassicNeRFConfig(d_input=d_enc, d_viewdirs=d_enc)


def render(model, rays_o, rays_d, dir_norm, args, *, t=None, jitter=True,
           generator=None):
    """Colours (B, 3) of B rays: stratified samples (``t`` (B, S) replaces
    them), both positional encodings, the ClassicNeRF, compositing."""
    from human_body_reconstruction_tpu_torch.ops import (
        compositing, positional, sampling)

    B = rays_o.shape[0]
    if t is None:
        t = sampling.stratified_ts((B,), args.near, args.far,
                                   args.num_samples, device=rays_o.device,
                                   jitter=jitter, generator=generator)
    S = t.shape[-1]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    x = positional.positional_encode(pts.reshape(-1, 3), args.num_freq,
                                     args.pe_mode)
    v = positional.positional_encode(rays_d, args.num_freq, args.pe_mode)
    v = v[:, None, :].expand(B, S, v.shape[-1]).reshape(B * S, -1)
    rgb, alpha = model(x, viewdirs=v)
    color, _, _ = compositing.composite(t, rgb.reshape(B, S, 3),
                                        alpha.reshape(B, S), dir_norm)
    return color


def batch_loss(model, ds, img_idx, pix, args, *, t=None, generator=None):
    """MSE of the rays through pixels ``pix`` (flat indices) of image
    ``img_idx`` (a 0-d tensor)."""
    from human_body_reconstruction_tpu_torch.ops import rays as rays_lib

    W = ds["W"]
    j, i = pix // W, pix % W
    o, d, n = rays_lib.rays_for_pixels(i, j, ds["K"], ds["c2ws"][img_idx])
    gt = ds["images"][img_idx, j, i]
    color = render(model, o, d, n, args, t=t, generator=generator)
    return torch.mean((color - gt) ** 2)


def train_step(model, opt, lr: float, ds, args, generator, draws=None):
    """One update at learning rate ``lr`` on a random training image's
    random pixels; ``draws`` (image index (0-d), flat pixel indices (B,),
    sample depths t (B, S)) replace the random draws.  Returns the loss
    (detached)."""
    dev = ds["images"].device
    if draws is None:
        n_train = ds["images"].shape[0] - 1
        img_idx = torch.randint(0, n_train, (), generator=generator,
                                device=dev)
        pix = torch.randint(0, ds["H"] * ds["W"], (args.batch,),
                            generator=generator, device=dev)
        t = None
    else:
        img_idx, pix, t = draws
    loss = batch_loss(model, ds, img_idx, pix, args, t=t,
                      generator=generator)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    return loss.detach()


@torch.no_grad()
def render_view(model, ds, index: int, args, chunk: int = 4096):
    """(H, W, 3) render of view ``index`` on the unjittered ladder."""
    from human_body_reconstruction_tpu_torch.ops import rays as rays_lib

    o, d, n = rays_lib.full_image_rays(ds["H"], ds["W"], ds["K"],
                                       ds["c2ws"][index])
    outs = [render(model, o[s:s + chunk], d[s:s + chunk], n[s:s + chunk],
                   args, jitter=False) for s in range(0, o.shape[0], chunk)]
    return torch.cat(outs).reshape(ds["H"], ds["W"], 3)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from human_body_reconstruction_tpu_torch.cli import device_from_flag, psnr
    from human_body_reconstruction_tpu_torch.models import mlp as mlp_lib
    from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
    from human_body_reconstruction_tpu_torch.train.state import cosine_to_floor
    from human_body_reconstruction_tpu_torch.utils import jax_prng

    device = device_from_flag(args.device)
    ds = load_data(args, device)
    cfg = model_config(args)
    model = mlp_lib.classic_nerf_from_jax(
        mlp_lib.init_classic_nerf(jax_prng.prng_key(0), cfg), cfg, device)
    gen = torch.Generator(device).manual_seed(0)
    sched = cosine_to_floor(args.lr, args.lr_final, args.num_iters)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)

    os.makedirs(args.out_dir, exist_ok=True)
    train_s = 0.0
    for it in range(args.num_iters):
        t0 = time.perf_counter()
        loss = train_step(model, opt, sched(it), ds, args, gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_s += time.perf_counter() - t0
        if args.log_every and (it + 1) % args.log_every == 0:
            loss_f = float(loss)
            p = -10 * np.log10(max(loss_f, 1e-12))
            print(f"iter {it+1:5d}  loss {loss_f:.5f}  psnr {p:.2f}")
    print(f"{args.num_iters} iterations of {args.batch} rays x "
          f"{args.num_samples} samples in {train_s:.3f} s "
          f"({1e3 * train_s / max(args.num_iters, 1):.3f} ms a step)")

    path = os.path.join(args.out_dir, f"{args.model_name}.npz")
    ckpt.save_pytree(path, mlp_lib.to_jax_tree(model))
    out = {"train_s": train_s, "steps": args.num_iters, "path": path}
    if args.write:
        from human_body_reconstruction_tpu_torch.data import png

        test_idx = ds["images"].shape[0] - 1
        img = render_view(model, ds, test_idx, args).cpu().numpy()
        out["test_psnr"] = psnr(img, ds["images"][test_idx].cpu().numpy())
        png.write_png(os.path.join(args.out_dir, f"{args.model_name}_test.png"),
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))
        print(f"test view PSNR {out['test_psnr']:.2f} dB")
    print(f"saved {path}")
    return out


if __name__ == "__main__":
    main()
