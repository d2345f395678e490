"""2-D image fit through the hash grid (counterpart of the JAX
cli/image_fit.py, the reference's ``test_hash.py`` testbed): overfit one
image with a 2-D hash encoding and ``MLP2D``, report the PSNR.

The flags are the JAX CLI's, plus ``--device`` (default cuda: without a
card the CLI exits unless given ``--device cpu``).  Defaults mirror the
reference: L 16, F 2, T 2^18, n_min 16, n_max 2^16, sigma the image size
(W, H), 200,000-pixel batches.  ``--image`` is read as PNG through
``data/png.py``; another format needs Pillow and is refused by name without
it.  Without an image on disk, or with ``--synthetic``, the target is the
JAX CLI's procedural 256x256 one.  The table and the MLP start from the
JAX CLI's own initial values (``PRNGKey(0)``, drawn in numpy by
``utils/jax_prng.py``): the head's output ReLU never revives a channel
whose output starts negative everywhere, and with torch's generator at
seed 0 one of the three does (13.5 dB where JAX's start reaches 32.7 at
the test's size).  Each step draws ``batch`` pixels (from a generator on
the device, seeded 0), encodes their (x, y) through
``encode_params`` (the table alone: the 2-D build of the hash kernels on
the card) and takes Adam (eps 1e-15) on the table and AdamW (optax's
default decay 1e-4) on the MLP at constant rates.  ``imagefit_<step>.png``
(``--write_every``) and ``imagefit_final.png`` are the whole image's
prediction; the last line printed is the final full-image PSNR.

Run:  python -m human_body_reconstruction_tpu_torch.cli.image_fit \\
          --image mountain.png --steps 300
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description="2D hash-encoding image fit")
    p.add_argument("--image", type=str, default="mountain.png")
    p.add_argument("--synthetic", action="store_true",
                   help="procedural target if no image on disk")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch", type=int, default=200000)
    p.add_argument("--hash_size", type=int, default=18)
    p.add_argument("--levels", type=int, default=16)
    p.add_argument("--n_max", type=int, default=2 ** 16)
    p.add_argument("--lr_embed", type=float, default=0.01)
    p.add_argument("--lr_mlp", type=float, default=0.01)
    p.add_argument("--out_dir", type=str, default="results")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--write_every", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, or cpu to run without a card)")
    return p


def procedural_target(size: int = 256) -> np.ndarray:
    """The JAX CLI's float32 target, smooth colour gradients and rings,
    sampled at size x size (the CLI's is 256)."""
    y, x = np.mgrid[0:size, 0:size] / size
    return np.stack([
        0.5 + 0.5 * np.sin(12 * x) * np.cos(9 * y),
        (x + y) / 2,
        0.5 + 0.5 * np.cos(20 * np.sqrt((x - .5) ** 2 + (y - .5) ** 2)),
    ], axis=-1).astype(np.float32)


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]: PNG through ``data/png.py``, any other
    format through Pillow."""
    from human_body_reconstruction_tpu_torch.data import png

    if path.lower().endswith(".png"):
        img8 = png.to_rgb(png.read_png(path))
    else:
        try:
            from PIL import Image
        except ImportError:
            raise SystemExit(f"{path}: this format needs Pillow, which is "
                             "not installed (PNG images need nothing)") from None
        img8 = np.asarray(Image.open(path).convert("RGB"))
    return img8.astype(np.float32) / 255.0


def make_config(args):
    from human_body_reconstruction_tpu_torch.utils.config import HashConfig

    return HashConfig(num_levels=args.levels, features_per_level=2,
                      log2_table_size=args.hash_size, n_min=16,
                      n_max=args.n_max, dim=2)


def init_params(cfg, device):
    """(table parameter, MLP2D) on ``device``, the JAX CLI's initial
    values: ``init_table`` and ``init_mlp2d`` from the split of
    ``PRNGKey(0)``."""
    from human_body_reconstruction_tpu_torch.models import mlp as mlp_lib
    from human_body_reconstruction_tpu_torch.utils import jax_prng

    k1, k2 = jax_prng.split(jax_prng.prng_key(0))
    table = jax_prng.uniform(
        k1, (cfg.num_hashed_levels, cfg.table_size, cfg.payload),
        -cfg.init_scale, cfg.init_scale)
    return (torch.nn.Parameter(torch.tensor(table, device=device)),
            mlp_lib.mlp2d_from_jax(mlp_lib.init_mlp2d(k2, cfg.out_dim),
                                   device))


def pixel_coords(pix, W: int):
    """Flat pixel indices -> (N, 2) f32 (x, y), the column fastest."""
    return torch.stack([(pix % W).to(torch.float32),
                        (pix // W).to(torch.float32)], -1)


def predict(table, mlp, ij, sigma, cfg):
    """RGB (N, 3) of pixel coordinates ij through the hash grid and MLP2D."""
    from human_body_reconstruction_tpu_torch.ops import hash_encoding

    feats = hash_encoding.encode_params({"table": table}, ij, 0.0, sigma, cfg)
    return mlp(feats)


def make_optimizers(table, mlp, args):
    """Adam (eps 1e-15) on the table, AdamW (optax's default decay) on the
    MLP, at constant rates."""
    from human_body_reconstruction_tpu_torch.train.state import OPTAX_ADAMW_DECAY

    return (torch.optim.Adam([table], lr=args.lr_embed, eps=1e-15),
            torch.optim.AdamW(mlp.parameters(), lr=args.lr_mlp,
                              weight_decay=OPTAX_ADAMW_DECAY))


def fit_step(table, mlp, opts, target, pix, sigma, cfg):
    """One update on the pixels ``pix`` (flat indices into the (H, W, 3)
    target); returns the batch's loss (detached)."""
    W = target.shape[1]
    gt = target[pix // W, pix % W]
    loss = torch.mean((predict(table, mlp, pixel_coords(pix, W), sigma,
                               cfg) - gt) ** 2)
    for opt in opts:
        opt.zero_grad(set_to_none=True)
    loss.backward()
    for opt in opts:
        opt.step()
    return loss.detach()


@torch.no_grad()
def full_pred(table, mlp, H: int, W: int, sigma, cfg):
    """The whole image's prediction (H, W, 3), one encoder call."""
    pix = torch.arange(H * W, device=table.device)
    return predict(table, mlp, pixel_coords(pix, W), sigma,
                   cfg).reshape(H, W, 3)


def _write(path: str, pred):
    from human_body_reconstruction_tpu_torch.data import png

    png.write_png(path, (np.clip(pred.cpu().numpy(), 0, 1) * 255)
                  .astype(np.uint8))


def main(argv=None):
    args = build_parser().parse_args(argv)
    from human_body_reconstruction_tpu_torch.cli import device_from_flag, psnr

    device = device_from_flag(args.device)
    if not args.synthetic and os.path.exists(args.image):
        img = read_image(args.image)
    else:
        img = procedural_target()
    H, W = img.shape[:2]
    cfg = make_config(args)
    table, mlp = init_params(cfg, device)
    opts = make_optimizers(table, mlp, args)
    gen = torch.Generator(device).manual_seed(0)
    target = torch.as_tensor(img, device=device)
    # pixel coordinates scaled by sigma = (W, H), as the reference does
    sigma = torch.tensor([W, H], dtype=torch.float32, device=device)
    batch = min(args.batch, H * W)

    os.makedirs(args.out_dir, exist_ok=True)
    train_s = 0.0
    for it in range(args.steps):
        t0 = time.perf_counter()
        pix = torch.randint(0, H * W, (batch,), generator=gen, device=device)
        loss = fit_step(table, mlp, opts, target, pix, sigma, cfg)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_s += time.perf_counter() - t0
        if args.log_every and (it + 1) % args.log_every == 0:
            loss_f = float(loss)
            p = -10 * np.log10(max(loss_f, 1e-12))
            print(f"step {it+1:5d}  loss {loss_f:.6f}  psnr {p:.2f}")
        if args.write_every and (it + 1) % args.write_every == 0:
            _write(os.path.join(args.out_dir, f"imagefit_{it+1}.png"),
                   full_pred(table, mlp, H, W, sigma, cfg))
    pred = full_pred(table, mlp, H, W, sigma, cfg)
    _write(os.path.join(args.out_dir, "imagefit_final.png"), pred)
    final = psnr(pred.cpu().numpy(), img)
    print(f"{args.steps} steps of {batch} pixels in {train_s:.3f} s "
          f"({1e3 * train_s / max(args.steps, 1):.3f} ms a step)")
    print(f"final full-image PSNR: {final:.2f} dB")
    return {"psnr": final, "train_s": train_s, "steps": args.steps,
            "batch": batch, "H": H, "W": W, "table": table, "mlp": mlp,
            "sigma": sigma, "cfg": cfg}


if __name__ == "__main__":
    main()
