"""PSNR curves of rendered frames (counterpart of the JAX cli/plot_psnr.py,
the reference's plot_psnr.py).

Same surface: ``--pred_dirs <dirs...> --gt_dirs <dirs...>``: the PSNR of
every PNG in each prediction directory against the first ground-truth
image (or, with ``--per_frame_gt``, against its own frame), then the curves
plotted to ``--out``.  The port adds ``--device`` (default cuda: without a
card the CLI exits unless given ``--device cpu``), where the PSNRs are
computed in f32.  PNGs are read through ``data/png.py``, so the
``MEAN_PSNR`` lines need neither Pillow nor matplotlib; they are printed
first.  The plot needs matplotlib: without it the CLI exits after the
numbers, naming it.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def psnr(pred: np.ndarray, gt: np.ndarray, normalize: bool = True,
         device="cpu") -> float:
    """10·log10(1 / mse) of two images, in f32 on ``device`` (uint8 images
    scaled to [0, 1] when ``normalize``)."""
    pred = torch.as_tensor(np.asarray(pred, np.float32), device=device)
    gt = torch.as_tensor(np.asarray(gt, np.float32), device=device)
    if normalize:
        pred, gt = pred / 255.0, gt / 255.0
    mse = float(torch.mean((pred - gt) ** 2))
    return float(10 * np.log10(1.0 / max(mse, 1e-12)))


def _imread(path: str) -> np.ndarray:
    from human_body_reconstruction_tpu_torch.data import png

    return png.to_rgb(png.read_png(path))


def psnr_dir(pred_dir: str, gt_dir: str, normalize: bool = True,
             per_frame_gt: bool = False, device="cpu") -> np.ndarray:
    """The PSNR of each PNG of ``pred_dir`` (sorted) against the first PNG
    of ``gt_dir``, or its own frame there with ``per_frame_gt`` (the last
    when there are fewer); empty when either directory has none."""
    preds = sorted(glob.glob(os.path.join(pred_dir, "*.png")))
    gts = sorted(glob.glob(os.path.join(gt_dir, "*.png")))
    if not preds or not gts:
        return np.zeros(0)
    out = []
    for i, p in enumerate(preds):
        g = gts[min(i, len(gts) - 1)] if per_frame_gt else gts[0]
        out.append(psnr(_imread(p), _imread(g), normalize, device))
    return np.asarray(out)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--pred_dirs", type=str, nargs="+",
                   help="Give list of pred directories")
    p.add_argument("--gt_dirs", type=str, nargs="+",
                   help="Give list of gt directories")
    p.add_argument("--out", type=str, default="psnr.png")
    p.add_argument("--x_scale", type=int, default=40,
                   help="epochs per written frame (reference uses 40)")
    p.add_argument("--per_frame_gt", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, or cpu to run without a card)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from human_body_reconstruction_tpu_torch.cli import device_from_flag

    device = device_from_flag(args.device)
    gt_dir = args.gt_dirs[0]
    curves = {d: psnr_dir(d, gt_dir, per_frame_gt=args.per_frame_gt,
                          device=device) for d in args.pred_dirs}
    for d, c in curves.items():
        if not len(c):
            print(f"warning: no PNGs for {d}")
            continue
        print(f"MEAN_PSNR for {d}: {c[-1]:.3f} (final), {c.mean():.3f} (mean)")
    try:
        import matplotlib
    except ImportError:
        raise SystemExit(f"the plot ({args.out}) needs matplotlib, which is "
                         "not installed; the PSNRs above are complete") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    min_len = min((len(c) for c in curves.values() if len(c)), default=0)
    plt.figure(figsize=(8, 5))
    for d, c in curves.items():
        if len(c):
            plt.plot(np.arange(min_len) * args.x_scale, c[:min_len], "-o",
                     label=d)
    plt.title("PSNR vs Epochs")
    plt.xlabel("Epochs")
    plt.ylabel("PSNR")
    plt.legend()
    plt.savefig(args.out)
    plt.close()
    print(f"wrote {args.out}")
    return curves


if __name__ == "__main__":
    main()
