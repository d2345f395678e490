"""Segmentation CLI — the reference drives Segment.py by editing
config.yaml and running the module (Segment.py:111); here the same
config.yaml keys (segmentation.input/output, config.yaml:1-5) drive an
explicit CLI with selectable backends.

The port's copy of the JAX CLI, flag for flag, over the port's
``pipeline/segment.py``: the threshold backend needs neither cv2 nor Pillow
for PNG frames; grabcut needs cv2, deeplab and sam torchvision and their
weights, --config yaml.

Run:  python -m human_body_reconstruction_tpu_torch.cli.segment \
          --input images --output SegmentedImages --backend threshold
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="Segment capture images")
    p.add_argument("--config", type=str, default="config.yaml",
                   help="yaml with segmentation.input/output keys")
    p.add_argument("--input", type=str, default=None,
                   help="override: image glob or directory")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--backend", type=str, default="grabcut",
                   choices=["grabcut", "threshold", "deeplab", "sam"])
    p.add_argument("--no_contact_sheet", action="store_true")
    return p


def main(argv=None):
    import os

    from human_body_reconstruction_tpu_torch.pipeline import segment

    args = build_parser().parse_args(argv)
    inp, out = args.input, args.output
    if (inp is None or out is None) and os.path.exists(args.config):
        cfg = segment.load_config(args.config)
        inp = inp or cfg["input"]
        out = out or cfg["output"]
    if inp is None:
        raise SystemExit("need --input or a config.yaml")
    if os.path.isdir(inp):
        inp = os.path.join(inp, "*")
    written = segment.segment_images(
        inp, out or "./SegmentedImages", backend=args.backend,
        contact_sheet=not args.no_contact_sheet)
    print(f"wrote {len(written)} masked images")


if __name__ == "__main__":
    main()
