"""COCO-category instance masking for the capture pipeline.

Capability parity with the reference's detectron2 block
(reference colmap2nerf.py:394-440): given ``--mask_categories``
(COCO names, e.g. "person car"), run an instance-segmentation model on
every frame of a transforms.json, union the masks of the requested
categories, write ``dynamic_mask_<frame>.png`` next to each image and
record a ``mask_path`` on the frame entry.

Differences by design:
  * the detector is a pluggable backend — default is torchvision's
    Mask R-CNN (already COCO-trained, no detectron2 install-at-runtime
    as the reference does); tests inject a fake,
  * offline environments get a clear error listing alternatives instead
    of the reference's interactive pip-install prompt,
  * mask_path is stored in the transforms (instant-ngp consumes it);
    the reference wrote the files but never recorded them.

The port's copy of the JAX module: PNG frames are read, and the masks
(always PNG) written, by ``data/png.py``, so neither needs cv2 or Pillow;
other frame formats are read through cv2, else Pillow, as in JAX.  The
torchvision detector stays gated; tests inject a fake.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, List, Optional

import numpy as np

from human_body_reconstruction_tpu_torch.data import png

# The 91-entry COCO detection label map used by torchvision's COCO
# models (paper ordering; index = model class id; "N/A" slots are
# unpopulated ids in the original annotation set).
COCO_CATEGORIES = [
    "__background__", "person", "bicycle", "car", "motorcycle", "airplane",
    "bus", "train", "truck", "boat", "traffic light", "fire hydrant", "N/A",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "N/A",
    "backpack", "umbrella", "N/A", "N/A", "handbag", "tie", "suitcase",
    "frisbee", "skis", "snowboard", "sports ball", "kite", "baseball bat",
    "baseball glove", "skateboard", "surfboard", "tennis racket", "bottle",
    "N/A", "wine glass", "cup", "fork", "knife", "spoon", "bowl", "banana",
    "apple", "sandwich", "orange", "broccoli", "carrot", "hot dog", "pizza",
    "donut", "cake", "chair", "couch", "potted plant", "bed", "N/A",
    "dining table", "N/A", "N/A", "toilet", "N/A", "tv", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "microwave", "oven", "toaster",
    "sink", "refrigerator", "N/A", "book", "clock", "vase", "scissors",
    "teddy bear", "hair drier", "toothbrush",
]


def category_ids(names: Iterable[str]) -> List[int]:
    """COCO names -> model class ids; raises on unknown names with the
    list of valid ones (the reference KeyErrors opaquely)."""
    ids = []
    for name in names:
        key = name.strip().lower()
        if key not in COCO_CATEGORIES or key in ("n/a", "__background__"):
            valid = [c for c in COCO_CATEGORIES
                     if c not in ("N/A", "__background__")]
            raise ValueError(
                f"unknown COCO category '{name}'; valid: {', '.join(valid)}")
        ids.append(COCO_CATEGORIES.index(key))
    return ids


# A detector backend maps an RGB uint8 image (H, W, 3) to a list of
# (class_id, score, bool mask (H, W)) tuples.
DetectorFn = Callable[[np.ndarray], List[tuple]]


def torchvision_detector(score_thresh: float = 0.5) -> DetectorFn:
    """COCO Mask R-CNN via torchvision (the reference uses detectron2's
    mask_rcnn_R_50_FPN_3x — same family, same label space).  Needs the
    pretrained weights on disk/downloadable; offline hosts raise with
    guidance."""
    try:
        import torch
        import torchvision
    except ImportError as e:  # pragma: no cover - env without torchvision
        raise RuntimeError(
            "category masking needs torchvision's Mask R-CNN; install "
            "torchvision or pass a custom detector") from e
    try:
        model = torchvision.models.detection.maskrcnn_resnet50_fpn(
            weights="DEFAULT")
    except Exception as e:  # pragma: no cover - offline
        raise RuntimeError(
            "could not load Mask R-CNN COCO weights (offline?); "
            "alternatives: run with pre-computed masks via the segment "
            "CLI, or pass a custom detector function") from e
    model.eval()

    def detect(img: np.ndarray) -> List[tuple]:
        with torch.no_grad():
            x = torch.from_numpy(img.astype(np.float32) / 255.0)
            out = model([x.permute(2, 0, 1)])[0]
        res = []
        for cid, score, mask in zip(out["labels"].numpy(),
                                    out["scores"].numpy(),
                                    out["masks"].numpy()):
            if score >= score_thresh:
                res.append((int(cid), float(score), mask[0] > 0.5))
        return res

    return detect


def mask_name_for(image_path: str) -> str:
    """dynamic_mask_<name>.png next to the image (reference
    colmap2nerf.py:438-439 naming, any raster extension -> .png)."""
    d, b = os.path.split(image_path)
    stem = os.path.splitext(b)[0]
    return os.path.join(d, f"dynamic_mask_{stem}.png")


def _read_rgb(path: str) -> np.ndarray:
    if path.lower().endswith(".png"):
        return png.to_rgb(png.read_png(path))
    try:
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return img[..., ::-1].copy()
    except ImportError:  # pragma: no cover
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))


def _write_gray(path: str, mask01: np.ndarray):
    png.write_png(path, (mask01.astype(np.uint8)) * 255)


def apply_mask_categories(transforms: dict, categories: Iterable[str],
                          json_dir: str,
                          detector: Optional[DetectorFn] = None,
                          score_thresh: float = 0.5) -> dict:
    """Write dynamic masks for every frame; annotate frames in place.

    Args:
      transforms: the transforms.json dict (frames carry ``file_path``
        relative to ``json_dir``).
      categories: COCO category names to mask out.
      json_dir: directory the transforms.json lives in.
      detector: injectable backend; defaults to torchvision Mask R-CNN.
    Returns:
      the same dict with per-frame ``mask_path`` entries added.
    """
    ids = set(category_ids(categories))
    if detector is None:
        detector = torchvision_detector(score_thresh)
    for frame in transforms["frames"]:
        img_path = os.path.join(json_dir, frame["file_path"])
        img = _read_rgb(img_path)
        union = np.zeros(img.shape[:2], bool)
        for cid, score, mask in detector(img):
            if cid in ids:
                union |= np.asarray(mask, bool)
        mpath = mask_name_for(img_path)
        _write_gray(mpath, union)
        frame["mask_path"] = os.path.relpath(mpath, json_dir)
    return transforms
