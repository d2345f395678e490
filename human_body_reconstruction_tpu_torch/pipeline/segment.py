"""Human/foreground segmentation producing masked training images.

Capability parity with reference ``Segment.py``: glob images from
``config.yaml``'s ``segmentation.input`` (Segment.py:13-14, 28), compute
a foreground mask per image, multiply it into the image and write the
results plus a contact sheet (Segment.py:96-109).

Mask backends (the capability to preserve is *masked training images*,
not any specific model — SURVEY.md section 2.3):

  * ``sam``      — Mask-R-CNN box prompt -> SAM ViT-H predictor with
                   box + centre-point prompt (reference Segment.py:69-96).
                   Requires the optional ``segment_anything`` package and
                   downloaded weights; cleanly gated.
  * ``deeplab``  — DeepLabV3-ResNet101, keep class 15 (person)
                   (reference Segment.py:29-67).  Requires torchvision
                   pretrained weights; gated.
  * ``grabcut``  — cv2 GrabCut seeded with a centred prior box; runs
                   fully offline (default in this environment).
  * ``threshold``— Otsu on saturation+value; cheapest fallback.

The port's copy of the JAX module, written for a machine without cv2 and
Pillow (the card's): the threshold backend computes cv2's 8-bit HSV and
Otsu threshold in numpy (``pipeline/image_ops.py``, its masks equal to the
JAX module's); PNG frames are read and the masked frames written by
``data/png.py``, other formats need Pillow; GrabCut needs cv2 and is
refused by name without it; the contact sheet needs Pillow's thumbnail and
is left out, with one line printed, without it (no later stage reads it).
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np

from human_body_reconstruction_tpu_torch.data import png
from human_body_reconstruction_tpu_torch.pipeline import image_ops


def load_config(path: str = "config.yaml") -> dict:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    seg = cfg.get("segmentation", {})
    return {"input": seg.get("input", "./images"),
            "output": seg.get("output", "./SegmentedImages"),
            "h": seg.get("h"), "w": seg.get("w")}


# ---------------------------------------------------------------------------
# mask backends
# ---------------------------------------------------------------------------

def center_prior_box(h: int, w: int, frac: float = 0.8):
    """Heuristic subject box centred in the frame (portrait-capture prior)."""
    bw, bh = int(w * frac), int(h * 0.95)
    x0 = (w - bw) // 2
    y0 = (h - bh) // 2
    return (x0, y0, x0 + bw, y0 + bh)


def mask_grabcut(img: np.ndarray, box=None, iters: int = 5) -> np.ndarray:
    """cv2 GrabCut with a prior box; offline-capable default backend."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            "the grabcut backend needs cv2, which is not installed; use the "
            "threshold backend (--segment_backend threshold in reconstruct, "
            "--backend threshold in segment)") from None

    h, w = img.shape[:2]
    box = box or center_prior_box(h, w)
    mask = np.zeros((h, w), np.uint8)
    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    rect = (box[0], box[1], box[2] - box[0], box[3] - box[1])
    img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8) if img.dtype != np.uint8 else img
    try:
        cv2.grabCut(img8, mask, rect, bgd, fgd, iters,
                    cv2.GC_INIT_WITH_RECT)
    except cv2.error:
        m = np.zeros((h, w), np.float32)
        m[box[1]:box[3], box[0]:box[2]] = 1.0
        return m
    return ((mask == cv2.GC_FGD) | (mask == cv2.GC_PR_FGD)).astype(np.float32)


def mask_threshold(img: np.ndarray) -> np.ndarray:
    """Otsu threshold on saturation*value — crude offline fallback."""
    img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8) if img.dtype != np.uint8 else img
    hsv = image_ops.rgb_to_hsv_u8(img8)
    score = (hsv[..., 1].astype(np.float32) *
             hsv[..., 2].astype(np.float32) / 255.0).astype(np.uint8)
    return (score > image_ops.otsu_threshold_u8(score)).astype(np.float32)


def mask_deeplab(img: np.ndarray, person_class: int = 15) -> np.ndarray:
    """DeepLabV3 person mask (reference Segment.py:29-67). Gated."""
    try:
        import torch
        from torchvision.models.segmentation import deeplabv3_resnet101
        from torchvision import transforms as T
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "deeplab backend needs torchvision with pretrained weights; "
            "use --backend grabcut in offline environments") from e
    model = deeplabv3_resnet101(pretrained=True).eval()
    img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8) if img.dtype != np.uint8 else img
    x = T.Compose([
        T.ToTensor(),
        T.Normalize(mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225]),
    ])(img8)[None]
    with torch.no_grad():
        out = model(x)["out"][0].argmax(0).numpy()
    return (out == person_class).astype(np.float32)


def mask_sam(img: np.ndarray, checkpoint: str = "sam_vit_h_4b8939.pth"
             ) -> np.ndarray:
    """Mask-R-CNN box -> SAM box+centre prompt (reference Segment.py:69-96).
    Gated on segment_anything + weights."""
    try:
        import torch
        import torchvision
        from segment_anything import SamPredictor, sam_model_registry
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "sam backend needs the segment_anything package and a ViT-H "
            "checkpoint; use --backend grabcut in offline environments"
        ) from e
    img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8) if img.dtype != np.uint8 else img
    det = torchvision.models.detection.maskrcnn_resnet50_fpn(
        pretrained=True).eval()
    with torch.no_grad():
        pred = det([torch.from_numpy(img8).permute(2, 0, 1).float() / 255])
    boxes = pred[0]["boxes"].numpy()
    box = boxes[0] if len(boxes) else np.asarray(
        center_prior_box(img8.shape[0], img8.shape[1]), np.float32)
    sam = sam_model_registry["vit_h"](checkpoint=checkpoint)
    predictor = SamPredictor(sam)
    predictor.set_image(img8)
    center = np.asarray([[(box[0] + box[2]) / 2, (box[1] + box[3]) / 2]])
    masks, _, _ = predictor.predict(
        point_coords=center, point_labels=np.asarray([1]),
        box=box[None], multimask_output=False)
    return masks[0].astype(np.float32)


BACKENDS = {"grabcut": mask_grabcut, "threshold": mask_threshold,
            "deeplab": mask_deeplab, "sam": mask_sam}


# ---------------------------------------------------------------------------
# the segmentation loop
# ---------------------------------------------------------------------------

def _read_rgb(path: str) -> np.ndarray:
    if path.lower().endswith(".png"):
        return png.to_rgb(png.read_png(path))
    return np.asarray(_pil(path).open(path).convert("RGB"), np.uint8)


def _write_rgb(path: str, img8: np.ndarray):
    if path.lower().endswith(".png"):
        png.write_png(path, img8)
    else:
        _pil(path).fromarray(img8).save(path)


def _pil(path: str):
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: this format needs Pillow, which is not "
                           "installed (PNG frames need nothing)") from None
    return Image


def segment_images(input_glob: str, output_dir: str, backend: str = "grabcut",
                   contact_sheet: bool = True, paths: Optional[Sequence[str]] = None):
    """Mask every image and write masked copies + a contact sheet.

    Returns the list of written file paths.
    """
    fn = BACKENDS[backend]
    files = sorted(paths if paths is not None else glob.glob(input_glob))
    if not files:
        raise FileNotFoundError(f"no images match {input_glob}")
    if contact_sheet:
        try:
            from PIL import Image
        except ImportError:
            print("contact sheet left out: it needs Pillow, which is not "
                  "installed")
            contact_sheet = False
    out_dir = os.path.join(output_dir, backend.upper())
    os.makedirs(out_dir, exist_ok=True)
    written = []
    thumbs = []
    for p in files:
        img = _read_rgb(p)
        m = fn(img)
        masked = (img.astype(np.float32) * m[..., None]).astype(np.uint8)
        out_p = os.path.join(out_dir, os.path.basename(p))
        _write_rgb(out_p, masked)
        written.append(out_p)
        if contact_sheet:
            t = Image.fromarray(masked)
            t.thumbnail((128, 128))
            thumbs.append(np.asarray(t))
    if contact_sheet and thumbs:
        h = max(t.shape[0] for t in thumbs)
        w = max(t.shape[1] for t in thumbs)
        cols = int(np.ceil(np.sqrt(len(thumbs))))
        rows = int(np.ceil(len(thumbs) / cols))
        sheet = np.zeros((rows * h, cols * w, 3), np.uint8)
        for i, t in enumerate(thumbs):
            r, c = divmod(i, cols)
            sheet[r * h:r * h + t.shape[0], c * w:c * w + t.shape[1]] = t
        Image.fromarray(sheet).save(
            os.path.join(output_dir, f"contact_{backend}.png"))
    return written
