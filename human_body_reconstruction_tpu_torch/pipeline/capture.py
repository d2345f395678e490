"""Capture ingestion: video -> frames -> COLMAP SfM -> transforms.json.

Host-side orchestration with the same external-binary surface as the
reference (``colmap2nerf.py``): ffmpeg for frame extraction
(:57-93), the COLMAP CLI for feature extraction / matching / mapping /
bundle adjustment / TXT export (:95-140), then numpy pose normalisation
(pipeline/poses.py) and a transforms.json writer.  subprocess.run
replaces the reference's os.system strings.

An in-process pycolmap path (reference col_pipeline.py:30-33) is
provided behind an optional import.

The port's copy of the JAX module (tests/test_torch_capture.py holds the
transforms it builds equal to the original's).  Only ``image_sharpness``
differs: a PNG frame is read by ``data/png.py`` and scored by
``pipeline/image_ops.py`` (cv2's grey conversion and Laplacian, bit for bit),
so the card's machine, which has no cv2, scores PNG captures; other formats
go through cv2 where it is installed.  A missing ffmpeg or COLMAP binary
raises FileNotFoundError and a missing pycolmap ImportError, each naming
it.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
from typing import Optional, Sequence

import numpy as np

from human_body_reconstruction_tpu_torch.data import png
from human_body_reconstruction_tpu_torch.pipeline import image_ops
from human_body_reconstruction_tpu_torch.pipeline import poses as poses_lib


def _run(cmd: Sequence[str]):
    print("==== running:", " ".join(map(str, cmd)))
    subprocess.run(list(map(str, cmd)), check=True)


def run_ffmpeg(video_in: str, images_dir: str, fps: float = 2.0,
               time_slice: str = ""):
    """Extract frames (reference colmap2nerf.py:57-93)."""
    os.makedirs(images_dir, exist_ok=True)
    for f in os.listdir(images_dir):
        if f.endswith((".jpg", ".png")):
            os.remove(os.path.join(images_dir, f))
    vf = f"fps={fps}"
    if time_slice:
        t1, t2 = time_slice.split(",")
        vf += f",select='between(t\\,{t1}\\,{t2})'"
    _run(["ffmpeg", "-i", video_in, "-qscale:v", "1", "-qmin", "1",
          "-vf", vf, os.path.join(images_dir, "%04d.jpg")])


def run_colmap(images: str, db: str = "colmap.db",
               matcher: str = "sequential", camera_model: str = "OPENCV",
               camera_params: str = "", vocab_path: str = "",
               text: Optional[str] = None, colmap_binary: str = "colmap"):
    """SfM via the COLMAP CLI (reference colmap2nerf.py:95-140).

    Returns the TXT model directory.
    """
    db_noext = os.path.splitext(db)[0]
    sparse = db_noext + "_sparse"
    text = text or (db_noext + "_text")
    if os.path.exists(db):
        os.remove(db)
    _run([colmap_binary, "feature_extractor",
          "--ImageReader.camera_model", camera_model,
          "--ImageReader.camera_params", camera_params,
          "--SiftExtraction.estimate_affine_shape=true",
          "--SiftExtraction.domain_size_pooling=true",
          "--ImageReader.single_camera", "1",
          "--database_path", db, "--image_path", images])
    match_cmd = [colmap_binary, f"{matcher}_matcher",
                 "--SiftMatching.guided_matching=true",
                 "--database_path", db]
    if vocab_path:
        match_cmd += ["--VocabTreeMatching.vocab_tree_path", vocab_path]
    _run(match_cmd)
    shutil.rmtree(sparse, ignore_errors=True)
    os.makedirs(sparse, exist_ok=True)
    _run([colmap_binary, "mapper", "--database_path", db,
          "--image_path", images, "--output_path", sparse])
    _run([colmap_binary, "bundle_adjuster",
          "--input_path", f"{sparse}/0", "--output_path", f"{sparse}/0",
          "--BundleAdjustment.refine_principal_point", "1"])
    shutil.rmtree(text, ignore_errors=True)
    os.makedirs(text, exist_ok=True)
    _run([colmap_binary, "model_converter", "--input_path", f"{sparse}/0",
          "--output_path", text, "--output_type", "TXT"])
    return text


def run_pycolmap(images: str, out_dir: str):
    """In-process alternative (reference col_pipeline.py:30-33)."""
    import pycolmap  # optional dependency

    os.makedirs(out_dir, exist_ok=True)
    db = os.path.join(out_dir, "database.db")
    pycolmap.extract_features(db, images)
    pycolmap.match_exhaustive(db)
    maps = pycolmap.incremental_mapping(db, images, out_dir)
    maps[0].write(out_dir)
    return out_dir


def parse_cameras_txt(path: str) -> dict:
    """Intrinsics for the 8 COLMAP camera models
    (reference colmap2nerf.py:205-279)."""
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            el = line.split()
            model = el[1]
            w, h = float(el[2]), float(el[3])
            fl_x = fl_y = float(el[4])
            cx, cy = w / 2, h / 2
            k1 = k2 = k3 = k4 = p1 = p2 = 0.0
            is_fisheye = False
            if model == "SIMPLE_PINHOLE":
                cx, cy = float(el[5]), float(el[6])
            elif model == "PINHOLE":
                fl_y = float(el[5])
                cx, cy = float(el[6]), float(el[7])
            elif model == "SIMPLE_RADIAL":
                cx, cy, k1 = float(el[5]), float(el[6]), float(el[7])
            elif model == "RADIAL":
                cx, cy, k1, k2 = (float(el[5]), float(el[6]),
                                  float(el[7]), float(el[8]))
            elif model == "OPENCV":
                fl_y = float(el[5])
                cx, cy = float(el[6]), float(el[7])
                k1, k2, p1, p2 = (float(el[8]), float(el[9]),
                                  float(el[10]), float(el[11]))
            elif model == "SIMPLE_RADIAL_FISHEYE":
                is_fisheye = True
                cx, cy, k1 = float(el[5]), float(el[6]), float(el[7])
            elif model == "RADIAL_FISHEYE":
                is_fisheye = True
                cx, cy, k1, k2 = (float(el[5]), float(el[6]),
                                  float(el[7]), float(el[8]))
            elif model == "OPENCV_FISHEYE":
                is_fisheye = True
                fl_y = float(el[5])
                cx, cy = float(el[6]), float(el[7])
                k1, k2, k3, k4 = (float(el[8]), float(el[9]),
                                  float(el[10]), float(el[11]))
            else:
                raise ValueError(f"unknown camera model {model}")
            angle_x = math.atan(w / (fl_x * 2)) * 2
            angle_y = math.atan(h / (fl_y * 2)) * 2
            return {"camera_angle_x": angle_x, "camera_angle_y": angle_y,
                    "fl_x": fl_x, "fl_y": fl_y, "k1": k1, "k2": k2,
                    "k3": k3, "k4": k4, "p1": p1, "p2": p2,
                    "is_fisheye": is_fisheye, "cx": cx, "cy": cy,
                    "w": w, "h": h}
    raise ValueError(f"no camera found in {path}")


def parse_images_txt(path: str, skip_early: int = 0):
    """(name, qvec, tvec) per registered image
    (reference colmap2nerf.py:304-318: every other line is a pose line)."""
    out = []
    with open(path) as f:
        i = 0
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            i += 1
            if i < skip_early * 2:
                continue
            if i % 2 == 1:
                el = line.split(" ")
                name = "_".join(el[9:])
                qvec = np.array(list(map(float, el[1:5])))
                tvec = np.array(list(map(float, el[5:8])))
                out.append((name, qvec, tvec))
    return out


def image_sharpness(path: str) -> float:
    """Variance of the Laplacian (reference colmap2nerf.py:142-149); 0.0
    for a frame that is not there, as cv2.imread's None gives in JAX."""
    if path.lower().endswith(".png"):
        if not os.path.exists(path):
            return 0.0
        bgr = png.to_rgb(png.read_png(path))[..., ::-1]
        return image_ops.laplacian_var(image_ops.bgr_to_gray_u8(bgr))
    try:
        import cv2
    except ImportError:
        raise RuntimeError(f"{path}: the sharpness of a non-PNG frame needs "
                           "cv2, which is not installed; pass --no_sharpness"
                           ) from None
    img = cv2.imread(path)
    if img is None:
        return 0.0
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    return float(cv2.Laplacian(gray, cv2.CV_64F).var())


def build_transforms(text_dir: str, images_dir: str, *,
                     aabb_scale: int = 32, skip_early: int = 0,
                     keep_colmap_coords: bool = False,
                     compute_sharpness: bool = True,
                     json_dir: Optional[str] = None) -> dict:
    """COLMAP TXT model -> instant-ngp-style transforms dict.

    ``json_dir`` is the directory the transforms.json will be written
    in; frame file_path entries are made relative to it (the dataset
    reader resolves them against the json's own directory). Defaults to
    the CWD for backward compatibility.
    """
    intr = parse_cameras_txt(os.path.join(text_dir, "cameras.txt"))
    entries = parse_images_txt(os.path.join(text_dir, "images.txt"),
                               skip_early)
    if not entries:
        raise ValueError("no registered images in COLMAP model")

    names = [e[0] for e in entries]
    qvecs = np.stack([e[1] for e in entries])
    tvecs = np.stack([e[2] for e in entries])
    c2ws = poses_lib.colmap_to_c2w(qvecs, tvecs)
    if keep_colmap_coords:
        # flip to match the reference's keep-coords output
        # (colmap2nerf.py:342-349)
        c2ws = c2ws @ np.diag([1.0, -1.0, -1.0, 1.0])
    else:
        c2ws = poses_lib.colmap_axes_to_nerf(c2ws)
        c2ws = poses_lib.normalize_poses(c2ws)

    out = dict(intr)
    out["aabb_scale"] = aabb_scale
    out["frames"] = []
    rel = os.path.relpath(images_dir, json_dir or ".").replace(os.sep, "/")
    for k, name in enumerate(names):
        src = os.path.join(images_dir, name)
        frame = {"file_path": f"./{rel}/{name}",
                 "sharpness": (image_sharpness(src) if compute_sharpness
                               else 0.0),
                 "transform_matrix": c2ws[k].tolist()}
        out["frames"].append(frame)
    return out


def write_transforms(out: dict, path: str):
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
