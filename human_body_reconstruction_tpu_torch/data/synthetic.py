"""Camera poses for synthetic views (numpy; the pose helpers of the JAX
data/synthetic.py, whose scene renderers are not ported)."""

from __future__ import annotations

import numpy as np


def look_at_pose(eye, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)):
    """OpenGL-style c2w (camera looks down its -z) as (4, 4) float32."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = eye - target
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = fwd
    c2w[:3, 3] = eye
    return c2w


def orbit_poses(n: int, radius: float = 4.0, elevation: float = 0.5):
    """n poses on a circle around the origin at the given elevation."""
    poses = []
    for k in range(n):
        th = 2 * np.pi * k / n
        eye = (radius * np.cos(th), radius * np.sin(th), elevation * radius)
        poses.append(look_at_pose(eye))
    return np.stack(poses)
