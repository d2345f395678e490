"""Camera pose math for COLMAP -> NeRF ingestion (pure numpy, host-side).

Capability parity with the pose pipeline in reference
``colmap2nerf.py:151-191, 304-385``: quaternion -> rotation, COLMAP
world-to-camera -> NeRF camera-to-world with axis convention flips,
scene reorientation (mean camera-up to +z), recentring on the mutual
look-at point and rescaling the average camera distance to 4.0.

Differences (deliberate):
  * everything is vectorised over the pose stack,
  * the "centre of attention" solves the least-squares closest point to
    all optical axes in closed form (normal equations) instead of the
    reference's O(N^2) pairwise closest-point accumulation
    (colmap2nerf.py:179-191, 361-377) — same point, exact, O(N).
"""

from __future__ import annotations

import numpy as np


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion(s) -> rotation matrix(es).

    Accepts (..., 4); returns (..., 3, 3).
    """
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def colmap_to_c2w(qvecs: np.ndarray, tvecs: np.ndarray) -> np.ndarray:
    """COLMAP world-to-camera (R(q), t) -> camera-to-world (N, 4, 4)."""
    R = qvec2rotmat(qvecs)                      # (N, 3, 3) world->cam
    Rt = np.swapaxes(R, -1, -2)                 # inverse rotation
    t = np.asarray(tvecs, np.float64)[..., None]
    c = -Rt @ t                                 # camera centre
    N = R.shape[0] if R.ndim == 3 else 1
    c2w = np.tile(np.eye(4), (N, 1, 1))
    c2w[:, :3, :3] = Rt.reshape(N, 3, 3)
    c2w[:, :3, 3:] = c.reshape(N, 3, 1)
    return c2w


# The instant-ngp / reference axis convention change
# (colmap2nerf.py:330-334): flip camera y/z columns, then permute world
# axes (x<->y) and negate world z.
_WORLD_PERM = np.array([[0, 1, 0, 0],
                        [1, 0, 0, 0],
                        [0, 0, -1, 0],
                        [0, 0, 0, 1]], np.float64)
_CAM_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


def colmap_axes_to_nerf(c2ws: np.ndarray) -> np.ndarray:
    """(N, 4, 4) COLMAP-convention c2w -> NeRF/instant-ngp convention."""
    return _WORLD_PERM @ c2ws @ _CAM_FLIP


def rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit direction a to b (Rodrigues)."""
    a = np.asarray(a, np.float64) / np.linalg.norm(a)
    b = np.asarray(b, np.float64) / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1 + 1e-10:
        # opposite directions: rotate 180 deg about any orthogonal axis
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-8:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis /= np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        return np.eye(3) + 2.0 * K @ K
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    s2 = float(np.dot(v, v))
    return np.eye(3) + K + K @ K * ((1 - c) / (s2 + 1e-12))


def center_of_attention(c2ws: np.ndarray) -> np.ndarray:
    """Least-squares point closest to every camera's optical axis.

    Each camera looks along -z in NeRF convention, i.e. the axis through
    origin o_i with direction d_i = -c2w[:3, 2].  Minimising
    sum_i ||(I - d d^T)(p - o)||^2 gives the normal equations
    (sum_i (I - d d^T)) p = sum_i (I - d d^T) o.
    """
    o = c2ws[:, :3, 3]
    d = -c2ws[:, :3, 2]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    P = np.eye(3)[None] - d[:, :, None] * d[:, None, :]   # (N, 3, 3)
    A = P.sum(axis=0)
    b = np.einsum("nij,nj->i", P, o)
    try:
        return np.linalg.solve(A, b)
    except np.linalg.LinAlgError:
        return o.mean(axis=0)


def normalize_poses(c2ws: np.ndarray, target_dist: float = 4.0
                    ) -> np.ndarray:
    """Reorient (mean camera up -> +z), recentre on the mutual look-at
    point, rescale mean camera distance to ``target_dist``
    (reference colmap2nerf.py:350-385)."""
    c2ws = np.asarray(c2ws, np.float64).copy()
    up = c2ws[:, :3, 1].sum(axis=0)
    up /= np.linalg.norm(up)
    R = np.eye(4)
    R[:3, :3] = rotation_between(up, np.array([0.0, 0.0, 1.0]))
    c2ws = R[None] @ c2ws

    center = center_of_attention(c2ws)
    c2ws[:, :3, 3] -= center

    avglen = np.mean(np.linalg.norm(c2ws[:, :3, 3], axis=-1))
    if avglen > 0:
        c2ws[:, :3, 3] *= target_dist / avglen
    return c2ws
