"""Procedural synthetic scenes (counterpart of the JAX data/synthetic.py).

Pose helpers (numpy), the analytic emissive volumes ``blob_field`` (smooth,
for small tests), ``textured_field`` (the hard scene of the zero-flag
trainer: a thin shell, three rods and a core under a 3-octave albedo),
``humanoid_field`` (a standing figure of capsules),
``textured_humanoid_field`` (the figure under the same albedo),
``tangle_field`` (the held-back family: seeded random capsules under a
seeded texture) and ``sphere_field`` (one solid sphere, the SDF subject),
and their ground-truth renders through the same compositing as the model.
The card's machine has no JAX, so the port renders its own ground truth;
the tangle's capsules and texture come from the JAX PRNG's draws, which
``utils/jax_prng.py`` reproduces in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.ops import compositing, sampling
from human_body_reconstruction_tpu_torch.ops import rays as rays_lib


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


def blob_field(pts):
    """Two coloured Gaussian blobs.  Returns (rgb (N, 3), sigma (N,))."""
    c1 = pts.new_tensor([0.35, 0.0, 0.0])
    c2 = pts.new_tensor([-0.35, 0.2, 0.1])
    s1 = 40.0 * torch.exp(-torch.sum((pts - c1) ** 2, dim=-1) / (2 * 0.3 ** 2))
    s2 = 30.0 * torch.exp(-torch.sum((pts - c2) ** 2, dim=-1) / (2 * 0.25 ** 2))
    sigma = s1 + s2
    w1 = s1 / (sigma + 1e-9)
    rgb = (w1[..., None] * pts.new_tensor([0.9, 0.3, 0.2])
           + (1 - w1)[..., None] * pts.new_tensor([0.2, 0.5, 0.9]))
    return rgb, sigma


def sphere_field(pts, radius: float = 0.6):
    """One solid sphere of ``radius`` with a smooth colour ramp; an SDF
    run's zero level set must sit at ``radius``.
    Returns (rgb (N, 3), sigma (N,))."""
    r = torch.linalg.vector_norm(pts, dim=-1)
    sigma = 80.0 * torch.sigmoid(-40.0 * (r - radius))
    rgb = torch.stack([0.75 + 0.2 * pts[:, 0], 0.45 + 0.2 * pts[:, 1],
                       0.35 + 0.2 * pts[:, 2]], dim=-1)
    return torch.clamp(rgb, 0.0, 1.0), sigma


def _capsule_dist(pts, a, b, r):
    """Distance from pts (N, 3) to the capsule with axis segment a-b,
    radius r."""
    a = pts.new_tensor(a)
    b = pts.new_tensor(b)
    ab = b - a
    t = torch.clamp((pts - a) @ ab / torch.dot(ab, ab), 0.0, 1.0)
    closest = a + t[:, None] * ab
    return torch.linalg.vector_norm(pts - closest, dim=-1) - r


# (a, b, radius, rgb): a stick figure ~1.6 units tall centred on the origin
_HUMANOID_PARTS = (
    ((0.0, 0.0, 0.55), (0.0, 0.0, 0.75), 0.13, (0.9, 0.75, 0.65)),   # head
    ((0.0, 0.0, 0.05), (0.0, 0.0, 0.45), 0.17, (0.2, 0.35, 0.7)),    # torso
    ((-0.16, 0.0, 0.42), (-0.42, 0.0, 0.05), 0.06, (0.9, 0.75, 0.65)),  # L arm
    ((0.16, 0.0, 0.42), (0.42, 0.0, 0.05), 0.06, (0.9, 0.75, 0.65)),   # R arm
    ((-0.09, 0.0, -0.05), (-0.12, 0.0, -0.75), 0.07, (0.25, 0.25, 0.3)),  # L leg
    ((0.09, 0.0, -0.05), (0.12, 0.0, -0.75), 0.07, (0.25, 0.25, 0.3)),   # R leg
)


def humanoid_field(pts):
    """A standing figure of six capsules: density falls off smoothly at
    each capsule's surface, colour comes from the nearest part.
    Returns (rgb (N, 3), sigma (N,))."""
    dists = torch.stack([_capsule_dist(pts, a, b, r)
                         for a, b, r, _ in _HUMANOID_PARTS], dim=-1)  # (N, P)
    colors = pts.new_tensor([c for _, _, _, c in _HUMANOID_PARTS])    # (P, 3)
    part_sigma = 50.0 * torch.sigmoid(-60.0 * dists)
    sigma = torch.sum(part_sigma, dim=-1)
    w = part_sigma / (sigma[:, None] + 1e-9)
    return w @ colors, sigma


def _albedo(pts):
    """The 3-octave incommensurate trig albedo (N, 3) of the textured
    scenes, base frequency 24 (wavelengths down to ~0.08 units)."""
    freq = 24.0
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]

    def octave(f, phase):
        return (torch.sin(f * x + phase) * torch.sin(f * 1.31 * y + 2.1 * phase)
                * torch.sin(f * 0.87 * z + 0.7 * phase))

    tex = (octave(freq, 0.0) + 0.5 * octave(2.3 * freq, 1.0),
           octave(1.7 * freq, 2.0) + 0.5 * octave(3.1 * freq, 0.4),
           octave(1.3 * freq, 4.0) + 0.5 * octave(2.7 * freq, 1.7))
    rgb = torch.stack([0.5 + 0.33 * t for t in tex], dim=-1)
    return torch.clamp(rgb, 0.0, 1.0)


def textured_humanoid_field(pts):
    """The humanoid's geometry under the textured scene's albedo: fine
    detail on thin limbs (radius ~0.06) instead of shells.
    Returns (rgb (N, 3), sigma (N,))."""
    return _albedo(pts), humanoid_field(pts)[1]


def textured_field(pts):
    """The hard scene: a thin shell at radius 0.85, three thin rods through
    the centre and a small core, under a 3-octave incommensurate trig
    albedo of base frequency 24 (wavelengths down to ~0.08 units).
    Returns (rgb (N, 3), sigma (N,))."""
    r = torch.linalg.vector_norm(pts, dim=-1)
    sharp = 200.0
    shell = torch.exp(-((r - 0.85) / 0.025) ** 2)
    rod_r = 0.03
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    rx = torch.sqrt(y ** 2 + z ** 2)
    ry = torch.sqrt(x ** 2 + z ** 2)
    rz = torch.sqrt(x ** 2 + y ** 2)
    inside = (r < 0.95).to(torch.float32)
    rods = (torch.sigmoid(-sharp * (rx - rod_r))
            + torch.sigmoid(-sharp * (ry - rod_r))
            + torch.sigmoid(-sharp * (rz - rod_r))) * inside
    core = torch.sigmoid(-sharp * (r - 0.18))
    sigma = 120.0 * shell + 90.0 * torch.clamp(rods, 0.0, 1.0) + 90.0 * core
    return _albedo(pts), sigma


# the tangle's per-channel octave frequency multipliers
_TANGLE_OCTAVES = np.array([[1.0, 2.3], [1.7, 3.1], [1.3, 2.7]], np.float32)


def tangle_params(seed: int = 0, n_capsules: int = 14, freq: float = 24.0):
    """The tangle's parameters as JAX draws them from ``PRNGKey(seed)``,
    numpy float32: capsule ends a, b (C, 3) and radii (C,); texture
    frequencies f, phases ph and axis stretches sx, (3, 2) each.  The key
    splits into five; the direction's key draws twice (a normal, then the
    length's uniform) and so does the phase's (ph, then sx)."""
    from human_body_reconstruction_tpu_torch.utils import jax_prng

    f32 = np.float32
    ka, kb, kr, kf, kp = jax_prng.split(jax_prng.prng_key(seed), 5)
    a = jax_prng.uniform(ka, (n_capsules, 3), -0.55, 0.55)
    step = jax_prng.normal(kb, (n_capsules, 3))
    norm = np.sqrt(np.sum(step * step, axis=-1, keepdims=True))
    step = step / (norm + f32(1e-9))
    ln = jax_prng.uniform(kb, (n_capsules, 1), 0.3, 0.8)
    b = np.clip(a + step * ln, f32(-0.8), f32(0.8))
    radii = jax_prng.uniform(kr, (n_capsules,), 0.03, 0.07)
    f = jax_prng.uniform(kf, (3, 2), 0.8, 1.4) * f32(freq) * _TANGLE_OCTAVES
    ph = jax_prng.uniform(kp, (3, 2), 0.0, 6.28)
    sx = jax_prng.uniform(kp, (3, 2), 0.8, 1.5)
    return {"a": a, "b": b, "radii": radii, "f": f, "ph": ph, "sx": sx}


def tangle_field(pts, seed: int = 0, n_capsules: int = 14,
                 freq: float = 24.0):
    """The held-back scene family: ``n_capsules`` thin capsules (radii
    0.03-0.07) at seeded places inside the ~0.85 ball, each a smooth
    density step of sharpness 200 at its surface, under a seeded 2-octave
    texture per channel (``tangle_params``).  Seeds of 100 and up are the
    held-back evaluations.  The (N, C, 3) intermediates are about 1 GB for
    a 16384-ray chunk of 384 samples, so callers chunk (``render_gt_image``
    does).  Returns (rgb (N, 3), sigma (N,))."""
    p = {k: torch.as_tensor(v, device=pts.device)
         for k, v in tangle_params(seed, n_capsules, freq).items()}
    a, ab = p["a"], p["b"] - p["a"]                                # (C, 3)
    t = torch.clamp((pts @ ab.T - torch.sum(a * ab, dim=-1)[None, :])
                    / (torch.sum(ab * ab, dim=-1)[None, :] + 1e-9),
                    0.0, 1.0)                                      # (N, C)
    closest = a[None, :, :] + t[..., None] * ab[None, :, :]        # (N, C, 3)
    dists = (torch.linalg.vector_norm(pts[:, None, :] - closest, dim=-1)
             - p["radii"][None, :])                                # (N, C)
    sigma = torch.sum(90.0 * torch.sigmoid(-200.0 * dists), dim=-1)

    def octave(fr, phase, s):
        return (torch.sin(fr * pts[:, 0] + phase)
                * torch.sin(fr * 1.31 * s * pts[:, 1] + 2.1 * phase)
                * torch.sin(fr * 0.87 * s * pts[:, 2] + 0.7 * phase))

    f, ph, sx = p["f"], p["ph"], p["sx"]
    rgb = torch.stack([0.5 + 0.33 * (octave(f[c, 0], ph[c, 0], sx[c, 0])
                                     + 0.5 * octave(f[c, 1], ph[c, 1],
                                                    sx[c, 1]))
                       for c in range(3)], dim=-1)
    return torch.clamp(rgb, 0.0, 1.0), sigma


@torch.no_grad()
def render_gt_image(H: int, W: int, K, c2w, field=blob_field,
                    near: float = 2.0, far: float = 6.0,
                    num_samples: int = 256):
    """Ground-truth (H, W, 3) render of an analytic field on K's device:
    dense uniform samples, 16384 rays at a time."""
    chunk_rays = 16384
    o, d, n = rays_lib.full_image_rays(H, W, K, c2w)
    t_row = sampling.linspace(near, far, num_samples, K.device)
    out = []
    for s in range(0, o.shape[0], chunk_rays):
        oc, dc, nc = o[s:s + chunk_rays], d[s:s + chunk_rays], n[s:s + chunk_rays]
        t = t_row.expand(oc.shape[0], num_samples)
        pts = oc[:, None, :] + dc[:, None, :] * t[..., None]
        rgb, sigma = field(pts.reshape(-1, 3))
        color, _, _ = compositing.composite(
            t, rgb.reshape(oc.shape[0], num_samples, 3),
            sigma.reshape(oc.shape[0], num_samples), nc)
        out.append(color)
    return torch.cat(out).reshape(H, W, 3)


def make_dataset(n_views: int = 8, H: int = 48, W: int = 48,
                 focal: float = 55.0, near: float = 2.0, far: float = 6.0,
                 field=blob_field, radius: float = 4.0,
                 elevation: float = 0.5, gt_samples: int = 0, device=None):
    """Synthetic dataset on ``device``: images (N, H, W, 3), c2ws
    (N, 4, 4), K (3, 3) as f32 tensors, plus H, W, near, far."""
    K = torch.tensor([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                     dtype=torch.float32, device=device)
    c2ws = torch.as_tensor(orbit_poses(n_views, radius=radius,
                                       elevation=elevation), device=device)
    kw = {"num_samples": gt_samples} if gt_samples else {}
    images = torch.stack([
        render_gt_image(H, W, K, c2ws[k], field=field, near=near, far=far,
                        **kw) for k in range(n_views)])
    return {"images": images, "c2ws": c2ws, "K": K, "H": H, "W": W,
            "near": near, "far": far}
