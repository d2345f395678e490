"""numpy counterparts of the four OpenCV calls the capture front end makes
(the card's machine has no cv2), each computed as OpenCV 8-bit code
computes it, so that masks, thresholds and grey images are the library's
bit for bit:

  * ``rgb_to_hsv_u8``     cv2.cvtColor(img, COLOR_RGB2HSV), 8-bit fixed point
  * ``otsu_threshold_u8`` the threshold of cv2.threshold(..., THRESH_OTSU)
  * ``bgr_to_gray_u8``    cv2.cvtColor(img, COLOR_BGR2GRAY)
  * ``laplacian_var``     cv2.Laplacian(grey, CV_64F).var()

The segmentation's threshold backend reads the first two, the capture's
per-frame sharpness the last two.
"""

from __future__ import annotations

import numpy as np

_HSV_SHIFT = 12                      # cv2 RGB2HSV_b's fixed-point shift
# cv2's 8-bit grey weights: 0.114, 0.587, 0.299 in 15-bit fixed point,
# summing to 2^15 (its 14-bit YUV weights give another grey for 0.3% of
# colours)
_GRAY_SHIFT = 15
_B2Y, _G2Y, _R2Y = 3735, 19235, 9798
_FLT_EPSILON = float(np.finfo(np.float32).eps)


def _div_table(numerator: int) -> np.ndarray:
    """cv2's division tables: round(numerator / i) for i in 1..255, 0 at 0."""
    i = np.arange(1, 256, dtype=np.float64)
    return np.concatenate([[0], np.rint(numerator / i)]).astype(np.int64)


_SDIV = _div_table(255 << _HSV_SHIFT)
_HDIV = _div_table((180 << _HSV_SHIFT) / 6.0)


def rgb_to_hsv_u8(rgb: np.ndarray) -> np.ndarray:
    """uint8 (..., 3) RGB -> uint8 (..., 3) HSV, H in [0, 180)."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff,
                                         r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def otsu_threshold_u8(img: np.ndarray) -> float:
    """The threshold Otsu's method picks for uint8 ``img``: the first
    maximum of the between-class variance, in double precision, classes
    holding under FLT_EPSILON of the pixels skipped."""
    hist = np.bincount(img.reshape(-1), minlength=256)
    scale = 1.0 / img.size
    mu = 0.0
    for i in range(256):
        mu += i * float(hist[i])
    mu *= scale
    mu1 = q1 = max_sigma = max_val = 0.0
    for i in range(256):
        p_i = hist[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < _FLT_EPSILON or max(q1, q2) > 1.0 - _FLT_EPSILON:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, max_val = sigma, float(i)
    return max_val


def bgr_to_gray_u8(bgr: np.ndarray) -> np.ndarray:
    """uint8 (..., 3) BGR -> uint8 (...) grey, 15-bit fixed-point weights."""
    b, g, r = (bgr[..., k].astype(np.int64) for k in range(3))
    y = (b * _B2Y + g * _G2Y + r * _R2Y + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
    return y.astype(np.uint8)


def laplacian_var(gray: np.ndarray) -> float:
    """Variance of the 3x3 Laplacian [[0,1,0],[1,-4,1],[0,1,0]] of a grey
    (H, W) image in float64, borders reflected without repeating the edge
    (OpenCV's BORDER_REFLECT_101)."""
    p = np.pad(gray.astype(np.float64), 1, mode="reflect")
    lap = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
           - 4.0 * p[1:-1, 1:-1])
    return float(lap.var())
