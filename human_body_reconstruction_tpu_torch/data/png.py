"""PNG decode and encode in numpy and zlib (the port's stand-in for Pillow's
PNG codec, which the card's machine lacks).

``decode_png`` reads non-interlaced 8-bit PNGs of the four direct colour
types (grey, grey+alpha, RGB, RGBA) with any of the five row filters and
returns their uint8 samples (H, W, C); any other PNG (another bit depth, a
palette, Adam7 interlacing) is refused by name.  Chunk CRCs are checked.
The Average and Paeth filters predict a pixel from its reconstructed left
neighbour, so a row cannot be undone in one vector operation: the image is
unfiltered along its anti-diagonals instead (pixel (r, i) needs (r, i-1),
(r-1, i) and (r-1, i-1), all on the two diagonals before r + i), H + W - 1
steps each vectorised over the rows, on a skewed copy in which every
diagonal is contiguous.  ``encode_png`` writes 8-bit grey or RGB with no
filtering (``cli/serve.py``'s frames, the segmentation's masks and masked
frames).
"""

from __future__ import annotations

import binascii
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}     # colour type -> samples a pixel
_COLOUR_NAMES = {3: "palette (colour type 3)"}


def _chunks(data: bytes):
    """(type, payload) of every chunk, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or binascii.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG file ends before its IEND chunk")


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the row filters: raw (H, W, C) uint8 filtered samples, ftype
    (H,) the rows' filter types 0-4 -> (H, W, C) uint8 samples."""
    if not ftype.any():
        return raw
    H, W, C = raw.shape
    # skewed: row t + 1, column r + 1 holds pixel (r, t - r), so that a
    # diagonal is contiguous; the zero row and columns around the pixels
    # are the filters' out-of-image neighbours
    r, i = np.arange(H)[:, None], np.arange(W)[None, :]
    idx = ((r + i + 1) * (H + 1) + r + 1).reshape(-1)
    skew_raw = np.zeros(((H + W + 1) * (H + 1), C), np.int16)
    skew_raw[idx] = raw.reshape(-1, C)
    skew_raw = skew_raw.reshape(H + W + 1, H + 1, C)
    rec = np.zeros_like(skew_raw)
    kind = ftype.astype(np.intp)[:, None]
    zero = np.zeros((H, C), np.int16)
    for t in range(H + W - 1):
        r0, r1 = max(0, t - W + 1), min(H - 1, t)
        n = r1 - r0 + 1
        a = rec[t, r0 + 1:r1 + 2]                 # left
        b = rec[t, r0:r1 + 1]                     # up
        c = rec[t - 1, r0:r1 + 1] if t else zero[:n]   # up-left
        pred = np.choose(kind[r0:r1 + 1],
                         (zero[:n], a, b, (a + b) >> 1, _paeth(a, b, c)))
        rec[t + 1, r0 + 1:r1 + 2] = (skew_raw[t + 1, r0 + 1:r1 + 2]
                                     + pred) & 0xFF
    return rec.reshape(-1, C)[idx].reshape(H, W, C).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG file bytes -> uint8 (H, W, C), C = 1, 2, 3 or 4 (grey, grey +
    alpha, RGB, RGBA)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, colour, _comp, _filt, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"PNG colour type {colour} "
                         f"({_COLOUR_NAMES.get(colour, 'unknown')}) is not "
                         "supported: only 8-bit grey, grey+alpha, RGB and "
                         "RGBA are")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} is not supported: only "
                         "8-bit samples are")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    c = _CHANNELS[colour]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (1 + w * c):
        raise ValueError(f"PNG image data holds {rows.size} bytes, not the "
                         f"{h * (1 + w * c)} of {h} rows of {w}x{c}")
    rows = rows.reshape(h, 1 + w * c)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"PNG row filter type {int(ftype.max())} is not one "
                         "of the five (0-4)")
    return _unfilter(rows[:, 1:].reshape(h, w, c), ftype)


def encode_png(img8: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 1) grey, or (H, W, 3) RGB -> PNG file bytes
    (8-bit, no filtering)."""
    img8 = np.ascontiguousarray(img8, np.uint8)
    if img8.ndim == 2:
        img8 = img8[..., None]
    h, w, c = img8.shape
    if c not in (1, 3):
        raise ValueError(f"encode_png takes grey or RGB, not {c} channels")

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", binascii.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img8.reshape(h, w * c)], 1)
    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         0 if c == 1 else 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """The uint8 (H, W, C) samples of the PNG file at ``path``."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def to_rgb(img8: np.ndarray) -> np.ndarray:
    """(H, W, C) samples -> (H, W, 3) RGB as Pillow's ``convert("RGB")`` and
    cv2's colour read give them: alpha dropped, grey spread."""
    if img8.shape[-1] <= 2:
        return np.repeat(img8[..., :1], 3, axis=-1)
    return img8[..., :3]


def write_png(path: str, img8: np.ndarray):
    """Write uint8 grey or RGB ``img8`` to ``path`` as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img8))
