"""PyTorch port vs the JAX package and the libraries it calls: the capture
front end on the CPU.

``data/png.py`` is held to Pillow (every colour type it reads, every row
filter: Pillow's own adaptive choice and raw IDATs written here with one
filter forced, the port's encoder's output) and refuses the PNGs it does not
read; ``pipeline/image_ops.py`` is held to cv2 bit for bit (the Laplacian's
variance to 1e-12) on seeded images and a render of the textured humanoid;
``build_transforms``, the threshold masks of ``segment_images`` and
``apply_mask_categories`` with an injected detector equal the JAX module's.
The machine without cv2 and Pillow (the card's) is played by refusing their
import.  Test names avoid the words that tests/conftest.py marks slow.
"""

import functools
import io
import json
import os
import shutil
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from human_body_reconstruction_tpu.cli import colmap2nerf as jcolmap2nerf
from human_body_reconstruction_tpu.pipeline import capture as jcapture
from human_body_reconstruction_tpu.pipeline import masking as jmasking
from human_body_reconstruction_tpu.pipeline import segment as jsegment
from human_body_reconstruction_tpu_torch.cli import colmap2nerf
from human_body_reconstruction_tpu_torch.cli import segment as segment_cli
from human_body_reconstruction_tpu_torch.data import png, synthetic
from human_body_reconstruction_tpu_torch.pipeline import (
    capture, image_ops, masking, segment)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "colmap_text")
MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}
COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def no_library(monkeypatch, *names):
    """Play a machine without these modules: importing them fails."""
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)


def textured_render(hw=48) -> np.ndarray:
    """A uint8 (hw, hw, 3) render of the textured humanoid (subject on
    black), from the quality protocol's first training view."""
    K = torch.tensor([[1.1 * hw, 0, hw / 2], [0, 1.1 * hw, hw / 2], [0, 0, 1]])
    c2w = torch.as_tensor(synthetic.orbit_poses(21, radius=4.0,
                                                elevation=0.35)[0])
    img = synthetic.render_gt_image(hw, hw, K, c2w,
                                    field=synthetic.textured_humanoid_field,
                                    num_samples=64)
    return (img.numpy() * 255).astype(np.uint8)


def smooth_image(h, w, c, seed=0) -> np.ndarray:
    """Gradients plus noise: Pillow's adaptive filtering picks several row
    filters for it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = (np.sin(xx / 5.0) * 70 + np.cos(yy / 3.0) * 50 + 120)[..., None]
    return np.clip(base + rng.integers(0, 40, (h, w, c)), 0, 255).astype(
        np.uint8)


def pil_png(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if img.shape[-1] == 1 else img,
                    MODES[img.shape[-1]]).save(buf, "PNG")
    return buf.getvalue()


def pil_decode(data: bytes) -> np.ndarray:
    arr = np.asarray(Image.open(io.BytesIO(data)))
    return arr[..., None] if arr.ndim == 2 else arr


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filtered_png(img: np.ndarray, ftypes, ihdr=None) -> bytes:
    """A PNG of img (H, W, C) whose row r is written with filter
    ftypes[r % len(ftypes)], as the PNG specification defines the five."""
    h, w, c = img.shape
    x = img.astype(np.int32)
    left = np.concatenate([np.zeros((h, 1, c), np.int32), x[:, :-1]], 1)
    up = np.concatenate([np.zeros((1, w, c), np.int32), x[:-1]], 0)
    upleft = np.concatenate([np.zeros((h, 1, c), np.int32), up[:, :-1]], 1)
    preds = [0 * x, left, up, (left + up) // 2, _paeth(left, up, upleft)]
    rows = []
    for r in range(h):
        f = ftypes[r % len(ftypes)]
        rows.append(bytes([f]) + ((x[r] - preds[f][r]) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    ihdr = ihdr or struct.pack(">IIBBBBB", w, h, 8, COLOUR_TYPE[c], 0, 0, 0)
    return (png.SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("hw", [(1, 1), (3, 7), (40, 57)])
def test_decode_png_matches_pillow_on_its_files(channels, hw):
    img = smooth_image(*hw, channels)
    data = pil_png(img)
    got = png.decode_png(data)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, pil_decode(data))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("ftypes", [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
def test_decode_png_every_row_filter(ftypes, channels):
    """Each filter forced on every row (and all five in turn), random
    samples so that every prediction wraps round 256 somewhere."""
    img = np.random.default_rng(channels).integers(
        0, 256, (13, 17, channels), dtype=np.uint8)
    data = filtered_png(img, ftypes)
    np.testing.assert_array_equal(pil_decode(data), img)
    np.testing.assert_array_equal(png.decode_png(data), img)


@pytest.mark.parametrize("shape", [(9, 11), (9, 11, 1), (9, 11, 3)],
                         ids=["grey", "grey1", "rgb"])
def test_encode_png_round_trips_through_pillow(shape, tmp_path):
    img = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    data = png.encode_png(img)
    want = img if img.ndim == 3 else img[..., None]
    np.testing.assert_array_equal(pil_decode(data), want)
    np.testing.assert_array_equal(png.decode_png(data), want)
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), want)
    with pytest.raises(ValueError, match="grey or RGB"):
        png.encode_png(np.zeros((2, 2, 4), np.uint8))


def test_decode_png_refuses_what_it_does_not_read():
    img = np.zeros((4, 5, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(np.arange(20, dtype=np.uint8).reshape(4, 5), "L").convert(
        "P").save(buf, "PNG")
    with pytest.raises(ValueError, match="palette"):
        png.decode_png(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(np.arange(20, dtype=np.uint16).reshape(4, 5) * 999).save(
        buf, "PNG")
    with pytest.raises(ValueError, match="bit depth 16"):
        png.decode_png(buf.getvalue())
    interlaced = filtered_png(img, [0], struct.pack(">IIBBBBB", 5, 4, 8, 2, 0,
                                                    0, 1))
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_png(interlaced)
    good = filtered_png(img, [0])
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(good[:40] + bytes([good[40] ^ 1]) + good[41:])
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"GIF89a" + good[6:])
    with pytest.raises(ValueError, match="IEND"):
        png.decode_png(good[:-12])


# ---------------------------------------------------------------------------
# image_ops against cv2
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def images() -> dict:
    rng = np.random.default_rng(0)
    lattice = np.stack(np.meshgrid(*[np.arange(0, 256, 5)] * 3,
                                   indexing="ij"), -1).astype(np.uint8)
    grey = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, -1)
    return {"random": rng.integers(0, 256, (61, 47, 3), dtype=np.uint8),
            "lattice": lattice.reshape(52 * 52, 52, 3),
            "grey": grey[None],
            "render": textured_render(),
            "pixel": rng.integers(0, 256, (1, 1, 3), dtype=np.uint8)}


@pytest.mark.parametrize("name", ["grey", "lattice", "pixel", "random",
                                  "render"])
def test_image_ops_match_cv2(name):
    img = images()[name]
    np.testing.assert_array_equal(image_ops.rgb_to_hsv_u8(img),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    grey = image_ops.bgr_to_gray_u8(img)
    np.testing.assert_array_equal(grey, cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    for g in (grey, image_ops.rgb_to_hsv_u8(img)[..., 1]):
        thresh, _ = cv2.threshold(g, 0, 255, cv2.THRESH_BINARY
                                  + cv2.THRESH_OTSU)
        assert image_ops.otsu_threshold_u8(g) == thresh
    want = float(cv2.Laplacian(grey, cv2.CV_64F).var())
    assert image_ops.laplacian_var(grey) == pytest.approx(want, rel=1e-12,
                                                          abs=0)


def test_threshold_mask_matches_jax():
    """The threshold backend on a render and on a bright subject: the JAX
    module's mask (cv2) and the port's (numpy), equal."""
    subject = np.full((64, 64, 3), 20, np.uint8)
    subject[12:52, 18:46] = [200, 150, 120]
    for img in (images()["render"], subject, images()["random"]):
        m = segment.mask_threshold(img)
        np.testing.assert_array_equal(m, jsegment.mask_threshold(img))
        assert m.dtype == np.float32


# ---------------------------------------------------------------------------
# capture: COLMAP text model -> transforms
# ---------------------------------------------------------------------------

def _fixture_frames(dst, suffix, channels=3):
    """The fixture's text model beside frames it names, written with the
    given suffix ('.png' renames them in images.txt)."""
    text = os.path.join(dst, "colmap_text")
    shutil.copytree(FIXTURE, text)
    with open(os.path.join(text, "images.txt")) as f:
        body = f.read().replace(".jpg", suffix)
    with open(os.path.join(text, "images.txt"), "w") as f:
        f.write(body)
    images = os.path.join(dst, "images")
    os.makedirs(images)
    for k, (name, _, _) in enumerate(capture.parse_images_txt(
            os.path.join(text, "images.txt"))):
        img = smooth_image(48, 64, channels, seed=k)
        if suffix == ".png":
            Image.fromarray(img[..., 0] if channels == 1 else img,
                            MODES[channels]).save(os.path.join(images, name))
        else:
            cv2.imwrite(os.path.join(images, name), img)
    return text, images


def test_build_transforms_on_the_fixture_matches_jax_and_golden():
    """Frames missing: sharpness 0.0 in both, as the committed golden file
    holds."""
    kw = dict(json_dir=os.path.dirname(FIXTURE))
    images = os.path.join(os.path.dirname(FIXTURE), "images")
    port = capture.build_transforms(FIXTURE, images, **kw)
    assert port == jcapture.build_transforms(FIXTURE, images, **kw)
    with open(os.path.join(REPO, "tests", "fixtures",
                           "golden_transforms.json")) as f:
        golden = json.load(f)
    assert json.loads(json.dumps(port)) == golden


@pytest.mark.parametrize("suffix,channels", [(".png", 1), (".png", 2),
                                             (".png", 3), (".png", 4),
                                             (".jpg", 3)])
def test_build_transforms_with_sharpness_matches_jax(suffix, channels,
                                                     tmp_path):
    """Sharpness on: the port scores a PNG with data/png.py and image_ops,
    JAX with cv2.imread; a JPEG goes through cv2 in both."""
    text, images = _fixture_frames(str(tmp_path), suffix, channels)
    kw = dict(json_dir=str(tmp_path))
    port = capture.build_transforms(text, images, **kw)
    ref = jcapture.build_transforms(text, images, **kw)
    sharp = [f.pop("sharpness") for f in port["frames"]]
    want = [f.pop("sharpness") for f in ref["frames"]]
    assert port == ref
    assert min(want) > 0
    np.testing.assert_allclose(sharp, want, rtol=1e-12, atol=0)


def test_sharpness_without_cv2(tmp_path, monkeypatch):
    """Without cv2, a PNG is still scored; a JPEG is refused with a message
    that names --no_sharpness."""
    text, images = _fixture_frames(str(tmp_path / "png"), ".png")
    want = jcapture.image_sharpness(os.path.join(images, "frame_0000.png"))
    _, jpgs = _fixture_frames(str(tmp_path / "jpg"), ".jpg")
    no_library(monkeypatch, "cv2")
    assert capture.image_sharpness(os.path.join(
        images, "frame_0000.png")) == pytest.approx(want, rel=1e-12, abs=0)
    with pytest.raises(RuntimeError, match="--no_sharpness"):
        capture.image_sharpness(os.path.join(jpgs, "frame_0000.jpg"))


def test_colmap2nerf_cli_matches_jax(tmp_path, monkeypatch):
    """The CLI on PNG frames, cv2 and Pillow refused for the port: the
    transforms.json files equal JAX's."""
    text, images = _fixture_frames(str(tmp_path), ".png")
    argv = ["--text", text, "--images", images]
    jcolmap2nerf.main(argv + ["--out", str(tmp_path / "jax.json")])
    no_library(monkeypatch, "cv2", "PIL")
    colmap2nerf.main(argv + ["--out", str(tmp_path / "port.json")])
    with open(tmp_path / "jax.json") as f, open(tmp_path / "port.json") as g:
        ref, got = json.load(f), json.load(g)
    for a, b in zip(got["frames"], ref["frames"]):
        assert a.pop("sharpness") == pytest.approx(b.pop("sharpness"),
                                                   rel=1e-12)
    assert got == ref


def test_missing_binaries_raise_naming_them(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="ffmpeg"):
        capture.run_ffmpeg("v.mp4", str(tmp_path / "frames"))
    with pytest.raises(FileNotFoundError, match="colmap"):
        capture.run_colmap(str(tmp_path), db=str(tmp_path / "c.db"))
    no_library(monkeypatch, "pycolmap")
    with pytest.raises(ImportError, match="pycolmap"):
        capture.run_pycolmap(str(tmp_path), str(tmp_path / "out"))


# ---------------------------------------------------------------------------
# segmentation and category masks
# ---------------------------------------------------------------------------

def _frames(d, n=3, suffix=".png"):
    os.makedirs(d)
    imgs = [images()["render"], smooth_image(48, 48, 3, seed=1),
            images()["random"][:40, :40]][:n]
    for k, img in enumerate(imgs):
        Image.fromarray(img).save(os.path.join(d, f"{k:04d}{suffix}"))
    return imgs


def test_segment_images_threshold_matches_jax(tmp_path, monkeypatch):
    """The masked frames JAX writes (Pillow) and the port writes (data/
    png.py, Pillow and cv2 refused), decoded, equal; the port leaves the
    contact sheet out and says so."""
    _frames(str(tmp_path / "in"))
    ref = jsegment.segment_images(str(tmp_path / "in" / "*"),
                                  str(tmp_path / "jax"), backend="threshold")
    no_library(monkeypatch, "cv2", "PIL")
    got = segment.segment_images(str(tmp_path / "in" / "*"),
                                 str(tmp_path / "port"), backend="threshold")
    monkeypatch.undo()
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                      np.asarray(Image.open(b)))
    assert os.path.exists(tmp_path / "jax" / "contact_threshold.png")
    assert not os.path.exists(tmp_path / "port" / "contact_threshold.png")


def test_segment_cli_and_refusals(tmp_path, monkeypatch, capsys):
    """The CLI with Pillow writes its contact sheet; without cv2 GrabCut is
    refused naming the threshold backend; a JPEG without Pillow is refused
    naming Pillow."""
    _frames(str(tmp_path / "in"), n=1)
    segment_cli.main(["--input", str(tmp_path / "in"), "--output",
                      str(tmp_path / "o"), "--backend", "threshold"])
    assert os.path.exists(tmp_path / "o" / "THRESHOLD" / "0000.png")
    assert os.path.exists(tmp_path / "o" / "contact_threshold.png")
    _frames(str(tmp_path / "jpg"), n=1, suffix=".jpg")
    no_library(monkeypatch, "cv2", "PIL")
    with pytest.raises(RuntimeError, match="threshold"):
        segment.mask_grabcut(images()["render"])
    with pytest.raises(RuntimeError, match="Pillow"):
        segment.segment_images(str(tmp_path / "jpg" / "*"), str(tmp_path / "x"),
                               backend="threshold", contact_sheet=False)
    segment.segment_images(str(tmp_path / "in" / "*"), str(tmp_path / "y"),
                           backend="threshold")
    assert "contact sheet left out" in capsys.readouterr().out


def fake_detector(img):
    h, w = img.shape[:2]
    person = np.zeros((h, w), bool)
    person[:h // 2] = True
    car = np.zeros((h, w), bool)
    car[:, :w // 2] = True
    bright = img.mean(-1) > 128                       # reads the pixels
    return [(1, 0.9, person), (3, 0.9, car), (1, 0.8, bright)]


@pytest.mark.parametrize("suffix", [".png", ".jpg"])
def test_apply_mask_categories_matches_jax(suffix, tmp_path):
    """An injected detector on PNG and JPEG frames: the same mask files
    (read back by cv2) and the same mask_path entries."""
    outs = {}
    for name, mod in (("jax", jmasking), ("port", masking)):
        d = str(tmp_path / name)
        _frames(os.path.join(d, "images"), n=2, suffix=suffix)
        transforms = {"frames": [{"file_path": f"images/{i:04d}{suffix}"}
                                 for i in range(2)]}
        outs[name] = (d, mod.apply_mask_categories(transforms, ["person"], d,
                                                   detector=fake_detector))
    (dj, ref), (dp, got) = outs["jax"], outs["port"]
    assert got == ref
    for frame in got["frames"]:
        a = cv2.imread(os.path.join(dp, frame["mask_path"]),
                       cv2.IMREAD_GRAYSCALE)
        b = cv2.imread(os.path.join(dj, frame["mask_path"]),
                       cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(a, b)
        assert 0 < (a == 255).mean() < 1
