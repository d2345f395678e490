"""PyTorch port vs the JAX package: the hash grid on 2-D points and the
image fit (``cli/image_fit.py``) that runs it.

The exact 2-D encoder (4 corners, PRIMES[:2], per-axis sigma) and its
table gradient against JAX ``hash_encode`` (T 2^10, L 4, n_max 2^16, pixel
coordinates up to 511: at the finest level xl keeps 8 bits of fraction);
the wrappers on the CPU are the plain versions; what stays refused says so;
the CLI's initial parameters are JAX's bit for bit; one fit step from them
on the same pixels against the JAX step; the CLI passes 20 dB at the size
of JAX's own test (tests/test_cli_extras.py).  Tolerances: fp32 features
1e-6 (the same operations in the same order), gradients and updated
parameters by relative norm 1e-4 or atol 1e-6 (sums in other orders).
Test names avoid the words that tests/conftest.py marks slow.
"""

import builtins
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from human_body_reconstruction_tpu.models import mlp as jmlp
from human_body_reconstruction_tpu.ops import hash_encoding as jhe
from human_body_reconstruction_tpu.utils import config as jC
from human_body_reconstruction_tpu_torch.cli import image_fit
from human_body_reconstruction_tpu_torch.data import png
from human_body_reconstruction_tpu_torch.ops import hash_encoding, hash_kernel
from human_body_reconstruction_tpu_torch.utils import config as C
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(num_levels=4, features_per_level=2, log2_table_size=10, n_min=16,
          n_max=2 ** 16, dim=2)
SIGMA = np.array([512.0, 384.0], np.float32)


def inputs(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (4, 2 ** 10, 2)).astype(np.float32)
    x = np.stack([rng.integers(0, 512, n), rng.integers(0, 384, n)],
                 -1).astype(np.float32)
    g = rng.normal(size=(n, 8)).astype(np.float32)
    return table, x, g


def rel_norm(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("mu", [0.0, -3.5], ids=["mu0", "mu_shift"])
def test_hash_encode_2d_matches_jax(mu):
    table, x, g = inputs()
    cfg = C.HashConfig(**KW)
    ref, vjp = jax.vjp(lambda t: jhe.hash_encode(
        t, jnp.asarray(x), mu, jnp.asarray(SIGMA), jC.HashConfig(**KW)),
        jnp.asarray(table))
    (d_ref,) = vjp(jnp.asarray(g))
    tp = torch.tensor(table, requires_grad=True)
    out = hash_encoding.encode_params({"table": tp}, torch.tensor(x), mu,
                                      torch.tensor(SIGMA), cfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-6)
    (out * torch.tensor(g)).sum().backward()
    assert rel_norm(tp.grad.numpy(), np.asarray(d_ref)) <= 1e-4


def test_hash_wrappers_2d_on_cpu_run_plain():
    """CPU tensors take the plain versions (no launch); what the 2-D
    kernels do not take raises."""
    table, x, g = inputs(500)
    cfg = C.HashConfig(**KW)
    args = (torch.tensor(table), torch.tensor(x), 0.0, torch.tensor(SIGMA),
            cfg)
    n = (hash_kernel.hash_encode_kernel.launches,
         hash_kernel.hash_encode_backward_kernel.launches)
    assert torch.equal(hash_kernel.hash_encode_kernel(*args),
                       hash_kernel.hash_encode_plain(*args))
    gt = torch.tensor(g)
    assert torch.equal(hash_kernel.hash_encode_backward_kernel(*args, gt),
                       hash_kernel.hash_encode_plain_backward(*args, gt))
    assert n == (hash_kernel.hash_encode_kernel.launches,
                 hash_kernel.hash_encode_backward_kernel.launches)
    u = torch.zeros((3, 4, 500))
    for bad in (lambda: hash_kernel.hash_encode_kernel(*args, u=u),
                lambda: hash_kernel.hash_encode_kernel(
                    args[0], torch.zeros((500, 3)), *args[2:]),
                lambda: hash_kernel.hash_encode_backward_kernel(
                    *args, gt, bits=torch.zeros((4, 500), dtype=torch.uint8))):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("bad,what", [
    (dict(stochastic_train=True), "stochastic"),
    (dict(dense_levels=1), "corner hash grid alone"),
    (dict(variant="cp"), "corner hash grid alone"),
    (dict(dim=4), "4-D")])
def test_unported_2d_options_are_named(bad, what):
    assert hash_encoding.unported(C.HashConfig(**KW)) is None
    msg = hash_encoding.unported(dataclasses.replace(C.HashConfig(**KW),
                                                     **bad))
    assert msg is not None and what in msg


def test_image_fit_starts_from_jax_parameters():
    """The CLI's table and MLP equal the JAX CLI's initial values."""
    cfg = C.HashConfig(**KW)
    jcfg = jC.HashConfig(**KW)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    table, mlp = image_fit.init_params(cfg, torch.device("cpu"))
    np.testing.assert_array_equal(table.detach().numpy(),
                                  np.asarray(jhe.init_table(k1, jcfg)))
    ref = jmlp.init_mlp2d(k2, jcfg.out_dim)
    for name in ("l1", "l2"):
        layer = getattr(mlp, name)
        np.testing.assert_array_equal(layer.weight.detach().numpy().T,
                                      np.asarray(ref[name]["w"]))
        np.testing.assert_array_equal(layer.bias.detach().numpy(),
                                      np.asarray(ref[name]["b"]))


def test_image_fit_step_matches_jax():
    """One update from the CLI's initial parameters on the same 2048 pixels
    of the procedural target: the loss, then every parameter after optax's
    grouped step (Adam eps 1e-15 on the table, AdamW on the MLP)."""
    cfg, jcfg = C.HashConfig(**KW), jC.HashConfig(**KW)
    args = image_fit.build_parser().parse_args(["--device", "cpu"])
    img = image_fit.procedural_target()
    H, W = img.shape[:2]
    pix = np.random.default_rng(1).integers(0, H * W, 2048)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"table": jhe.init_table(k1, jcfg),
              "mlp": jmlp.init_mlp2d(k2, jcfg.out_dim)}
    sigma = jnp.asarray([W, H], jnp.float32)

    def loss_fn(p):
        ij = jnp.stack([(pix % W).astype(jnp.float32),
                        (pix // W).astype(jnp.float32)], -1)
        feats = jhe.hash_encode(p["table"], ij, 0.0, sigma, jcfg)
        return jnp.mean((jmlp.apply_mlp2d(p["mlp"], feats)
                         - jnp.asarray(img)[pix // W, pix % W]) ** 2)

    tx = optax.multi_transform(
        {"table": optax.adam(args.lr_embed, eps=1e-15),
         "mlp": optax.adamw(args.lr_mlp)}, {"table": "table", "mlp": "mlp"})
    loss_j, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    ref = optax.apply_updates(params, updates)

    table, mlp = image_fit.init_params(cfg, torch.device("cpu"))
    loss_p = image_fit.fit_step(
        table, mlp, image_fit.make_optimizers(table, mlp, args),
        torch.tensor(img), torch.tensor(pix), torch.tensor([W, H],
                                                           dtype=torch.float32),
        cfg)
    assert float(loss_p) == pytest.approx(float(loss_j), rel=1e-5)
    np.testing.assert_allclose(table.detach().numpy(),
                               np.asarray(ref["table"]), rtol=0, atol=1e-6)
    for name in ("l1", "l2"):
        layer = getattr(mlp, name)
        np.testing.assert_allclose(layer.weight.detach().numpy().T,
                                   np.asarray(ref["mlp"][name]["w"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(layer.bias.detach().numpy(),
                                   np.asarray(ref["mlp"][name]["b"]),
                                   rtol=0, atol=1e-6)


def test_image_fit_cli_passes_20_db(tmp_path, capsys):
    """JAX's own test's size: 60 steps of 8192 pixels, T 2^12, 6 levels up
    to n_max 128."""
    out = str(tmp_path)
    res = image_fit.main(["--synthetic", "--steps", "60", "--batch", "8192",
                          "--hash_size", "12", "--n_max", "128", "--levels",
                          "6", "--out_dir", out, "--log_every", "30",
                          "--write_every", "30", "--device", "cpu"])
    text = capsys.readouterr().out
    final = float(text.strip().splitlines()[-1].split(":")[1].split("dB")[0])
    assert final > 20.0 and res["psnr"] == pytest.approx(final, abs=0.01), text
    for name in ("imagefit_30.png", "imagefit_60.png", "imagefit_final.png"):
        assert png.read_png(os.path.join(out, name)).shape == (256, 256, 3)


def test_image_fit_reads_png_and_refuses_other_formats(tmp_path, monkeypatch):
    """A PNG target is read without Pillow; a JPEG is refused by name when
    Pillow is missing."""
    img8 = (image_fit.procedural_target()[:40, :56] * 255).astype(np.uint8)
    png.write_png(str(tmp_path / "t.png"), img8)
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow here")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    np.testing.assert_array_equal(image_fit.read_image(str(tmp_path / "t.png")),
                                  img8.astype(np.float32) / 255.0)
    res = image_fit.main(["--image", str(tmp_path / "t.png"), "--steps", "2",
                          "--batch", "500", "--hash_size", "10", "--n_max",
                          "64", "--levels", "3", "--out_dir", str(tmp_path),
                          "--log_every", "0", "--device", "cpu"])
    assert (res["H"], res["W"], res["batch"]) == (40, 56, 500)
    (tmp_path / "t.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(SystemExit, match="Pillow"):
        image_fit.read_image(str(tmp_path / "t.jpg"))
