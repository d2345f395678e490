"""The port's render server (cli/serve.py) at a tiny size on the CPU, and the
no-JAX guard: the served path imports and runs with JAX unavailable, as on
the card's machine.

The run directory is written by the port itself (seeded random weights,
config JSON, bounds, an occupancy grid), so nothing here needs JAX.
"""

import base64
import dataclasses
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu_torch.cli import serve
from human_body_reconstruction_tpu_torch.data.synthetic import orbit_poses
from human_body_reconstruction_tpu_torch.models.nerf import Field
from human_body_reconstruction_tpu_torch.ops import dense_grid, occupancy
from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
from human_body_reconstruction_tpu_torch.utils import config as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfg() -> C.PipelineConfig:
    h = C.HashConfig(num_levels=4, n_max=64, variant="cp", cp_rank=4,
                     cp_init_scale=0.6, init_scale=0.5)
    h = dataclasses.replace(h, dense_levels=dense_grid.auto_dense_levels(h))
    return C.PipelineConfig(hash=h, mlp=C.MLPConfig(width=16),
                            render=C.RenderConfig(occupancy_resolution=16,
                                                  occ_probes=8))


def write_run(path: str, name: str = "t", with_occ: bool = True):
    cfg = tiny_cfg()
    field = Field(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        field.mlp.sig[-1].bias[0] += 2.0
    extra = {}
    if with_occ:
        g = cfg.render.occupancy_resolution
        mask = torch.zeros((g, g, g))
        mask[4:12, 4:12, 4:12] = 1.0
        extra = ckpt.occ_extras(occupancy.OccupancyGrid(
            mask, mask, torch.tensor(0.01)))
    ckpt.save_params(os.path.join(path, f"{name}_ckpt.npz"), field, extra)
    C.to_json(cfg, os.path.join(path, f"{name}_config.json"))
    ckpt.save_bounds(os.path.join(path, "bounds_model.npy"),
                     np.full(3, -1.5, np.float32), np.full(3, 1.5, np.float32))
    return path


def make_server(path, *extra):
    args = serve.build_parser().parse_args([
        "--ckpt_dir", path, "--model_name", "t", "--use_occ",
        "--height", "12", "--width", "12", "--num_samples", "8",
        "--chunk", "50", "--device", "cpu", *extra])
    return serve.RenderServer(args)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    return make_server(write_run(str(tmp_path_factory.mktemp("srv"))))


def decode_png_size(b: bytes):
    assert b[:8] == b"\x89PNG\r\n\x1a\n"
    return int.from_bytes(b[16:20], "big"), int.from_bytes(b[20:24], "big")


def test_png_bytes_round_trip():
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    back = np.asarray(Image.open(io.BytesIO(serve.png_bytes(img))))
    np.testing.assert_array_equal(back, img)


def test_serve_single_and_health(server):
    h = server.handle({"cmd": "health"})
    assert h["ok"] and h["use_occ"] and h["device"] == "cpu"
    n0 = h["served"]
    r = server.handle({"orbit": {"index": 0, "count": 4}, "id": "v0"})
    assert r["ok"], r
    assert r["id"] == "v0" and r["H"] == 12 and r["rays_per_sec"] > 0
    assert decode_png_size(base64.b64decode(r["image_b64"])) == (12, 12)
    assert server.handle({"cmd": "health"})["served"] == n0 + 1
    g = server.handle({"c2w": orbit_poses(4)[1].tolist(), "eval_guided": 6,
                       "no_image": True, "height": 10, "width": 8})
    assert g["ok"] and g["eval_guided"] == 6 and (g["H"], g["W"]) == (10, 8)
    assert "image_b64" not in g


def test_serve_out_path_and_batch(server, tmp_path):
    path = str(tmp_path / "v" / "one.png")
    r = server.handle({"c2w": orbit_poses(3)[2].tolist(), "out_path": path})
    assert r["ok"] and r["path"] == path and os.path.getsize(path) > 50
    rb = server.handle({"batch": True, "orbit": {"count": 3},
                        "out_dir": str(tmp_path / "frames"), "id": "orb"})
    assert rb["ok"] and rb["frames"] == 3 and rb["id"] == "orb"
    assert len(rb["paths"]) == 3
    frames = [open(p, "rb").read() for p in rb["paths"]]
    assert len(set(frames)) == 3                  # three different poses
    # the pose-stack form returns the same frame as a single render
    rs = server.handle({"batch": True, "c2ws": orbit_poses(3).tolist()})
    one = server.handle({"c2w": orbit_poses(3)[1].tolist()})
    assert rs["ok"] and len(rs["images_b64"]) == 3
    assert rs["images_b64"][1] == one["image_b64"]


def test_serve_bad_requests_do_not_kill(server):
    r = server.handle({"c2w": [[1, 2], [3, 4]], "id": 7})
    assert r["ok"] is False and "4x4" in r["error"] and r["id"] == 7
    r = server.handle({})
    assert r["ok"] is False and "c2w" in r["error"]
    r = server.handle({"batch": True})
    assert r["ok"] is False and "c2ws" in r["error"]
    r = server.handle({"orbit": {"index": 0}, "height": "tall"})
    assert r["ok"] is False
    assert server.handle({"cmd": "quit"}) == {"ok": True, "bye": True}
    assert server.handle({"cmd": "health"})["ok"]


def test_serve_guided_needs_occ(tmp_path):
    path = write_run(str(tmp_path), with_occ=False)
    with pytest.raises(SystemExit):
        make_server(path, "--eval_guided", "4")
    args = serve.build_parser().parse_args([
        "--ckpt_dir", path, "--model_name", "t", "--device", "cpu",
        "--height", "8", "--width", "8", "--num_samples", "4"])
    srv = serve.RenderServer(args)
    r = srv.handle({"orbit": {"index": 0}, "eval_guided": 4})
    assert r["ok"] is False and "occupancy" in r["error"]
    assert srv.handle({"orbit": {"index": 0}})["ok"]


def test_serve_stdio_loop(server):
    reqs = "\n".join([json.dumps({"cmd": "health"}),
                      json.dumps({"orbit": {"index": 1}, "id": "a",
                                  "no_image": True}),
                      "not json at all", "",
                      json.dumps({"cmd": "quit"}),
                      json.dumps({"cmd": "health"})]) + "\n"
    out = io.StringIO()
    serve.serve_stdio(server, io.StringIO(reqs), out)
    lines = [json.loads(l) for l in out.getvalue().splitlines()]
    assert len(lines) == 4                        # stops at quit
    health, render, bad, bye = lines
    assert health["ok"] and render["ok"] and render["id"] == "a"
    assert bad["ok"] is False and "bad json" in bad["error"]
    assert bye == {"ok": True, "bye": True}


def test_serve_http_front_end(server):
    import threading
    import urllib.error
    import urllib.request

    httpd = serve.make_http_server(server, 0)
    th = threading.Thread(target=serve.run_http, args=(httpd,), daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    # talk to the local server directly, whatever proxy the environment names
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def post(obj_or_bytes):
        data = (obj_or_bytes if isinstance(obj_or_bytes, bytes)
                else json.dumps(obj_or_bytes).encode())
        try:
            with opener.open(base + "/render", data, 30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    with opener.open(base + "/health", timeout=30) as r:
        assert r.status == 200 and json.loads(r.read())["ok"]
    code, resp = post({"orbit": {"index": 2}, "no_image": True})
    assert code == 200 and resp["ok"]
    code, resp = post(b"{not json")
    assert code == 400 and "bad json" in resp["error"]
    code, resp = post({"c2w": [1, 2, 3]})
    assert code == 400 and resp["ok"] is False
    code, resp = post({"cmd": "quit"})
    assert code == 200 and resp["bye"]
    th.join(timeout=30)
    assert not th.is_alive()


def test_served_path_runs_without_jax(tmp_path):
    """With ``sys.modules["jax"] = None`` any JAX import raises: import the
    port, restore a run directory and serve one request over the stdio
    transport, in a fresh interpreter."""
    path = write_run(str(tmp_path))
    code = textwrap.dedent(f"""
        import io, json, sys
        sys.modules["jax"] = None
        from human_body_reconstruction_tpu_torch.cli import serve
        out = io.StringIO()
        server = serve.RenderServer(
            serve.build_parser().parse_args([
                "--ckpt_dir", {path!r}, "--model_name", "t", "--use_occ",
                "--device", "cpu", "--height", "8", "--width", "8",
                "--num_samples", "8", "--eval_guided", "4"]))
        serve.serve_stdio(server, io.StringIO(
            json.dumps({{"orbit": {{"index": 0}}}}) + "\\n"), out)
        resp = json.loads(out.getvalue())
        assert resp["ok"] and resp["eval_guided"] == 4, resp
        assert not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                       for m in sys.modules if sys.modules[m] is not None)
        print("served without jax")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "served without jax" in proc.stdout
