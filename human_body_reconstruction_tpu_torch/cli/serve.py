"""Persistent rendering server (counterpart of the JAX cli/serve.py).

Restore the checkpoint once, then answer render requests until EOF or a
``quit`` request.  Two transports, both stdlib-only:
  (default)   JSON lines on stdin/stdout, one request and one response per
              line (logs go to stderr);
  --port N    minimal HTTP server: POST /render '{...}', GET /health.

Requests and responses are the JAX server's:
  c2w             [[4x4]] camera-to-world (required unless orbit)
  orbit           {"index", "count", "radius", "elevation"} turntable pose
  height, width, camera_angle_x, num_samples, eval_guided   overrides
  out_path        write the PNG there; otherwise "image_b64"
  no_image        timing probe, no payload
  id              echoed back
  batch           true -> every pose of "c2ws" or of "orbit", written to
                  "out_dir" (frame_%04d.png) or returned as "images_b64"
  cmd             "health" -> stats (frames served, the frame graphs'
                  captures, their seconds and replays), "quit" -> shut down
Response: {"ok": true, "wall_s", "rays_per_sec", "H", "W", ...} or
{"ok": false, "error": "..."}; a bad request never stops the server.

The server runs on the card (``--device cuda``, the default) unless given
``--device cpu``; without a card and without that flag it exits.  The
JAX server's flags are all taken: ``--use_sdf`` names an SDF model when the
run directory has no saved config.  A frame, and a ``batch`` of poses, is
one dispatch by default (``step.render_poses_fused``: on the card the replay
of a graph captured at the first request of its shape, the same chunks as
the eager loop; on the CPU the eager loop); ``--no_fused`` renders eager
chunks; ``--aot_cache`` (the JAX compile cache) is refused.  In a
``torch.profiler`` trace (``observability.span``) a request is the span
``hbr.serve.request`` (with its id), holding ``hbr.serve.render`` (the
poses to the frame on the host) and ``hbr.serve.encode`` (PNG and base64,
or the file writes).

Run:  python -m human_body_reconstruction_tpu_torch.cli.serve \\
          --ckpt_dir results --model_name flagship --use_occ --eval_guided 48
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.cli import device_from_flag
from human_body_reconstruction_tpu_torch.data import png, synthetic
from human_body_reconstruction_tpu_torch.pipeline import restore
from human_body_reconstruction_tpu_torch.train import step as step_lib
from human_body_reconstruction_tpu_torch.utils import observability as obs


def build_parser():
    p = argparse.ArgumentParser(
        description="Persistent novel-view render server (PyTorch/CUDA)")
    p.add_argument("--ckpt_dir", type=str, default="results")
    p.add_argument("--model_name", type=str, default="default")
    p.add_argument("--bound_pth", type=str, default="bounds_model.npy")
    p.add_argument("--ckpt_name", type=str, default="N_2048_T_16")
    p.add_argument("--use_sdf", action="store_true",
                   help="an SDF model, where the run directory has no saved "
                        "config")
    p.add_argument("--max_res", type=float, default=2048)
    p.add_argument("--hash_size", type=float, default=16)
    p.add_argument("--encoder_variant", type=str, default=None,
                   choices=["corner", "cell", "cp"])
    p.add_argument("--rgb_elu", action="store_true")
    p.add_argument("--normalization", type=str, default=None,
                   choices=["diagonal", "unit_box"])
    p.add_argument("--near", type=float, default=2.0)
    p.add_argument("--far", type=float, default=6.0)
    p.add_argument("--num_samples", type=int, default=128)
    p.add_argument("--chunk", type=int, default=16384)
    p.add_argument("--use_occ", action="store_true",
                   help="reuse the trained occupancy grid for culling "
                        "and guided placement")
    p.add_argument("--eval_guided", type=int, default=0,
                   help="default deterministic guided sample budget "
                        "(requires --use_occ); requests may override")
    p.add_argument("--height", type=int, default=400)
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--camera_angle_x", type=float, default=0.6911112)
    p.add_argument("--aot_cache", type=str, default="",
                   help="not ported (the JAX compile cache); refused")
    p.add_argument("--fp32", action="store_true",
                   help="run the MLP in float32 compute (default bfloat16 "
                        "with f32 accumulation, as in training)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; without a CUDA card pass --device cpu")
    p.add_argument("--no_fused", action="store_true",
                   help="render eager chunks instead of the captured "
                        "one-dispatch frame")
    p.add_argument("--warmup", action="store_true",
                   help="render one default-size view at startup")
    p.add_argument("--port", type=int, default=0,
                   help="serve HTTP on this port instead of stdin/stdout")
    return p


def check_supported(args):
    """Refuse what the port cannot run, before any work starts."""
    if args.aot_cache:
        raise SystemExit("--aot_cache (the JAX compile cache) is not ported "
                         "to the PyTorch package")


png_bytes = png.encode_png      # the server's frames: 8-bit RGB PNG


def _to_u8(img) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


class RenderServer:
    """Checkpoint restored once; renders on demand; tracks stats."""

    def __init__(self, args):
        check_supported(args)
        self.args = args
        self.device = device_from_flag(args.device)
        res = restore.restore(
            args.ckpt_dir, args.model_name, device=self.device,
            bound_pth=args.bound_pth, ckpt_name=args.ckpt_name,
            near=args.near, far=args.far, use_sdf=args.use_sdf,
            max_res=args.max_res,
            hash_size=args.hash_size, encoder_variant=args.encoder_variant,
            rgb_elu=args.rgb_elu, normalization=args.normalization,
            with_occ=args.use_occ,
            # stdout carries only response lines in stdio mode
            log_fn=lambda s: print(s, file=sys.stderr, flush=True))
        self.field, self.scene, self.occ = res.field, res.scene, res.occ
        self.base_cfg = res.cfg
        if args.eval_guided > 0 and self.occ is None:
            raise SystemExit("--eval_guided needs the trained occupancy "
                             "grid: pass --use_occ (and train with "
                             "occupancy enabled)")
        self.frames = step_lib.FrameGraphs()
        self.n_served = 0
        self.rays_served = 0
        self.render_s = 0.0
        self.t_up = time.perf_counter()

    def _cfg_for(self, guided: int):
        if guided > 0 and self.occ is None:
            raise ValueError("eval_guided needs a trained occupancy grid "
                             "(serve with --use_occ)")
        return dataclasses.replace(
            self.base_cfg, render=dataclasses.replace(
                self.base_cfg.render, eval_guided=max(guided, 0)))

    @staticmethod
    def _orbit(req):
        o = dict(req["orbit"])
        return synthetic.orbit_poses(int(o.get("count", 12)),
                                     radius=float(o.get("radius", 4.0)),
                                     elevation=float(o.get("elevation", 0.5))
                                     ), int(o.get("index", 0))

    def _poses_from(self, req, batch: bool):
        """(P, 4, 4) float32: one pose, or every pose of a batch."""
        key = "c2ws" if batch else "c2w"
        if key in req:
            poses = np.asarray(req[key], np.float32)
            want = (3, (4, 4)) if batch else (2, (4, 4))
            if poses.ndim != want[0] or poses.shape[-2:] != want[1]:
                raise ValueError(f"{key} must be {'(P, 4, 4)' if batch else '4x4'}"
                                 f", got {poses.shape}")
            return poses if batch else poses[None]
        if "orbit" in req:
            poses, index = self._orbit(req)
            return poses if batch else poses[index][None]
        if batch:
            raise ValueError("batch request needs 'c2ws' [(4x4), ...] or "
                             "'orbit' {count, ...}")
        raise ValueError("request needs 'c2w' (4x4) or 'orbit' "
                         "{index, count, ...}")

    def render(self, req: dict, batch: bool = False) -> dict:
        """One frame, or every pose of a batch request, rendered and
        encoded as PNG (or only timed, with ``no_image``)."""
        a = self.args
        with obs.span("serve.render"):
            poses = self._poses_from(req, batch)
            H = int(req.get("height", a.height))
            W = int(req.get("width", a.width))
            cax = float(req.get("camera_angle_x", a.camera_angle_x))
            S = int(req.get("num_samples", a.num_samples))
            guided = int(req.get("eval_guided", a.eval_guided))
            cfg = self._cfg_for(guided)
            focal = W / (2.0 * np.tan(cax / 2.0))
            K = torch.tensor([[focal, 0, W / 2.0], [0, focal, H / 2.0],
                              [0, 0, 1]], dtype=torch.float32,
                             device=self.device)
            P = poses.shape[0]
            t0 = time.perf_counter()
            kw = dict(occ=self.occ, num_samples=S,
                      chunk=min(a.chunk, P * H * W), bf16=not a.fp32)
            c2ws = torch.as_tensor(poses, device=self.device)
            if a.no_fused:
                imgs = step_lib.render_poses(self.field, self.scene, H, W, K,
                                             c2ws, cfg, **kw)
            else:
                imgs = step_lib.render_poses_fused(
                    self.field, self.scene, H, W, K, c2ws, cfg,
                    graphs=self.frames, **kw)
            imgs = imgs.cpu().numpy()
            wall = time.perf_counter() - t0
        self.n_served += P
        self.rays_served += P * H * W
        self.render_s += wall
        resp = {"ok": True, "H": H, "W": W, "num_samples": S,
                "eval_guided": guided, "wall_s": round(wall, 3),
                "rays_per_sec": round(P * H * W / max(wall, 1e-9), 1)}
        if batch:
            resp["frames"] = P
        if "id" in req:
            resp["id"] = req["id"]
        if req.get("no_image"):
            return resp
        with obs.span("serve.encode"):
            pngs = [png_bytes(_to_u8(img)) for img in imgs]
            out_dir = req.get("out_dir") if batch else None
            out_path = None if batch else req.get("out_path")
            if out_dir or out_path:
                paths = ([os.path.join(str(out_dir), f"frame_{i:04d}.png")
                          for i in range(P)] if batch else [str(out_path)])
                for path, data in zip(paths, pngs):
                    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                    with open(path, "wb") as f:
                        f.write(data)
                resp.update({"paths": paths} if batch else {"path": paths[0]})
            else:
                b64 = [base64.b64encode(d).decode() for d in pngs]
                resp.update({"images_b64": b64} if batch
                            else {"image_b64": b64[0]})
        return resp

    def health(self) -> dict:
        return {"ok": True, "model_name": self.args.model_name,
                "device": str(self.device),
                "uptime_s": round(time.perf_counter() - self.t_up, 1),
                "served": self.n_served, "rays_served": self.rays_served,
                "render_s_total": round(self.render_s, 2),
                "captures": self.frames.captures,
                "capture_s": round(self.frames.capture_s, 2),
                "replays": self.frames.replays,
                "use_occ": self.occ is not None,
                "fused": not self.args.no_fused,
                "default_eval_guided": self.args.eval_guided}

    def handle(self, req: dict) -> dict:
        """One request -> one response; never raises on bad input."""
        has_id = isinstance(req, dict) and "id" in req
        with obs.span("serve.request", {"id": req["id"]} if has_id else None):
            try:
                cmd = req.get("cmd")
                if cmd == "health":
                    return self.health()
                if cmd == "quit":
                    return {"ok": True, "bye": True}
                return self.render(req, batch=bool(req.get("batch")))
            except Exception as e:  # noqa: BLE001 — the server must stay up
                r = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                if has_id:
                    r["id"] = req["id"]
                return r


def serve_stdio(server: RenderServer, stdin=None, stdout=None):
    """JSON-lines loop: one request per input line, one response per
    output line."""
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    print(f"ready model={server.args.model_name} "
          f"occ={server.occ is not None}", file=sys.stderr, flush=True)
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            print(json.dumps({"ok": False, "error": f"bad json: {e}"}),
                  file=stdout, flush=True)
            continue
        resp = server.handle(req)
        print(json.dumps(resp), file=stdout, flush=True)
        if resp.get("bye"):
            break


def make_http_server(server: RenderServer, port: int):
    """Minimal single-threaded stdlib HTTP front end on 127.0.0.1 (port 0
    picks a free one): POST /render, GET /health."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") in ("", "/health"):
                self._send(200, server.health())
            else:
                self._send(404, {"ok": False, "error": "GET /health only"})

        def do_POST(self):
            if self.path.rstrip("/") != "/render":
                self._send(404, {"ok": False, "error": "POST /render only"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._send(400, {"ok": False, "error": f"bad json: {e}"})
                return
            resp = server.handle(req)
            self._send(200 if resp.get("ok") else 400, resp)
            if resp.get("bye"):
                raise KeyboardInterrupt

        def log_message(self, fmt, *args):  # stderr, not stdout
            print("http: " + fmt % args, file=sys.stderr, flush=True)

    return HTTPServer(("127.0.0.1", port), Handler)


def run_http(httpd):
    """Serve until a ``quit`` request (or Ctrl-C), then close the socket."""
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def serve_http(server: RenderServer, port: int):
    httpd = make_http_server(server, port)
    print(f"ready http://127.0.0.1:{httpd.server_port}/render "
          f"model={server.args.model_name}", file=sys.stderr, flush=True)
    run_http(httpd)


def main(argv=None):
    args = build_parser().parse_args(argv)
    server = RenderServer(args)
    if args.warmup:
        t0 = time.perf_counter()
        server.handle({"orbit": {"index": 0, "count": 8}, "no_image": True})
        print(f"warmup render {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
    if args.port:
        serve_http(server, args.port)
    else:
        serve_stdio(server)
    return server


if __name__ == "__main__":
    main()
