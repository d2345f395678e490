"""The port's spans and counters (utils/observability.py ``span`` and
``span_summary``; the server's request, render and encode, the trainer's
windows, refreshes and logs; the graphs' captures and ``replays``), and
what the benchmark's trace reduction makes of a trace that holds them.

The ``cuda``-marked tests need the card (the graphs and their capture
spans exist only there) and skip elsewhere; this file imports no JAX, so
on the card's machine it runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import dataclasses
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import trace
from human_body_reconstruction_tpu_torch.data import synthetic
from human_body_reconstruction_tpu_torch.train import trainer as trainer_lib
from human_body_reconstruction_tpu_torch.utils import config as C
from human_body_reconstruction_tpu_torch.utils import observability as obs
from test_torch_serve import make_server, tiny_cfg, write_run
from torch_threads import one_torch_thread  # noqa: F401

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
TIMING = ("wall_s", "rays_per_sec")


def program_spans(prof) -> list:
    return [e for e in prof.events() if e.name.startswith(obs.SPAN_PREFIX)]


def test_span_untraced_is_shared_null_context():
    assert obs.span("a") is obs.span("b", {"id": 1})
    with obs.span("a"):
        pass


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    return make_server(write_run(str(tmp_path_factory.mktemp("srv"))))


@pytest.mark.parametrize("extra,inner", [
    ({}, ["hbr.serve.render", "hbr.serve.encode"]),
    ({"batch": True, "orbit": {"index": 0, "count": 2}},
     ["hbr.serve.render", "hbr.serve.encode"]),
    ({"out_path": "OUT"}, ["hbr.serve.render", "hbr.serve.encode"]),
    ({"no_image": True}, ["hbr.serve.render"]),
])
def test_request_spans(server, tmp_path, extra, inner):
    req = {"orbit": {"index": 1, "count": 4}, "id": 7, **extra}
    if req.get("out_path"):
        req["out_path"] = str(tmp_path / "f.png")
    plain = server.handle(dict(req))
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        traced = server.handle(dict(req))
    assert traced["ok"]
    assert ({k: v for k, v in traced.items() if k not in TIMING}
            == {k: v for k, v in plain.items() if k not in TIMING})
    spans = program_spans(p)
    assert [e.name for e in spans] == ["hbr.serve.request", *inner]
    outer = spans[0]
    assert outer.kwinputs == {"id": "7"}
    for e in spans[1:]:        # nested in the request, one after another
        assert (outer.time_range.start <= e.time_range.start
                <= e.time_range.end <= outer.time_range.end)
    assert all(a.time_range.end <= b.time_range.start
               for a, b in zip(spans[1:], spans[2:]))
    # operator scope: the profiler copies no user annotation of them onto
    # the device's timeline
    assert not any(e.is_user_annotation for e in spans)


def test_health_reports_frame_graph_counters(server):
    h = server.handle({"cmd": "health"})
    frames = server.frames
    assert (h["captures"], h["capture_s"], h["replays"]) == (
        frames.captures, round(frames.capture_s, 2), frames.replays)
    assert h["replays"] == 0       # the CPU renders its eager chunk loop


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs run only on the card)")
    return torch.device("cuda")


def traced(fn):
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as p:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return p


def span_counts(prof) -> dict:
    counts = {}
    for e in program_spans(prof):
        counts[e.name] = counts.get(e.name, 0) + 1
    return counts


@pytest.mark.cuda
def test_frame_capture_span_and_replays_on_the_card(cuda_device, tmp_path):
    srv = make_server(write_run(str(tmp_path)), "--device", "cuda")
    req = {"orbit": {"index": 1, "count": 4}, "id": "f"}
    p = traced(lambda: [srv.handle(dict(req)) for _ in range(2)])
    assert span_counts(p) == {"hbr.serve.request": 2, "hbr.serve.render": 2,
                              "hbr.serve.encode": 2, "hbr.serve.capture": 1}
    h = srv.handle({"cmd": "health"})
    assert (h["captures"], h["replays"]) == (1, 2)
    assert srv.frames.capture_s > 0
    # no copy of a program span on the device's timeline; the frames'
    # kernels are linked to the render that launched them
    assert not any(e.name.startswith(obs.SPAN_PREFIX)
                   for e in p.events() if e.device_type == CUDA)
    got = obs.span_summary(p.events())
    assert got["hbr.serve.render"]["device_s"] > 0
    assert got["hbr.serve.encode"]["device_s"] == 0


def tiny_train_cfg() -> C.PipelineConfig:
    cfg = tiny_cfg()
    return dataclasses.replace(
        cfg,
        render=dataclasses.replace(cfg.render, num_samples=8, occupancy=True,
                                   compact_samples=4),
        train=dataclasses.replace(cfg.train, ray_batch=32, occ_warmup_steps=1,
                                  update_rate=3))


# 8 steps, the grid installed at step 1 (refreshed then), refreshes at the
# crossings of 3 and 6, logs at the crossings of 4 and 8; with windows of 3
# the install lands at step 3 and the refresh at 6 alone follows
@pytest.mark.parametrize("spc,windows,refreshes", [(1, 8, 3), (2, 4, 3),
                                                   (3, 3, 2)])
def test_run_spans_follow_the_cadence(tmp_path, spc, windows, refreshes):
    ds = synthetic.make_dataset(n_views=2, H=8, W=8, focal=10.0,
                                gt_samples=16)
    tr = trainer_lib.Trainer(cfg=tiny_train_cfg(), ds=ds,
                             out_dir=str(tmp_path), model_name="m",
                             total_steps=8, log_fn=lambda s: None,
                             steps_per_call=spc)
    p = traced(lambda: tr.run(8, log_every=4))
    assert span_counts(p) == {"hbr.train.window": windows,
                      "hbr.train.refresh": refreshes, "hbr.train.log": 2}
    for rec in tr.history:     # the CPU's window is an eager loop
        assert (rec.get("captures"), rec.get("replays")) == (
            (0, 0) if spc > 1 else (None, None))


@pytest.mark.cuda
def test_window_capture_spans_and_replays_on_the_card(cuda_device, tmp_path):
    """Windows of 3 over 8 steps: the unculled step captured at the first
    window, the culled one after the install at step 3; every other step a
    replay."""
    ds = synthetic.make_dataset(n_views=2, H=8, W=8, focal=10.0,
                                gt_samples=16, device=cuda_device)
    tr = trainer_lib.Trainer(cfg=tiny_train_cfg(), ds=ds,
                             out_dir=str(tmp_path), model_name="m",
                             total_steps=8, log_fn=lambda s: None,
                             steps_per_call=3)
    p = traced(lambda: tr.run(8, log_every=4))
    graph = tr._window
    assert (graph.captures, graph.replays) == (2, 6)
    assert span_counts(p) == {
        "hbr.train.window": 3, "hbr.train.capture": 2,
        "hbr.train.refresh": 2, "hbr.train.log": 2}
    assert [(r["captures"], r["replays"]) for r in tr.history] == [
        (2, 4), (2, 6)]
    assert not any(e.name.startswith(obs.SPAN_PREFIX)
                   for e in p.events() if e.device_type == CUDA)
    assert obs.span_summary(p.events())["hbr.train.window"]["device_s"] > 0


class Ev:
    """The fields of a profiler event that the readers use."""

    def __init__(self, name, device, start, end, id=0, annotation=False):
        self.name, self.device_type, self.id = name, device, id
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.is_user_annotation = annotation


def stub_trace(with_spans: bool) -> list:
    """A 100 us segment: a request with a render that launches a kernel and
    a graph, an encode, a kernel launched between them; the benchmark's
    annotation mirrored on the device's timeline; an op whose id is a
    launch's."""
    ev = [Ev(trace.SEGMENT, CPU, 0, 100),
          Ev("bench.RenderServer.handle", CPU, 5, 95, annotation=True),
          Ev("bench.RenderServer.handle", CUDA, 15, 70, annotation=True),
          Ev("aten::add", CPU, 11, 14, id=101),
          Ev("cudaLaunchKernel", CPU, 12, 13, id=101),
          Ev("cudaGraphLaunch", CPU, 20, 21, id=102),
          Ev("cudaLaunchKernel", CPU, 55, 56, id=103),
          Ev("kernel_a", CUDA, 15, 25, id=101),
          Ev("kernel_b", CUDA, 25, 30, id=102),
          Ev("kernel_c", CUDA, 30, 40, id=102),
          Ev("kernel_a", CUDA, 56, 70, id=103)]
    if with_spans:
        ev += [Ev("hbr.serve.request", CPU, -20, 5),        # starts before
               Ev("hbr.serve.request", CPU, 10, 90),
               Ev("hbr.serve.render", CPU, 10, 50),
               Ev("hbr.serve.encode", CPU, 60, 88),
               Ev("hbr.serve.request", CPU, 95, 120)]       # clipped
    return ev


def test_span_summary_on_stub_events():
    got = obs.span_summary(stub_trace(True), 0, 100)
    # busy: [15, 40] and [56, 70]; the annotation's copy is no work
    want = {"hbr.serve.request": (2, 80 + 5, 80 - 39 + 5, 39),
            "hbr.serve.render": (1, 40, 40 - 25, 25),
            "hbr.serve.encode": (1, 28, 28 - 10, 0)}
    assert set(got) == set(want)
    for name, (n, host, idle, device) in want.items():
        g = got[name]
        assert g["n"] == n, name
        assert [g["host_s"], g["idle_s"], g["device_s"]] == pytest.approx(
            [host * 1e-6, idle * 1e-6, device * 1e-6]), name


def test_benchmark_reduce_counts_no_program_span_as_device_work():
    def reduce(events):
        seg = types.SimpleNamespace(
            prof=types.SimpleNamespace(events=lambda: events))
        return trace.reduce(seg)

    plain, spanned = reduce(stub_trace(False)), reduce(stub_trace(True))
    for key in ("window_s", "busy_s", "kernels"):
        assert spanned[key] == plain[key], key
    assert (spanned["breakdown"]["device_ops"]
            == plain["breakdown"]["device_ops"])
    assert plain["busy_s"] == pytest.approx(39e-6)
    gaps = dict(spanned["breakdown"]["idle_gaps"])
    # the idle gap [70, 100] is labelled with the encode's span
    assert "bench.RenderServer.handle / hbr.serve.encode" in gaps
