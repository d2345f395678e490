"""The port's wall-clock-to-target protocol (cli/speedrun.py) against the
JAX script (scripts/speedrun_30db.py) on the CPU: its flags and defaults,
its config, and its loop, both replayed with the training step, the
occupancy refresh and the holdout render replaced by recorders (the step
counts at which the grid is installed and refreshed, the evaluations and
their kind, and the crossing must be equal); a short run that crosses a low
target; the refusals.  Test names avoid the words that tests/conftest.py
marks slow.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_body_reconstruction_tpu.ops import occupancy as jocc
from human_body_reconstruction_tpu.train import step as jstep
from human_body_reconstruction_tpu_torch.cli import quality_holdout as qh
from human_body_reconstruction_tpu_torch.cli import speedrun
from human_body_reconstruction_tpu_torch.ops import occupancy
from human_body_reconstruction_tpu_torch.train import step
import port_config
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
JAX_KEYS = {"target_db", "crossed", "protocol"}
CROSSED_KEYS = {"steps", "holdout_db", "gate", "wall_s_incl_compile",
                "wall_s_excl_compile", "train_s_excl_evals", "compile_s"}


class _Stop(Exception):
    pass


def load_jax_script(monkeypatch):
    monkeypatch.syspath_prepend(SCRIPTS)
    spec = importlib.util.spec_from_file_location(
        "speedrun_30db", os.path.join(SCRIPTS, "speedrun_30db.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_parser(monkeypatch):
    """The JAX script's argument parser, caught at its parse_args."""
    mod = load_jax_script(monkeypatch)
    caught = {}

    def parse_args(self, *a, **k):
        caught["parser"] = self
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(_Stop):
        mod.main()
    monkeypatch.undo()
    return caught["parser"]


def flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices or ()), type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_time_to_db_flags_match_jax(monkeypatch):
    """The JAX flags with their defaults, types and choices; the port adds
    --device (default cuda) and --seed, and writes under results/."""
    want, got = flags(jax_parser(monkeypatch)), flags(speedrun.build_parser())
    assert set(got) - set(want) == {"device", "seed"}
    out = got.pop("out")
    assert out[1] == os.path.join("results", "speedrun_30db.json")
    assert want.pop("out")[1] == "speedrun_30db.json"
    assert {k: got[k] for k in want} == want
    assert got["device"][1] == "cuda" and got["seed"][1] == 0


def jax_data(H, views=2):
    K = jnp.asarray([[1.1 * H, 0, H / 2], [0, 1.1 * H, H / 2], [0, 0, 1]],
                    jnp.float32)
    train, hold = qh.protocol_poses(views)
    return (K, train, hold, np.zeros((views, H, H, 3), np.float32),
            np.zeros((4, H, H, 3), np.float32))


@pytest.mark.parametrize("rank", [32, 16])
def test_time_to_db_config_matches_jax(rank, monkeypatch, tmp_path):
    """The config the JAX script trains, caught at its first step."""
    mod = load_jax_script(monkeypatch)
    caught = {}

    def train_step(*a, cfg, **k):
        caught["cfg"] = cfg
        raise _Stop

    argv = ["--height", "4", "--cp_rank", str(rank), "--out",
            str(tmp_path / "j.json")]
    monkeypatch.setattr(mod, "load_or_render_gt", lambda *a, **k: jax_data(4))
    monkeypatch.setattr(jstep, "train_step", train_step)
    monkeypatch.setattr(sys, "argv", ["speedrun_30db.py"] + argv)
    with pytest.raises(_Stop):
        mod.main()
    port = speedrun.make_config(speedrun.build_parser().parse_args(argv))
    assert port_config.jax_view(port) == dataclasses.asdict(caught["cfg"])
    assert (port.hash.cp_rank, port.hash.dense_levels) == (rank, 2)


def test_time_to_db_int8_matches_jax_and_runs(monkeypatch, tmp_path):
    """``--encoder int8``: the config the JAX script trains (its record's
    hash flagship: 2 dense and 6 int8 hashed levels at F 4, gradient
    subsampling, Philox uniforms), and a short run of it on the CPU whose
    gates read finite dB and which crosses a low target."""
    mod = load_jax_script(monkeypatch)
    caught = {}

    def train_step(*a, cfg, **k):
        caught["cfg"] = cfg
        raise _Stop

    argv = ["--height", "4", "--encoder", "int8", "--out",
            str(tmp_path / "j.json")]
    monkeypatch.setattr(mod, "load_or_render_gt", lambda *a, **k: jax_data(4))
    monkeypatch.setattr(jstep, "train_step", train_step)
    monkeypatch.setattr(sys, "argv", ["speedrun_30db.py"] + argv)
    with pytest.raises(_Stop):
        mod.main()
    port = speedrun.make_config(speedrun.build_parser().parse_args(argv))
    assert port_config.jax_view(port) == dataclasses.asdict(caught["cfg"])
    h = port.hash
    assert (h.dense_levels, h.num_hashed_levels, h.features_per_level,
            h.pack_format, h.grad_subsample) == (2, 6, 4, "int8", True)
    res = speedrun.main(["--encoder", "int8", "--height", "12", "--views",
                         "2", "--batch", "64", "--max_steps", "24",
                         "--eval_every", "8", "--eval_after_train_db", "0",
                         "--target_db", "12", "--device", "cpu", "--out",
                         str(tmp_path / "s.json")], log=lambda s: None)
    assert "int8+dense" in res["protocol"] and res["evals"]
    assert all(np.isfinite(e["gate_db"]) for e in res["evals"])
    assert res["crossed"] is not None and res["crossed"]["holdout_db"] >= 12


# The replayed loop: 125-step evaluations gated by the guided render of 48
# samples once the grid is in (installed at step 256); the holdout reads
# these dB in turn, so the guided gate at 375 asks for a confirmation that
# misses and the one at 500 for one that crosses.
REPLAY = ["--eval_every", "125", "--eval_guided", "48", "--max_steps", "700",
          "--height", "4", "--views", "2", "--batch", "64"]
REPLAY_DB = [25.0, 26.0, 29.9, 29.5, 30.5, 30.2]


def replay_image(db_seq, ref):
    """A render stub whose k-th image reads db_seq[k] dB against ref."""
    def render(*a, **k):
        db = db_seq[len(render.events)]
        render.events.append(k.get("occ") is not None)
        return ref + 10.0 ** (-db / 20.0)
    render.events = []
    return render


def test_time_to_db_loop_matches_jax(monkeypatch, tmp_path):
    """Install at 256 (one refresh, one step), a refresh whenever steps //
    64 advances, an evaluation every 125 steps (exact before the grid,
    guided after, confirmed exact within 0.25 dB of the target), and the
    crossing at the confirmed step."""
    events = []
    mod = load_jax_script(monkeypatch)

    def jtrain_step(state, *a, **k):
        events.append(None)
        return state, {"loss": 0.0, "psnr": 28.0}

    def jupdate(occ, params, scene, key, cfg, num_cells):
        events.append(num_cells)
        return occ

    jrender = replay_image(REPLAY_DB, np.zeros((4, 4, 3), np.float32))
    monkeypatch.setattr(mod, "load_or_render_gt", lambda *a, **k: jax_data(4))
    monkeypatch.setattr(jstep, "train_step", jtrain_step)
    monkeypatch.setattr(jocc, "update_from_field", jupdate)
    monkeypatch.setattr(jstep, "render_image", jrender)
    monkeypatch.setattr(sys, "argv", ["speedrun_30db.py"] + REPLAY + [
        "--out", str(tmp_path / "j.json")])
    mod.main()
    with open(tmp_path / "j.json") as f:
        jres = json.load(f)
    want = (list(events), list(jrender.events))
    monkeypatch.undo()

    events.clear()

    def train_step(state, *a, **k):
        events.append(None)
        state.step += 1
        return {"loss": torch.tensor(0.0), "psnr": torch.tensor(28.0)}

    def update_from_field(grid, field, scene, cfg, *, num_cells, generator):
        events.append(num_cells)
        return grid

    data = qh.protocol_data(4, 4, 2, "textured", "cpu")
    render = replay_image(REPLAY_DB, data["hold_imgs"][0])
    monkeypatch.setattr(qh, "protocol_data", lambda *a, **k: data)
    monkeypatch.setattr(step, "train_step", train_step)
    monkeypatch.setattr(occupancy, "update_from_field", update_from_field)
    monkeypatch.setattr(step, "render_image", render)
    res = speedrun.main(REPLAY + ["--device", "cpu", "--out",
                                  str(tmp_path / "p.json")],
                        log=lambda s: None)
    assert (events, render.events) == want
    steps, refreshed = 0, []
    for e in events:
        if e is None:
            steps += 1
        else:
            refreshed.append((steps, e))
    assert refreshed == [(n, 2 ** 20) for n in (256, 320, 384, 448)]
    assert render.events == [False, False, True, False, True, False]
    assert res["crossed"]["steps"] == jres["crossed"]["steps"] == 500
    assert res["crossed"]["holdout_db"] == jres["crossed"]["holdout_db"]
    assert res["crossed"]["gate"] == jres["crossed"]["gate"] == "guided48"
    assert set(jres) == JAX_KEYS and set(res) >= JAX_KEYS
    assert set(res["crossed"]) == set(jres["crossed"]) == CROSSED_KEYS
    assert set(res["crossed"]["compile_s"]) == set(
        jres["crossed"]["compile_s"])
    assert [e["steps"] for e in res["evals"]] == [125, 250, 375, 500]
    assert res["protocol"] == jres["protocol"].replace(", 1 steps", "")


def test_time_to_db_cpu_run_crosses(tmp_path):
    """A short run on the CPU with a low target (before the grid installs,
    so the gates are exact renders): the crossing at an evaluation, the
    record written where --out says, with the JAX keys and finite gate
    readings."""
    out = tmp_path / "s.json"
    res = speedrun.main(["--height", "12", "--views", "2", "--batch", "64",
                         "--max_steps", "64", "--eval_every", "8",
                         "--eval_after_train_db", "0", "--target_db", "12",
                         "--eval_guided", "8", "--device", "cpu",
                         "--out", str(out)], log=lambda s: None)
    with open(out) as f:
        assert json.load(f) == res
    assert set(res) == JAX_KEYS | {"evals", "steps", "seed", "card"}
    assert res["card"] == "cpu" and res["crossed"] is not None
    assert set(res["crossed"]) == CROSSED_KEYS
    assert all(np.isfinite(e["gate_db"]) for e in res["evals"])
    assert res["crossed"]["steps"] == res["evals"][-1]["steps"]
    assert res["crossed"]["holdout_db"] >= 12.0


@pytest.mark.parametrize("argv,match", [
    (["--encoder", "int8", "--aot_cache", "c"], "--aot_cache is not ported"),
    (["--steps_per_call", "24", "--eval_every", "250"],
     "--steps_per_call must divide --eval_every"),
    (["--aot_cache", "cache"], "--aot_cache is not ported")],
    ids=["int8", "steps_per_call", "aot_cache"])
def test_time_to_db_refusals(argv, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        speedrun.main(argv + ["--device", "cpu", "--out",
                              str(tmp_path / "s.json")])


def test_time_to_db_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        speedrun.main(["--out", str(tmp_path / "s.json")])
