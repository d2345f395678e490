"""The harness's own parts on the CPU: files found by name, the import
check, the yardstick's counts as functions of shapes alone, the PNG
reader, and a run refused without a card."""

from __future__ import annotations

import ast
import json
import shutil
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from benchmark import cells, correct, counts, inputs, run

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def test_dropped_in_cell_config_and_metric_are_found(tmp_path):
    base = tmp_path / "benchmark"
    for sub in ("workloads", "configs", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, base / sub)
    conf = json.loads((base / "configs" / "flagship.json").read_text())
    conf["name"] = "flagship_wide"
    conf["pipeline"]["mlp"]["width"] = 128
    (base / "configs" / "flagship_wide.json").write_text(json.dumps(conf))
    (base / "traffic" / "train_short.json").write_text(json.dumps(
        dict(json.loads((base / "traffic" / "train_graphed.json")
                        .read_text()), log_every=25)))
    (base / "workloads" / "flagship_wide.train.json").write_text(json.dumps(
        {"config": "flagship_wide", "traffic": "train_short", "chips": 1,
         "why": "a wider head", "limits": {"loss_gap": 1e-3}}))
    (base / "metrics" / "steps.train.py").write_text(
        'UNIT = "steps"\n\n\ndef read(run, seg):\n'
        '    return run.steps if run.kind == "train" else None\n')
    cell = cells.load("flagship_wide.train", base)
    assert cell.config["pipeline"]["mlp"]["width"] == 128
    assert cell.traffic["log_every"] == 25 and cell.chips == 1
    assert cells.driver(cell).__name__ == "benchmark.traffic.train"
    mods = cells.metric_modules(base)
    assert set(mods) >= {"steps.train", "mfu.train", "host_ms.serve"}
    assert mods["steps.train"].UNIT == "steps"


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        assert cell.chips == w["chips"] and cell.why == w["why"]
        assert cell.config["name"] == w["config"]
        cells.program_config(cell.config["pipeline"])
    mods = cells.metric_modules()
    assert {m["name"] for m in bench["per_layer"]} == set(mods)
    for m in bench["per_layer"]:
        assert mods[m["name"]].UNIT == m["unit"]


@pytest.mark.parametrize("names,found", [
    (["jax", "jax.numpy"], ["jax"]), (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["human_body_reconstruction_tpu.ops.rays"],
     ["human_body_reconstruction_tpu"]),
    (["human_body_reconstruction_tpu_torch", "human_body_reconstruction_tpu_"
      "torch.ops.rays", "jaxtyping", "numpy"], [])])
def test_import_check_compares_whole_top_level_names(names, found):
    assert run.forbidden_modules(names) == found


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in run.FORBIDDEN + (
                    "human_body_reconstruction_tpu_torch",), (path, n)


def test_harness_loads_no_jax():
    code = ("import sys; import benchmark.run, benchmark.control, "
            "benchmark.traffic.train, benchmark.traffic.serve; "
            "from benchmark import cells; cells.metric_modules(); "
            "cells.program_config(cells.load('flagship.train')"
            ".config['pipeline']); "
            "from benchmark.run import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "flagship.train", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                         "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""


def _conf(name):
    return cells.load(name).config["pipeline"]


def test_counts_are_functions_of_shapes():
    p = _conf("flagship.train")
    assert counts.encoder_width(p) == 2 * 2 + 5 * 25
    assert counts.mlp_flops(p, 1, False) == 2 * (129 * 64 + 64 * 64 + 64 * 16
                                                 + 39 * 64 + 64 * 64 + 64 * 3)
    assert counts.mlp_flops(p, 10, True) == 30 * counts.mlp_flops(p, 1, False)
    for n in (1000, 768_000):
        assert counts.step_flops(p, 2 * n, False) == 2 * counts.step_flops(
            p, n, False)
        b = counts.encoder_bound_s(p, n, True, False)
        assert b == counts.encoder_bound_s(json.loads(json.dumps(p)), n,
                                           True, False) and b > 0
    h = _conf("hashgrid.train")
    assert counts.table_bytes(h) == {"dense": 0, "hash": 4 * 16 * 2 ** 16 * 2}
    assert (counts.encoder_bound_s(h, 10 ** 6, False, True)
            > counts.encoder_bound_s(h, 10 ** 6, False, False))
    assert counts.sector_bytes(4, 0, 8, 8) == 4 * 32
    assert counts.sector_bytes(1, 4, 125, 129) == 17 * 32


def test_weights_are_the_seeds_and_fit_the_program():
    import torch

    from human_body_reconstruction_tpu_torch.models.nerf import Field

    for name in ("flagship.train", "hashgrid.train"):
        p = _conf(name)
        a = inputs.make_weights(p, 2 ** 40 + 3, "cpu")
        b = inputs.make_weights(p, 2 ** 40 + 3, "cpu")
        assert all(torch.equal(a[k], b[k]) for k in a)
        field = Field(cells.program_config(p))
        inputs.load_into(field, a)
        leaves = inputs.program_leaves(field)
        assert all(torch.equal(leaves[k].detach(), a[k]) for k in a)


def _png(rows: np.ndarray, filters) -> bytes:
    h, w, c = rows.shape
    raw = b""
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        cur = rows[y].reshape(-1).astype(np.int32)
        f = filters[y % len(filters)]
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        pred = {0: 0, 1: left, 2: prev, 3: (left + prev) // 2}.get(f)
        if f == 4:
            pa, pb = np.abs(prev - upleft), np.abs(left - upleft)
            pc = np.abs(left + prev - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw += bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_reader_reads_every_row_filter():
    img = np.random.default_rng(0).integers(0, 256, (7, 5, 3), np.uint8)
    assert np.array_equal(correct.decode_png(_png(img, [0, 1, 2, 3, 4])),
                          img)


def test_png_reader_reads_the_servers_frames():
    from human_body_reconstruction_tpu_torch.data import png

    img = np.random.default_rng(1).integers(0, 256, (9, 11, 3), np.uint8)
    assert np.array_equal(correct.decode_png(png.encode_png(img)), img)
