"""Finding a cell's files by name.

A cell is ``workloads/<cell>.json`` ({"config", "traffic", "chips", "why",
"limits"}); it names a configuration, ``configs/<config>.json`` (the
sizes as the program runs them, under "pipeline"), and a traffic mix,
``traffic/<traffic>.json``, whose "driver" names the module of
``traffic/`` that generates it.  A per-layer metric is
``metrics/<metric>.py``, with ``read(run)`` returning its value or None.
Later cells, configurations, mixes and metrics are new files; nothing here
names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    why: str


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(name: str, base: Path = HERE) -> Cell:
    w = _json(base / "workloads" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(base / "configs" / f"{w['config']}.json"),
                traffic=_json(base / "traffic" / f"{w['traffic']}.json"),
                limits=w.get("limits", {}), why=w["why"])


def driver(cell: Cell):
    return importlib.import_module(f"benchmark.traffic.{cell.traffic['driver']}")


def metric_modules(base: Path = HERE) -> dict:
    """{metric name: module} of every ``metrics/<name>.py``."""
    out = {}
    for path in sorted((base / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{path.stem.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def listed_metrics(cell_name: str, root: Path = ROOT) -> list:
    """The per-layer metrics BENCHMARK.json lists for the cell: those whose
    "workloads" name it, and those without the key."""
    path = root / "BENCHMARK.json"
    if not path.exists():
        return []
    bench = _json(path)
    return [m["name"] for m in bench.get("per_layer", [])
            if cell_name in m.get("workloads", [cell_name])]


def program_config(pipeline: dict):
    """The program's PipelineConfig from a configuration's "pipeline"."""
    from human_body_reconstruction_tpu_torch.utils import config as C

    sections = {"hash": C.HashConfig, "dir_enc": C.PosEncConfig,
                "mlp": C.MLPConfig, "render": C.RenderConfig,
                "train": C.TrainConfig}
    return C.PipelineConfig(**{k: cls(**pipeline[k])
                               for k, cls in sections.items()})


def scratch():
    """A fresh directory under the run's TMPDIR for what the program
    writes (its bounds, logs, a served checkpoint); ``cleanup()`` removes
    it, as does the interpreter's exit."""
    import tempfile

    return tempfile.TemporaryDirectory(prefix="bench_",
                                       dir=os.environ.get("TMPDIR"))
