"""Structured training metrics and gradient norms (the ``MetricsLogger``
and ``grad_norms`` of the JAX utils/observability.py, which imports JAX at
its top and so cannot be reused).  The JAX module's profiler and debug
helpers are not ported: ``torch.profiler`` is used directly where a trace
is wanted."""

from __future__ import annotations

import csv
import json
import os
import time

import torch


def param_groups(field) -> dict:
    """A field's parameters grouped as the keys of the JAX params dict:
    ``dense`` (with dense levels), ``lines`` (CP) or ``table`` (hash grid),
    ``mlp``, and ``var`` (SDF)."""
    groups = {}
    if len(field.dense):
        groups["dense"] = list(field.dense)
    if field.variant == "cp":
        groups["lines"] = list(field.lines)
    elif field.table is not None:
        groups["table"] = [field.table]
    groups["mlp"] = list(field.mlp.parameters())
    if field.var_b is not None:
        groups["var"] = [field.var_b]
    return groups


def grad_norms(grads: dict) -> dict:
    """Per-group global norm of gradients {group: [tensors]}, under the
    JAX keys ``grad_norm/<group>`` (the square root of the sum of every
    element's square, in f32; 0 for an empty group)."""
    out = {}
    for key, leaves in grads.items():
        total = sum((torch.sum(g.to(torch.float32) ** 2) for g in leaves),
                    torch.zeros(()))
        out[f"grad_norm/{key}"] = torch.sqrt(total)
    return out


class MetricsLogger:
    """Append-only metrics sink: ``<name>.jsonl`` and ``<name>.csv`` in
    ``out_dir``.  The CSV's columns are the first record's keys."""

    def __init__(self, out_dir: str, name: str = "metrics"):
        os.makedirs(out_dir, exist_ok=True)
        self.csv_path = os.path.join(out_dir, f"{name}.csv")
        self.jsonl_path = os.path.join(out_dir, f"{name}.jsonl")
        self._fields = None

    def log(self, record: dict):
        record = {k: (float(v) if hasattr(v, "item") else v)
                  for k, v in record.items()}
        record.setdefault("time", time.time())
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._fields is None:
            self._fields = list(record.keys())
        new = not os.path.exists(self.csv_path)
        with open(self.csv_path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fields)
            if new:
                writer.writeheader()
            writer.writerow({k: record.get(k, "") for k in self._fields})
