"""Structured training metrics and gradient norms (the ``MetricsLogger``
and ``grad_norms`` of the JAX utils/observability.py, which imports JAX at
its top and so cannot be reused), and the program's spans in a
``torch.profiler`` trace.

The JAX module's profiler and debug helpers are not ported: a trace is
taken with ``torch.profiler`` directly, and the program marks its host
boundaries in it with ``span`` ("hbr.<layer>.<part>"): the server's request,
render, encode and frame capture, the trainer's windows, captures,
occupancy refreshes and logs.  ``span_summary`` reads them back from a
trace: for each span name, its count, host time, the part of it in which
the device was idle, and the device time of the work launched inside it.
"""

from __future__ import annotations

import bisect
import contextlib
import csv
import json
import os
import time
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_PREFIX = "hbr."
_UNTRACED = contextlib.nullcontext()


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


def span(name: str, args: Optional[dict] = None):
    """``with span("serve.render"):`` records the host span
    ``hbr.serve.render`` in a running ``torch.profiler`` trace, on its
    clock; with no profiler running it is a shared null context (one
    attribute read).  ``args`` are kept, as strings, as the span's keyword
    inputs where the profiler records shapes (the spans of one request
    carry its id).  The span is recorded at the profiler's operator scope,
    not as a user annotation: the profiler copies a user annotation onto
    the device's timeline as one interval from its first kernel to its
    last, which a reader of device work would count as busy.  Spans mark
    host boundaries: none inside code that a CUDA graph captures, nor one
    per chunk or kernel."""
    if not _autograd_profiler._is_profiler_enabled:
        return _UNTRACED
    return torch._C._profiler._RecordFunctionFast(
        SPAN_PREFIX + name, (),
        {k: str(v) for k, v in (args or {}).items()})


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint [start, end]."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def busy_clock(union: list):
    """t -> the length of ``union`` (``merged``'s) that lies before t."""
    starts = [a for a, _ in union]
    before = [0.0]
    for a, b in union:
        before.append(before[-1] + b - a)

    def clock(t: float) -> float:
        i = bisect.bisect_right(starts, t)
        return before[i] - max(0.0, union[i - 1][1] - t) if i else 0.0

    return clock


def _device_work(events):
    """The trace's device events that are work (kernels, copies, sets): the
    profiler's copies of user annotations on the device's timeline are
    not."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_busy(events, lo: float, hi: float) -> list:
    """The union of the device work's intervals inside [lo, hi]."""
    return merged((max(e.time_range.start, lo), min(e.time_range.end, hi))
                  for e in _device_work(events)
                  if e.time_range.end > lo and e.time_range.start < hi)


def span_summary(events, lo: Optional[float] = None,
                 hi: Optional[float] = None) -> dict:
    """The program's spans in a ``torch.profiler`` trace (``prof.events()``;
    times in the trace's microseconds): for each ``hbr.`` name, over the
    spans that start in [lo, hi] (the whole trace when None), each clipped
    to it, {"n", "host_s": their summed length, "idle_s": the part of it in
    which no device work ran, "device_s": the device time, inside [lo, hi],
    of the work whose launching CUDA call started inside the span}.  A
    device event and the runtime or driver call that launched it share the
    profiler's correlation id (one graph launch, every kernel of the
    graph)."""
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    if lo is None:
        lo = min((e.time_range.start for e in events), default=0.0)
    if hi is None:
        hi = max((e.time_range.end for e in events), default=0.0)
    spans = [(e.time_range.start, min(e.time_range.end, hi), e.name)
             for e in cpu if e.name.startswith(SPAN_PREFIX)
             and lo <= e.time_range.start <= hi]
    clock = busy_clock(device_busy(events, lo, hi))
    launch = {e.id: e.time_range.start for e in cpu
              if e.name.startswith("cu")}
    work = sorted((launch[e.id], max(0.0, min(e.time_range.end, hi)
                                     - max(e.time_range.start, lo)))
                  for e in _device_work(events) if e.id in launch)
    starts = [t for t, _ in work]
    out = {}
    for a, b, name in spans:
        s = out.setdefault(name, {"n": 0, "host_s": 0.0, "idle_s": 0.0,
                                  "device_s": 0.0})
        s["n"] += 1
        s["host_s"] += (b - a) * 1e-6
        s["idle_s"] += (b - a - clock(b) + clock(a)) * 1e-6
        s["device_s"] += 1e-6 * sum(
            d for _, d in work[bisect.bisect_left(starts, a):
                               bisect.bisect_right(starts, b)])
    return out
