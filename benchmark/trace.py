"""The traced segment of a run: torch.profiler over a span of the window,
reduced to what the per-layer metrics read.

The benchmark marks its own calls into the program with
``record_function`` spans ("bench.<call>"), and the segment with one
span, "bench.segment", that ends after a synchronise.  From the profiler's
events: the segment's length (the span's), the device's busy time (the
union of every kernel, copy and set on the device inside it; the
profiler's mirror of the benchmark's spans on the device's timeline is
left out), the device
time and launches of each kernel by name, the longest idle gaps labelled by
what the host was doing (the innermost host event under way, under the
benchmark span around it), and the operations that took most device time.
A segment in which the profiler recorded no device event is refused: it
has nothing to read, and a share of 0 would be a wrong reading.
"""

from __future__ import annotations

import torch

SEGMENT = "bench.segment"
GEMM_KEYS = ("gemm", "sm90_xmma", "cutlass", "ampere")
ENCODER_KEYS = ("cp_forward_kernel", "cp_backward_kernel",
                "dense_forward_kernel", "dense_backward_kernel",
                "hash_forward_kernel", "hash_backward_kernel",
                "uniform_bits_kernel")
TOP = 10
NAME_CHARS = 160                # a kernel's demangled name, cut
PROFILER_OWN = ("Activity Buffer Request",)


class NoDeviceEvents(RuntimeError):
    pass


def span(name: str):
    """A host span around a call into the program (a no-op untraced)."""
    return torch.profiler.record_function(f"bench.{name}")


class Segment:
    """Starts the profiler and the segment's span; ``close()`` ends the
    span after a synchronise and stops the profiler."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._span = torch.profiler.record_function(SEGMENT)
        self._span.__enter__()

    def close(self):
        torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)


def _union(spans):
    busy, end, merged = 0.0, float("-inf"), []
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = b
            else:
                merged.append([a, b])
            end = b
    return busy, merged


def reduce(seg: Segment) -> dict:
    """{"window_s", "busy_s", "kernels": {name: [launches, seconds]},
    "breakdown": {"device_ops", "idle_gaps"}} of the segment."""
    events = seg.prof.events()
    marks = [e for e in events if e.name == SEGMENT
             and e.device_type == torch.autograd.DeviceType.CPU]
    if not marks:
        raise NoDeviceEvents("the profiler recorded no segment span")
    lo, hi = marks[0].time_range.start, marks[0].time_range.end
    device, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the benchmark's spans are mirrored on the device's timeline
            # as annotations: they are no device work
            if b > lo and a < hi and not e.name.startswith("bench."):
                device.append((max(a, lo), min(b, hi), e.name))
        elif (e.name != SEGMENT and e.name not in PROFILER_OWN
              and b > lo and a < hi):
            host.append((a, b, e.name))
    if not device:
        raise NoDeviceEvents("the profiler recorded no device event in the "
                             "traced segment")
    busy, merged = _union([(a, b) for a, b, _ in device])
    kernels = {}
    for a, b, name in device:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-6
    gaps, edge = [], lo
    for a, b in merged:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if hi > edge:
        gaps.append((edge, hi))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6,
            "kernels": kernels,
            "breakdown": {
                "device_ops": [[n[:NAME_CHARS], s] for n, (_, s) in sorted(
                    kernels.items(), key=lambda kv: -kv[1][1])[:TOP]],
                "idle_gaps": [[_label(host, a, b), (b - a) * 1e-6]
                              for a, b in gaps[:TOP]]}}


def _label(host, a, b) -> str:
    """What the host was doing in the gap (a, b): the benchmark span and
    the innermost host event under way at its midpoint."""
    mid = 0.5 * (a + b)
    under = [(s, e, n) for s, e, n in host if s <= mid <= e]
    bench = [x for x in under if x[2].startswith("bench.")]
    other = [x for x in under if not x[2].startswith("bench.")]
    parts = []
    if bench:
        parts.append(max(bench, key=lambda x: x[0])[2])
    if other:
        parts.append(max(other, key=lambda x: x[0])[2])
    return " / ".join(parts) or "host outside any recorded event"


def seconds_matching(kernels: dict, keys) -> float:
    return sum(s for name, (_, s) in kernels.items()
               if any(k in name.lower() for k in keys))

