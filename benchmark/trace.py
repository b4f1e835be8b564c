"""A traced window, read from torch.profiler: device intervals, the
harness's spans and the host's ops, on the profiler's one clock (us).

The arithmetic of the per-layer metrics lives here, on plain tuples, so
that the CPU tests can run it on synthetic events:
  union_us      the time covered by a set of intervals;
  busy_in       the device intervals clipped to a span, their union;
  idle gaps     the stretches of a span with no device interval, each
                labelled by the harness span and the innermost host op
                running at its midpoint.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

# device events that are no device work: the profiler's copies of the
# host's annotations
_ANNOTATION_TYPES = ("gpu_user_annotation", "user_annotation")


@dataclass
class TraceData:
    """device: (start, end, name, kind) with kind "kernel" or "copy";
    spans: span name -> [(start, end)]; roles: "encode" and "decode" ->
    the span name of the calls in that direction; host_ops: (start,
    end, name), sorted by start; host_phases: the program's own
    `MHC_TRACE` reports (dicts), where the entry collects them."""
    device: list
    spans: dict
    roles: dict = field(default_factory=dict)
    host_ops: list = field(default_factory=list)
    host_phases: list = field(default_factory=list)

    def of(self, role: str) -> list:
        """The spans of the calls in direction `role`."""
        return self.spans.get(self.roles.get(role), [])

    @property
    def calls(self) -> list:
        """Every call's span, in time order: the traced window is the
        calls, not the harness's work between them."""
        return sorted(s for v in self.spans.values() for s in v)

    @property
    def window_s(self) -> float:
        return sum(e - s for s, e in self.calls) / 1e6

    @property
    def busy_s(self) -> float:
        """Seconds of the calls in which an operation ran on the
        device."""
        return busy_in(self.device, self.calls) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most time inside the calls, by
        name, and the calls' idle gaps' time by what the host was doing,
        each [name, s]."""
        by_name: dict = defaultdict(float)
        for sp in self.calls:
            for s, e, name, _ in self.device:
                s, e = max(s, sp[0]), min(e, sp[1])
                if e > s:
                    by_name[name] += (e - s) / 1e6
        gaps: dict = defaultdict(float)
        for (s, e), label in label_gaps(self):
            gaps[label] += (e - s) / 1e6
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order(by_name)],
                "idle_gaps": [[k, v] for k, v in order(gaps)]}


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _clip(device, span):
    a, b = span
    return [(max(s, a), min(e, b)) for s, e, *_ in device
            if e > a and s < b]


def busy_in(device, spans) -> float:
    """Device time (us) inside the spans: per span, the union of the
    device intervals clipped to it; summed over the spans."""
    return sum(union_us(_clip(device, sp)) for sp in spans)


def kernel_us_in(device, spans) -> float:
    """Summed duration (us) of the kernels (not copies) inside the spans,
    each clipped to its span."""
    kernels = [d for d in device if d[3] == "kernel"]
    return sum(e - s for sp in spans for s, e in _clip(kernels, sp))


def gaps_in(device, span) -> list:
    """(start, end) stretches of `span` with no device interval."""
    a, b = span
    out, t = [], a
    for s, e in sorted(_clip(device, span)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if b > t:
        out.append((t, b))
    return out


def label_gaps(data: TraceData) -> list:
    """Each idle gap of each span with its label: "<span> / <innermost
    host op at the gap's midpoint>", or "<span> / python" where no op
    runs there."""
    starts = [op[0] for op in data.host_ops]
    out = []
    for name, spans in data.spans.items():
        for sp in spans:
            for g in gaps_in(data.device, sp):
                mid = (g[0] + g[1]) / 2
                out.append((g, f"{name} / {_op_at(data.host_ops, starts, mid)}"))
    return out


def _op_at(ops, starts, t, scan: int = 4096) -> str:
    """The op that started last among those running at t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - scan), -1):
        if ops[j][1] >= t:
            return ops[j][2]
    return "python"


def from_profiler(prof, roles: dict) -> TraceData:
    """TraceData from a finished torch.profiler.profile: CUDA events as
    device intervals (annotations left out; "Memcpy"/"Memset" are
    copies, the rest kernels), the harness's spans by name, the other
    host events as host ops. `roles`: "encode" and "decode" -> span
    name."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    spans: dict = {n: [] for n in roles.values()}
    for e in prof.events():
        s, t = float(e.time_range.start), float(e.time_range.end)
        kind = str(getattr(e, "activity_type", "") or "")
        if e.device_type == cuda:
            if (getattr(e, "is_user_annotation", False)
                    or kind in _ANNOTATION_TYPES or e.name in spans):
                continue
            copy = (e.name.startswith(("Memcpy", "Memset"))
                    or "mem" in kind.lower())
            device.append((s, t, e.name, "copy" if copy else "kernel"))
        elif e.name in spans:
            spans[e.name].append((s, t))
        else:
            host.append((s, t, e.name))
    host.sort()
    return TraceData(device=device, spans=spans, roles=dict(roles),
                     host_ops=host)
