"""Observability: the program's spans, phase reports, profiles.

Counterpart of `mhc_tpu/utils/metrics.py`. Every layer marks its steps
with `span(name)`: the api's phases (`mhc.api.*`), the engine's host plan
(`mhc.engine.*`), each kernel wrapper's launch (`mhc.launch.<kernel>`)
and each place the host waits for the device (`mhc.wait.*`). A span
never synchronises the device. With nothing listening it costs one flag
check and one context lookup. While a `torch.profiler` runs, each span
is a `record_function` range on the profiler's own clock, nested in the
caller's ranges, so that the device trace's idle time can be put down to
a program step. Inside `with tracing() as tr:` the spans of the current
context (a thread's, never another's) are also recorded in `tr.spans`;
`tr.report()` gives the reference's `Trace` report (seconds, bytes, GB/s
and calls per phase) of the api's phases, host time alone.
`torch_profile` stands in for `jax_profile`, and `scaling_report` is the
reference's.
"""

from __future__ import annotations

import contextvars
import json
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

# the trace the current context records into, or None
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("mhc_trace",
                                                         default=None)
# the span of a step that nothing listens to
_OFF = nullcontext()


class Span(NamedTuple):
    """One recorded span: its parent's index in `Trace.spans` (None at
    the top), the id shared by every span under one top-level span,
    perf_counter_ns at entry and at exit (None while open), and the
    bytes it handled."""
    name: str
    parent: int | None
    call: int
    t0_ns: int
    t1_ns: int | None
    nbytes: int


@dataclass
class PhaseStats:
    seconds: float = 0.0
    bytes: int = 0
    calls: int = 0

    @property
    def gbps(self) -> float | None:
        return self.bytes / self.seconds / 1e9 if self.seconds else None


@dataclass
class Trace:
    """The spans of one context, in the order they were entered."""
    spans: list = field(default_factory=list)
    _open: list = field(default_factory=list, repr=False)
    _calls: int = field(default=0, repr=False)

    def _enter(self, name: str, nbytes: int) -> int:
        parent = self._open[-1] if self._open else None
        if parent is None:
            call, self._calls = self._calls, self._calls + 1
        else:
            call = self.spans[parent].call
        self.spans.append(Span(name, parent, call, time.perf_counter_ns(),
                               None, nbytes))
        self._open.append(len(self.spans) - 1)
        return self._open[-1]

    def _exit(self, i: int) -> None:
        self.spans[i] = self.spans[i]._replace(t1_ns=time.perf_counter_ns())
        self._open.pop()

    def report(self, omit=(), root: int | None = None) -> dict:
        """{phase: {seconds, bytes, GBps, calls}} over the api's phases:
        the `mhc.api.<phase>` spans directly under the span at index
        `root`, or (None) under any top-level `mhc.api.*` span, each
        phase named by its last part, those in `omit` left out."""
        stats: dict = {}
        for s in self.spans:
            if s.parent is None or s.t1_ns is None:
                continue
            top = self.spans[s.parent]
            phase = s.name.rsplit(".", 1)[-1]
            if root is None:
                under = (top.parent is None
                         and top.name.startswith("mhc.api."))
            else:
                under = s.parent == root
            if (not under or phase in omit
                    or not s.name.startswith("mhc.api.")):
                continue
            st = stats.setdefault(phase, PhaseStats())
            st.seconds += (s.t1_ns - s.t0_ns) / 1e9
            st.bytes += s.nbytes
            st.calls += 1
        return {
            name: {
                "seconds": round(st.seconds, 6),
                "bytes": st.bytes,
                "GBps": round(st.gbps, 4) if st.gbps else None,
                "calls": st.calls,
            }
            for name, st in stats.items()
        }

    def dumps(self, omit=(), root: int | None = None) -> str:
        return json.dumps(self.report(omit, root))


@contextmanager
def tracing(join: bool = False):
    """Record the spans of the current context into a new `Trace` for
    the block's length: `with metrics.tracing() as tr: api.compress(...)`.
    Other threads' spans stay out. With `join`, a trace already active
    in the context is the one yielded and recorded into."""
    tr = _ACTIVE.get() if join else None
    if tr is not None:
        yield tr
        return
    tr = Trace()
    token = _ACTIVE.set(tr)
    try:
        yield tr
    finally:
        _ACTIVE.reset(token)


def span(name: str, nbytes: int = 0):
    """The context of one program step named `name` (`mhc.<layer>.<step>`)
    that handles `nbytes` bytes: a `record_function` range while a
    profiler runs, a `Span` of the active `tracing()` (the context yields
    its index in `Trace.spans`), and otherwise one shared no-op context."""
    if not _profiler._is_profiler_enabled and _ACTIVE.get() is None:
        return _OFF
    return _recorded(name, nbytes)


@contextmanager
def _recorded(name: str, nbytes: int):
    tr = _ACTIVE.get()
    with (torch.profiler.record_function(name)
          if _profiler._is_profiler_enabled else _OFF):
        if tr is None:
            yield
            return
        i = tr._enter(name, nbytes)
        try:
            yield i
        finally:
            tr._exit(i)


@contextmanager
def torch_profile(outdir: str, device):
    """Wrap a region in a torch.profiler trace, written into `outdir` as
    a Chrome / TensorBoard trace (`<host>_<pid>.<ns>.pt.trace.json`; view
    with chrome://tracing, Perfetto or TensorBoard). CPU activity always,
    and CUDA kernels and copies where `device` is a CUDA device, which is
    synchronised before the trace ends. Yields the profiler:
    `with metrics.torch_profile('/tmp/trace', 'cuda') as prof: ...`"""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(outdir))) as p:
        yield p
        if cuda:
            torch.cuda.synchronize(dev)


def scaling_report(per_device_bytes: int, n_devices: int,
                   seconds_1: float, seconds_n: float) -> dict:
    """Scaling efficiency vs ideal linear (BASELINE.json:5 '>=80%')."""
    ideal = seconds_1 / n_devices
    eff = ideal / seconds_n if seconds_n else None
    return {
        "n_devices": n_devices,
        "seconds_1dev": seconds_1,
        "seconds_ndev": seconds_n,
        "scaling_efficiency": round(eff, 4) if eff else None,
        "aggregate_GBps": round(
            per_device_bytes * n_devices / seconds_n / 1e9, 4)
        if seconds_n else None,
    }
