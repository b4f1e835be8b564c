"""Observability: phase timers, throughput counters, structured reports.

Counterpart of `mhc_tpu/utils/metrics.py`: the same `Trace` reports
(seconds, bytes, GB/s and calls per phase), with a whole-device CUDA
synchronisation in place of `jax.block_until_ready`, `torch_profile` in
place of `jax_profile`, and the same `scaling_report`.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass
class PhaseStats:
    seconds: float = 0.0
    bytes: int = 0
    calls: int = 0

    @property
    def gbps(self) -> float | None:
        return self.bytes / self.seconds / 1e9 if self.seconds else None


def _cuda_devices(sync) -> set:
    """The CUDA devices that `sync` (a tensor, a torch.device or a
    sequence of them) names."""
    if isinstance(sync, (list, tuple)):
        return set().union(*map(_cuda_devices, sync))
    dev = sync.device if torch.is_tensor(sync) else torch.device(sync)
    return {dev} if dev.type == "cuda" else set()


@dataclass
class Trace:
    """Collects per-phase wall-clock + throughput for one codec run."""
    phases: dict[str, PhaseStats] = field(default_factory=dict)

    @contextmanager
    def phase(self, name: str, nbytes: int = 0, sync=None):
        """Time a phase. `sync`: a tensor, a torch.device or a sequence of
        them; every CUDA device named is synchronised as a whole before
        the phase ends, so device work on any of its streams (the host
        API copies on a side stream) is attributed to the phase that
        launched it. CPU tensors need no sync."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                for dev in _cuda_devices(sync):
                    torch.cuda.synchronize(dev)
            st = self.phases.setdefault(name, PhaseStats())
            st.seconds += time.perf_counter() - t0
            st.bytes += nbytes
            st.calls += 1

    def report(self) -> dict:
        return {
            name: {
                "seconds": round(st.seconds, 6),
                "bytes": st.bytes,
                "GBps": round(st.gbps, 4) if st.gbps else None,
                "calls": st.calls,
            }
            for name, st in self.phases.items()
        }

    def dumps(self) -> str:
        return json.dumps(self.report())


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
