"""Device-resident entry through the sharded pipeline, in a world of one
rank, with the device memory its calls hold: the `resident` entry
(loaded from its file, not copied) on BASELINE config 5's steps.

The share is staged on the card in set-up, as in `resident`. The
process is a one-rank `torch.distributed` world (NCCL on a card, gloo on
the CPU, met through a FileStore in a temporary directory), made here
unless one is initialised already and ended by `close`. Each timed
encode is `pipeline.encode_staged`: the share's counts all-reduced over
the world, the tables built from the sums, the engine's encode with
them; each decode is `engine.decode`, as in `resident`: a rank decodes
its own share. `judge` runs the ordered gather on the kept answer
(`pipeline.gather_container`, `pipeline.gather_bytes`), which writes the
corpus's container and bytes. On a program without `encode_staged` the
entry raises before it stages anything.

`host_phases(calls)`, after the traced window, runs `calls` round trips,
each call under a torch.profiler of its own that records every
allocation and free of the card's caching allocator (`profile_memory`):
the bytes allocated at the call's entry plus the events' running sum
give the call's peak, and the program's `mhc.*` span innermost at it.
Nothing resets the allocator's peak statistics, so the harness's peak
of a traced run still covers its window. For each call a dict: `role`
("encode" or "decode"), `bytes` (the object's), `entry_bytes`,
`peak_bytes`, `peak_step` (the span at the peak; None outside every
span) and `steps` ([span name, the most held inside it] in the order the
spans opened). Off a card, nothing.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from mhc_tpu_torch.parallel import mesh as meshmod, pipeline


def held(mem: list, ranges: list, entry: int) -> tuple:
    """(peak bytes, the innermost range at the peak or None, [[range
    name, the most held inside it]]) from memory events (time, bytes
    allocated or, negative, freed) and ranges (start, end, name) on one
    clock, `entry` bytes held before the first event. Ranges nest, so
    the innermost is the latest to open of those around the event."""
    ranges = sorted(ranges)
    most = [None] * len(ranges)
    level, peak, at = entry, entry, None
    for t, n in sorted(mem):
        level += n
        inside = [i for i, (a, b, _) in enumerate(ranges) if a <= t <= b]
        for i in inside:
            most[i] = level if most[i] is None else max(most[i], level)
        if level > peak:
            peak, at = level, ranges[inside[-1]][2] if inside else None
    return peak, at, [[r[2], m] for r, m in zip(ranges, most)
                      if m is not None]


def memory_events(events, device: torch.device) -> tuple:
    """(memory events, `mhc.*` ranges) of a profiler's kineto events, in
    held's form: the allocator's events on `device` alone."""
    kind = DeviceType.CUDA if device.type == "cuda" else DeviceType.CPU
    mem, ranges = [], []
    for e in events:
        name = e.name()
        if (name == "[memory]" and e.device_type() == kind
                and (kind == DeviceType.CPU
                     or e.device_index() == device.index)):
            mem.append((e.start_ns(), e.nbytes()))
        elif name.startswith("mhc."):
            ranges.append((e.start_ns(), e.end_ns(), name))
    return mem, ranges


class Entry(harness.load_entry("resident").Entry):
    encode_span = "pipeline.encode_staged"

    def __init__(self, config: dict, traffic: dict, objects: list, device):
        self.encode_staged = pipeline.encode_staged
        self.dev = torch.device(device)
        if self.dev.type == "cuda" and self.dev.index is None:
            self.dev = torch.device("cuda", torch.cuda.current_device())
        self.store_dir = None
        if not dist.is_initialized():
            self.store_dir = tempfile.mkdtemp(prefix="mhc-world-")
            if self.dev.type == "cuda":
                os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
                torch.cuda.set_device(self.dev)
            dist.init_process_group(
                "nccl" if self.dev.type == "cuda" else "gloo",
                store=dist.FileStore(os.path.join(self.store_dir, "store"),
                                     1), rank=0, world_size=1)
        self.mesh = meshmod.make_mesh(self.dev)
        super().__init__(config, traffic, objects, self.dev)

    def encode(self, k: int):
        enc = self.encode_staged(self.staged[k], self.mesh)
        self._sync()
        return enc

    def judge(self, sample):
        """(object index, the corpus's container, its bytes) of a kept
        answer, through the ordered gather."""
        k, enc, rows = sample
        return (k, pipeline.gather_container(enc, self.crcs[k], self.mesh),
                pipeline.gather_bytes(enc, rows, self.mesh))

    def _held_call(self, role: str, k: int, call) -> tuple:
        """(call's result, its reading): `call()` under a profiler that
        records the allocator's events."""
        torch.cuda.synchronize(self.dev)
        entry = torch.cuda.memory_allocated(self.dev)
        with profile(activities=[ProfilerActivity.CPU],
                     profile_memory=True) as prof:
            out = call()
        peak, at, steps = held(*memory_events(
            prof.profiler.kineto_results.events(), self.dev), entry)
        return out, {"role": role, "bytes": self.in_bytes(k),
                     "entry_bytes": entry, "peak_bytes": peak,
                     "peak_step": at, "steps": steps}

    def host_phases(self, calls: int) -> list:
        if self.dev.type != "cuda":
            return []
        readings = []
        for i in range(calls):
            k = i % len(self.staged)
            enc, r = self._held_call("encode", k, lambda: self.encode(k))
            readings.append(r)
            out, r = self._held_call("decode", k,
                                     lambda: self.decode(k, enc))
            readings.append(r)
            del enc, out
        return readings

    def close(self):
        super().close()
        if self.store_dir is not None:
            dist.destroy_process_group()
            shutil.rmtree(self.store_dir, ignore_errors=True)
            self.store_dir = None
