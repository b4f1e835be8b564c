"""Host-bytes entry: `api.compress(obj)` then `api.decompress(blob)`.

Host bytes in and host bytes out, as a library caller or `serve` hands
them over: each call is timed from entry to return, the device
synchronised before it returns, so the chunking, pinned copies, crc32
and the container's build and parse are inside the calls. The answers
are host bytes already; a kept one is held as it is. `guarantees`
checks, after the window, that a kept container whose crc32 trailer is
altered is refused (`verify=True`). `host_phases` runs compress calls
with the program's `MHC_TRACE` report on, after the traced window, and
returns the reports.
"""

from __future__ import annotations

import contextlib
import io
import json
import os

import torch

from mhc_tpu_torch import api


class Entry:
    encode_span = "api.compress"
    decode_span = "api.decompress"

    def __init__(self, config: dict, traffic: dict, objects: list, device):
        self.config = config
        self.dev = torch.device(device)
        self.objects = [o.tobytes() for o in objects]

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def encode(self, k: int) -> bytes:
        c = self.config
        blob = api.compress(self.objects[k], mode=c["mode"],
                            block_size=c["block_size"], crc=c["crc"],
                            decode_unit=c["decode_unit"], device=self.dev)
        self._sync()
        return blob

    def decode(self, k: int, blob: bytes) -> bytes:
        data = api.decompress(blob, verify=self.config["verify"],
                              device=self.dev)
        self._sync()
        return data

    def in_bytes(self, k: int) -> int:
        return len(self.objects[k])

    @staticmethod
    def payload_bytes(blob: bytes) -> int:
        return len(blob)

    @staticmethod
    def out_bytes(k: int, data: bytes) -> int:
        return len(data)

    @staticmethod
    def keep(k: int, blob: bytes, data: bytes):
        return k, blob, data

    @staticmethod
    def judge(sample):
        return sample

    def guarantees(self, samples: list) -> dict:
        """{"crc_unverified": [containers with an altered crc32 trailer
        that decompress accepted, 0]} over the kept answers."""
        accepted = 0
        for _, blob, _ in samples:
            bad = bytearray(blob)
            bad[-1] ^= 0xFF
            try:
                self.decode(0, bytes(bad))
                accepted += 1
            except ValueError:
                pass
        return {"crc_unverified": [accepted, 0]}

    def host_phases(self, calls: int) -> list:
        """The `[mhc-trace compress]` reports of `calls` compress calls,
        the pool in turn."""
        reports = []
        os.environ["MHC_TRACE"] = "1"
        try:
            for i in range(calls):
                err = io.StringIO()
                with contextlib.redirect_stderr(err):
                    self.encode(i % len(self.objects))
                for line in err.getvalue().splitlines():
                    if line.startswith("[mhc-trace compress] "):
                        reports.append(json.loads(line.split(" ", 2)[2]))
        finally:
            os.environ.pop("MHC_TRACE", None)
        return reports

    def close(self):
        pass
