"""Device-resident entry: `engine.encode(staged)` then `engine.decode(enc)`.

The pool's objects are staged on the card in set-up with `engine.stage`,
outside the window: the engine's own contract ("Not part of codec
time"). Each call is timed from entry to return, the device
synchronised before it returns. A kept answer is copied to the host
(the payload and the decoded rows) outside the calls; once the window
has closed, `judge` assembles the container from it
(`engine.assemble_container`) and fetches the decoded bytes
(`engine.fetch_bytes`), both the program's own host steps.
"""

from __future__ import annotations

import dataclasses
import zlib

import torch

from mhc_tpu_torch import engine


class Entry:
    encode_span = "engine.encode"
    decode_span = "engine.decode"

    def __init__(self, config: dict, traffic: dict, objects: list, device):
        self.config = config
        self.dev = torch.device(device)
        self.crcs = [zlib.crc32(o) & 0xFFFFFFFF if config["crc"] else None
                     for o in objects]
        self.staged = [engine.stage(o, mode=config["mode"],
                                    block_size=config["block_size"],
                                    decode_unit=config["decode_unit"],
                                    device=self.dev) for o in objects]

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def encode(self, k: int):
        enc = engine.encode(self.staged[k])
        self._sync()
        return enc

    def decode(self, k: int, enc):
        out = engine.decode(enc)
        self._sync()
        return out

    def in_bytes(self, k: int) -> int:
        return self.staged[k].orig_len

    @staticmethod
    def payload_bytes(enc) -> int:
        return int(enc.byte_lens.sum())

    def out_bytes(self, k: int, out) -> int:
        return self.staged[k].orig_len

    def keep(self, k: int, enc, out):
        return k, dataclasses.replace(enc, payload=enc.payload.cpu()), \
            out.cpu()

    def judge(self, sample):
        """(object index, container bytes, decoded bytes) of a kept
        answer."""
        k, enc, rows = sample
        return (k, engine.assemble_container(enc, self.crcs[k]),
                engine.fetch_bytes(enc, rows))

    def close(self):
        self.staged = []
