"""mhc_tpu_torch — the Markov-Huffman codec in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `mhc_tpu` (JAX/Pallas on a TPU), which stays beside it as the
reference: for the same (bytes, mode, block_size, decode_unit, crc) both
packages write the same MHTC container, and each decodes the other's.
This package imports torch and numpy only, never jax or mhc_tpu.

Ported so far: both modes, Markov and order-0 (histogram, table build —
on the device on a card, on the host elsewhere — lookup+pack — fused; or split into a cl-plane lookup and a pack,
pack_method="dense"; or the lookup and the bubble-stream pack,
pack_method="pallas" — and decode), through the device-resident
`engine`, the chunked host-bytes `compress`/`decompress`, the file
functions with segment chaining, the `hybrid` host/device split, the
data-parallel sharded pipeline on `torch.distributed` (`parallel/`),
the CLI (`python -m mhc_tpu_torch.cli encode|decode|stat`), the HTTP
codec service (`python -m mhc_tpu_torch.serve`) and the observability
of `utils.metrics` (`Trace`, the `MHC_TRACE` phase trace of `compress` /
`decompress`, `torch_profile`, `scaling_report`).
`device=None` means the first CUDA card and raises without one; the CPU
runs only when named.
"""

from .api import (DEFAULT_BLOCK_SIZE, DEFAULT_DECODE_UNIT,
                  DEFAULT_SEGMENT_SIZE, compress, compress_file,
                  compression_report, decompress, decompress_file)
from .models.entropy import MARKOV, ORDER0, get_model

__version__ = "0.1.0"

__all__ = [
    "compress", "decompress", "compress_file", "decompress_file",
    "compression_report", "get_model", "ORDER0", "MARKOV",
    "DEFAULT_BLOCK_SIZE", "DEFAULT_DECODE_UNIT", "DEFAULT_SEGMENT_SIZE",
    "__version__",
]
