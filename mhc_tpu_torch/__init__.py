"""mhc_tpu_torch — the Markov-Huffman codec in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `mhc_tpu` (JAX/Pallas on a TPU), which stays beside it as the
reference: for the same (bytes, mode, block_size, decode_unit, crc) both
packages write the same MHTC container, and each decodes the other's.
This package imports torch and numpy only, never jax or mhc_tpu.

Ported so far: both modes, Markov and order-0 (histogram, host table
build, lookup+pack — fused, or split into a cl-plane lookup and a pack
with pack_method="dense" — and decode), through `compress`/`decompress`
and the device-resident `engine`. `device=None` means the first CUDA
card and raises without one; the CPU runs only when named.
"""

from .api import (DEFAULT_BLOCK_SIZE, DEFAULT_DECODE_UNIT, compress,
                  decompress)
from .models.entropy import MARKOV, ORDER0, get_model

__version__ = "0.1.0"

__all__ = [
    "compress", "decompress", "get_model", "ORDER0", "MARKOV",
    "DEFAULT_BLOCK_SIZE", "DEFAULT_DECODE_UNIT", "__version__",
]
