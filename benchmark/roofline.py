"""The bytes a codec direction must move, and the card's peak.

The least time of an encode is its input read once plus its payload
written once, at the card's memory bandwidth; of a decode, its payload
read once plus its output written once. The count depends only on the
input and the container, so it reads the same work whatever kernels do
it, fused or split, and however often they read their inputs again.
"""

from __future__ import annotations

# NVIDIA H100 SXM (80 GB HBM3), data sheet: 3.35 TB/s at its 700 W limit
HBM_BYTES_PER_S = 3.35e12


def encode_bytes(n_in: int, n_payload: int) -> int:
    return n_in + n_payload


def decode_bytes(n_payload: int, n_out: int) -> int:
    return n_payload + n_out


def least_seconds(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S


def share_pct(n_bytes: int, kernel_s: float) -> float | None:
    """The least time of `n_bytes` as a percentage of the kernels' time;
    None where no kernel time was traced."""
    if kernel_s <= 0:
        return None
    return 100.0 * least_seconds(n_bytes) / kernel_s
