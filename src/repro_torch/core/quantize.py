"""Sign-bit packing of token embeddings (Nardini et al. 2024), host numpy.

The bit table the ``bitvec`` and ``cascade`` backends filter against stores
every document token as its sign bits, packed little-endian into integer
lanes. The packers are numpy so the bits come out identical to the
reference's; the ``kernels/bitsim`` op unpacks them on the device.
"""
from __future__ import annotations

import numpy as np

#: Integer lane dtypes accepted by ``binary_pack`` (the bit-table packing
#: dtype knob). uint8 wastes no padding for d % 32 != 0; uint32 matches the
#: bitsim kernel's native lane width.
PACK_DTYPES = ("uint8", "uint16", "uint32")


def binary_pack(x: np.ndarray, dtype: str = "uint32") -> np.ndarray:
    """Sign-bit packing of the last axis into integer lanes.

    (..., d) floats -> (..., ceil(d / lane_bits)) unsigned ints, bit j of
    lane w = 1 iff x[..., 32*w + j] > 0 (little-endian bit order, so a view
    as uint8 round-trips across lane dtypes).
    """
    if dtype not in PACK_DTYPES:
        raise ValueError(f"pack dtype {dtype!r}; expected one of {PACK_DTYPES}")
    bits = (np.asarray(x) > 0).astype(np.uint8)
    packed = np.packbits(bits, axis=-1, bitorder="little")
    lane = np.dtype(dtype).itemsize
    pad = -packed.shape[-1] % lane
    if pad:
        packed = np.concatenate(
            [packed, np.zeros((*packed.shape[:-1], pad), np.uint8)], -1)
    return np.ascontiguousarray(packed).view(dtype)


def binary_unpack(packed: np.ndarray, d: int) -> np.ndarray:
    """Inverse of ``binary_pack``: (..., W) lanes -> (..., d) fp32 in {-1,+1}."""
    raw = np.ascontiguousarray(packed).view(np.uint8)
    bits = np.unpackbits(raw, axis=-1, bitorder="little")[..., :d]
    return bits.astype(np.float32) * 2.0 - 1.0


def to_uint32_lanes(packed: np.ndarray) -> np.ndarray:
    """Re-view any lane dtype as the kernel-native uint32 lanes (bit-exact;
    pads the last axis with zero bytes when needed)."""
    if packed.dtype == np.uint32:
        return packed
    raw = np.ascontiguousarray(packed).view(np.uint8)
    pad = -raw.shape[-1] % 4
    if pad:
        raw = np.concatenate(
            [raw, np.zeros((*raw.shape[:-1], pad), np.uint8)], -1)
    return np.ascontiguousarray(raw).view(np.uint32)
