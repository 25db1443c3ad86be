"""Embedding quantization and the index-size model, host numpy.

ESPN's memory reduction = (full index resident) / (ESPN resident), where ESPN
keeps only the (optionally quantized) ANN index + offsets in memory and the
BOW table lives on the SSD: ``memory_report`` is that analytic model, and
``quantize``/``dequantize`` the per-row symmetric quantizers.

The bit table the ``bitvec`` and ``cascade`` backends filter against stores
every document token as its sign bits (Nardini et al. 2024), packed
little-endian into integer lanes. Everything here is numpy, so the stored
arrays, scales and bits come out identical to the reference's; the
``kernels/bitsim`` op unpacks the bits on the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BYTES = {"fp32": 4, "fp16": 2, "int8": 1, "int4": 0.5, "binary": 0.125}

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


def quantize(x: np.ndarray, mode: str):
    """Symmetric per-row quantization. Returns (stored, scales|None)."""
    if mode == "fp32":
        return x.astype(np.float32), None
    if mode == "fp16":
        return x.astype(np.float16), None
    amax = np.abs(x).max(axis=-1, keepdims=True)
    if mode == "int8":
        scale = np.maximum(amax / 127.0, 1e-9)
        return np.round(x / scale).astype(np.int8), scale.astype(np.float32)
    if mode == "int4":
        scale = np.maximum(amax / 7.0, 1e-9)
        q = np.clip(np.round(x / scale), -8, 7).astype(np.int8)
        # pack two nibbles per byte
        flat = q.reshape(*q.shape[:-1], -1)
        if flat.shape[-1] % 2:
            flat = np.concatenate([flat, np.zeros((*flat.shape[:-1], 1),
                                                  np.int8)], -1)
        lo = flat[..., 0::2] & 0x0F
        hi = (flat[..., 1::2] & 0x0F) << 4
        return (lo | hi).astype(np.uint8), scale.astype(np.float32)
    raise ValueError(mode)


def dequantize(stored: np.ndarray, scales, mode: str, d: int | None = None):
    if mode in ("fp32", "fp16"):
        return stored.astype(np.float32)
    if mode == "int8":
        return stored.astype(np.float32) * scales
    if mode == "int4":
        lo = (stored & 0x0F).astype(np.int8)
        hi = ((stored >> 4) & 0x0F).astype(np.int8)
        lo = np.where(lo > 7, lo - 16, lo)
        hi = np.where(hi > 7, hi - 16, hi)
        q = np.stack([lo, hi], axis=-1).reshape(*stored.shape[:-1], -1)
        if d is not None:
            q = q[..., :d]
        return q.astype(np.float32) * scales
    raise ValueError(mode)


@dataclass
class MemoryReport:
    ann_index_bytes: int
    offsets_bytes: int
    bow_bytes: int
    full_resident: int            # conventional: everything in memory
    espn_resident: int            # ESPN: ANN index + offsets only
    factor: float

    def row(self) -> str:
        gb = 2.0**30
        return (f"ann={self.ann_index_bytes/gb:.2f}GB bow={self.bow_bytes/gb:.2f}GB "
                f"full={self.full_resident/gb:.2f}GB espn={self.espn_resident/gb:.2f}GB "
                f"factor={self.factor:.1f}x")


def memory_report(n_docs: int, mean_tokens: float, *, d_cls: int = 128,
                  d_bow: int = 32, ann_quant: str = "fp16",
                  bow_dtype: str = "fp16", ann_overhead: float = 1.10) -> MemoryReport:
    """Analytic index-size model (the paper's Tables 1-3) + the ESPN memory
    factor."""
    ann = int(n_docs * d_cls * BYTES[ann_quant] * ann_overhead)
    if ann_quant == "int8":
        ann += n_docs * 4                       # scales
    offsets = n_docs * (16 + 4)                 # (start, nblocks) + n_tokens
    bow = int(n_docs * mean_tokens * d_bow * BYTES[bow_dtype])
    full = ann + offsets + bow
    espn = ann + offsets
    return MemoryReport(ann, offsets, bow, full, espn, full / max(espn, 1))
