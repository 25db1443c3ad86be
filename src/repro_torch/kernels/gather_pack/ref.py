"""Plain PyTorch version of the gather_pack kernel: the CPU path, and the
oracle ``chip_smoke.py`` holds the CUDA kernel against."""
from __future__ import annotations

import torch


def gather_pack_ref(pool, idx):
    """pool (R, D); idx (K, T) int (-1 pad) -> (K, T, D) in pool's dtype,
    pad rows zeroed. The reference's oracle multiplies by the pad mask; a
    select gives the same values, but its pad rows are +0.0 whatever the
    pool holds (no -0.0 from a negative row 0), bit for bit what the CUDA
    kernel writes. An empty pool (every row a pad) packs to zeros."""
    if pool.shape[0] == 0:
        return pool.new_zeros((*idx.shape, pool.shape[1]))
    rows = pool[idx.clamp(min=0).long()]
    return torch.where((idx >= 0)[..., None], rows, rows.new_zeros(()))
