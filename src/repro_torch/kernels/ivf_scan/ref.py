"""Plain PyTorch version of the centroid-scoring kernel: the CPU path, and
the oracle ``chip_smoke.py`` holds the CUDA kernel against."""
from __future__ import annotations

import torch


def ivf_scan_ref(q, centroids):
    """q (B, D), centroids (N, D) -> (B, N) fp32 inner products."""
    return torch.einsum("bd,nd->bn", q.float(), centroids.float())
