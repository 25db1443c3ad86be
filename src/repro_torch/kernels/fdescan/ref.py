"""Plain PyTorch version of the FDE scan kernel: the CPU path, and the
oracle ``chip_smoke.py`` holds the CUDA kernel against."""
from __future__ import annotations

import torch


def fdescan_ref(q, docs):
    """Batched single-vector scoring: q (B, D) float x docs (N, D) float ->
    (B, N) fp32 inner products (the FDE Chamfer estimate per candidate)."""
    return q.float() @ docs.float().T
