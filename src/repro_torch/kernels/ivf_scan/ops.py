"""Centroid-scoring op: the hand-written CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors. Dispatch goes by the tensors' device
only; a CUDA tensor never reaches the plain version."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ivf_scan.ref import ivf_scan_ref


_LIB = None


def _lib():
    """The kernel's library, its C signature set once, at load."""
    global _LIB
    if _LIB is None:
        lib = _build.load("ivf_scan")
        lib.ivf_scan_launch.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.ivf_scan_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def centroid_scores(q: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(B, N) fp32 scores ``q @ centroids.T``; q (B, D), centroids (N, D)
    fp32. Exactly (B, N): no pad columns. On the card the products run on
    the TF32 tensor cores with each operand in two TF32 parts ("3xTF32"),
    so that the scores keep fp32 accuracy."""
    if centroids.device.type == "cpu":
        return ivf_scan_ref(q, centroids)
    if centroids.device.type != "cuda":
        raise ValueError(f"centroid_scores: unsupported device "
                         f"{centroids.device}")
    if q.device != centroids.device:
        raise ValueError(f"centroid_scores: q is on {q.device}, centroids "
                         f"on {centroids.device}")
    if q.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise TypeError("centroid_scores: q and centroids must be float32")
    if q.dim() != 2 or centroids.dim() != 2 \
            or q.shape[1] != centroids.shape[1]:
        raise ValueError(f"centroid_scores: shapes q {tuple(q.shape)}, "
                         f"centroids {tuple(centroids.shape)} do not agree")
    if not (q.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("centroid_scores: inputs must be contiguous")
    b, d = q.shape
    n = centroids.shape[0]
    if max(b * d, n * d, b * n) >= 2**31:
        raise ValueError("centroid_scores: input too large for 32-bit sizes")
    out = torch.empty(b, n, dtype=torch.float32, device=q.device)
    if b == 0 or n == 0:
        return out
    err = _lib().ivf_scan_launch(
        q.data_ptr(), centroids.data_ptr(), out.data_ptr(), b, n, d,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_scan kernel launch failed: CUDA error {err}")
    centroid_scores.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
centroid_scores.launches = 0
