"""FDE scan op: the hand-written CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors. Dispatch goes by the tensors' device only;
a CUDA tensor never reaches the plain version."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fdescan.ref import fdescan_ref


_LIB = None


def _lib():
    """The kernel's library, its C signatures set once, at load."""
    global _LIB
    if _LIB is None:
        lib = _build.load("fdescan")
        lib.fdescan_launch.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.fdescan_launch.restype = ctypes.c_int
        lib.fdescan_kernel_for.argtypes = [ctypes.c_void_p] * 2 \
            + [ctypes.c_int] * 2
        lib.fdescan_kernel_for.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def kernel_for(q: torch.Tensor, docs: torch.Tensor) -> str:
    """Which of the two CUDA kernels ``fdescan`` launches for these CUDA
    tensors: ``"wgmma"`` (tensor cores: an fp16 table, D a multiple of 8 up
    to 256, 16-byte aligned rows) or ``"simt"`` (every other case). The
    launch makes the same choice, in the same C function."""
    return "wgmma" if _lib().fdescan_kernel_for(
        q.data_ptr(), docs.data_ptr(), q.shape[1],
        int(docs.dtype == torch.float16)) else "simt"


def fdescan(q: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """(B, N) fp32 scores ``q @ docs.T``; q (B, D) fp32, docs (N, D) fp16
    (the resident FDE table) or fp32. Exactly (B, N): no pad columns. On
    the card an fp16 table runs on the tensor cores (``kernel_for``), with
    q in two fp16 parts so that the scores keep fp32 accuracy."""
    if docs.device.type == "cpu":
        return fdescan_ref(q, docs)
    if docs.device.type != "cuda":
        raise ValueError(f"fdescan: unsupported device {docs.device}")
    if q.device != docs.device:
        raise ValueError(f"fdescan: q is on {q.device}, docs on "
                         f"{docs.device}")
    if q.dtype != torch.float32:
        raise TypeError("fdescan: q must be float32")
    if docs.dtype not in (torch.float16, torch.float32):
        raise TypeError(f"fdescan: docs must be float16 or float32, not "
                        f"{docs.dtype}")
    if q.dim() != 2 or docs.dim() != 2 or q.shape[1] != docs.shape[1]:
        raise ValueError(f"fdescan: shapes q {tuple(q.shape)}, docs "
                         f"{tuple(docs.shape)} do not agree")
    if not (q.is_contiguous() and docs.is_contiguous()):
        raise ValueError("fdescan: inputs must be contiguous")
    b, d = q.shape
    n = docs.shape[0]
    if max(b * d, n * d, b * n) >= 2**31:
        raise ValueError("fdescan: input too large for 32-bit sizes")
    out = torch.empty(b, n, dtype=torch.float32, device=q.device)
    if b == 0 or n == 0:
        return out
    err = _lib().fdescan_launch(
        q.data_ptr(), docs.data_ptr(), out.data_ptr(), b, n, d,
        int(docs.dtype == torch.float16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fdescan kernel launch failed: CUDA error {err}")
    fdescan.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
fdescan.launches = 0
