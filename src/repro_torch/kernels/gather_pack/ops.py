"""gather_pack op: the hand-written CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors. Dispatch goes by the tensors' device only;
a CUDA tensor never reaches the plain version."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_pack.ref import gather_pack_ref


def _lib():
    lib = _build.load("gather_pack")
    lib.gather_pack_launch.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.gather_pack_launch.restype = ctypes.c_int
    return lib


def gather_pack(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Padded doc tiles (K, T, D) in ``pool``'s dtype: row ``idx[k, t]`` of
    ``pool`` (R, D), or zeros where ``idx[k, t]`` is -1. ``pool`` holds 1-,
    2- or 4-byte elements (fp16, fp32, int8); ``idx`` is int32 with every
    entry in ``[-1, R)``."""
    if pool.device.type == "cpu":
        return gather_pack_ref(pool, idx)
    if pool.device.type != "cuda":
        raise ValueError(f"gather_pack: unsupported device {pool.device}")
    if idx.device != pool.device:
        raise ValueError(f"gather_pack: idx is on {idx.device}, pool on "
                         f"{pool.device}")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_pack: idx must be int32, not {idx.dtype}")
    if pool.element_size() not in (1, 2, 4) or pool.is_complex():
        raise TypeError(f"gather_pack: pool elements must be 1, 2 or 4 "
                        f"bytes, not {pool.dtype}")
    if pool.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"gather_pack: shapes pool {tuple(pool.shape)}, "
                         f"idx {tuple(idx.shape)}; want (R, D) and (K, T)")
    if not (pool.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_pack: inputs must be contiguous")
    r, d = pool.shape
    k, t = idx.shape
    row_bytes = d * pool.element_size()
    if max(r, k, t, row_bytes) >= 2**31:
        raise ValueError("gather_pack: input too large for 32-bit row ids "
                         "and sizes")
    out = torch.empty(k, t, d, dtype=pool.dtype, device=pool.device)
    if out.numel() == 0:
        return out
    err = _lib().gather_pack_launch(
        pool.data_ptr(), idx.data_ptr(), out.data_ptr(), k, t, row_bytes,
        torch.cuda.current_stream(pool.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_pack kernel launch failed: CUDA error "
                           f"{err}")
    gather_pack.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
gather_pack.launches = 0
