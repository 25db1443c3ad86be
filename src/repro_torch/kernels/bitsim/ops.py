"""Packed-bit MaxSim op: the hand-written CUDA kernels for CUDA tensors, the
plain PyTorch version for CPU tensors. Dispatch goes by the tensors' device
only; a CUDA tensor never reaches the plain version."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitsim.ref import bitsim_ref

_SMEM_LIMIT = 227 * 1024       # shared memory a block may use on Hopper
_LIB = None


def _lib():
    """The kernels' library, its C signatures set once, at load."""
    global _LIB
    if _LIB is None:
        lib = _build.load("bitsim")
        lib.bitsim_launch.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.bitsim_launch.restype = ctypes.c_int
        lib.bitsim_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.bitsim_smem_bytes.restype = ctypes.c_size_t
        lib.bitsim_kernel_for.argtypes = [ctypes.c_int] * 3
        lib.bitsim_kernel_for.restype = ctypes.c_int
        lib.bitsim_mma_docs_per_block.argtypes = [ctypes.c_int]
        lib.bitsim_mma_docs_per_block.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def kernel_for(q: torch.Tensor, docs_packed: torch.Tensor) -> str:
    """Which of the two CUDA kernels ``bitsim`` launches for these CUDA
    tensors: ``"mma"`` (tensor cores: Lq of 1 to 32, D up to 64, T up to
    1,024) or ``"simt"`` (every other case). The launch makes the same
    choice, in the same C function."""
    return "mma" if _lib().bitsim_kernel_for(
        q.shape[1], q.shape[0], docs_packed.shape[1]) else "simt"


def mma_docs_per_block(k: int) -> int:
    """Docs (one warp each) a block of the ``mma`` kernel takes for K docs
    on this card (1, 2, 4 or 8, from K and the SM count), as the launch
    chooses it in the same C function."""
    return _lib().bitsim_mma_docs_per_block(k)


def bitsim(q: torch.Tensor, q_mask: torch.Tensor, docs_packed: torch.Tensor,
           doc_lens: torch.Tensor) -> torch.Tensor:
    """Asymmetric MaxSim scores (K,) fp32 of fp32 query tokens against
    sign-packed document tokens.

    q (Lq, D) fp32, q_mask (Lq,) fp32, docs_packed (K, T, W) int32 or
    uint32 lanes with 32 * W >= D (bit i of lane w is dim 32w + i),
    doc_lens (K,) int32. Tokens at or past ``doc_lens[k]`` never count.
    On the card the bit filter's shapes run on the tensor cores
    (``kernel_for``), with q in two fp16 parts so that the scores keep
    fp32 accuracy.
    """
    if docs_packed.device.type == "cpu":
        return bitsim_ref(q, q_mask, docs_packed, doc_lens)
    if docs_packed.device.type != "cuda":
        raise ValueError(f"bitsim: unsupported device {docs_packed.device}")
    for name, t in (("q", q), ("q_mask", q_mask), ("doc_lens", doc_lens)):
        if t.device != docs_packed.device:
            raise ValueError(f"bitsim: {name} is on {t.device}, docs_packed "
                             f"on {docs_packed.device}")
    if q.dtype != torch.float32 or q_mask.dtype != torch.float32:
        raise TypeError("bitsim: q and q_mask must be float32")
    if docs_packed.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"bitsim: docs_packed must be 32-bit lanes (int32 "
                        f"or uint32), not {docs_packed.dtype}")
    if doc_lens.dtype != torch.int32:
        raise TypeError("bitsim: doc_lens must be int32")
    if q.dim() != 2 or docs_packed.dim() != 3 \
            or q_mask.shape != (q.shape[0],) \
            or doc_lens.shape != (docs_packed.shape[0],) \
            or 32 * docs_packed.shape[2] < q.shape[1]:
        raise ValueError(f"bitsim: shapes q {tuple(q.shape)}, q_mask "
                         f"{tuple(q_mask.shape)}, docs_packed "
                         f"{tuple(docs_packed.shape)}, doc_lens "
                         f"{tuple(doc_lens.shape)} do not agree")
    if not all(t.is_contiguous() for t in (q, q_mask, docs_packed, doc_lens)):
        raise ValueError("bitsim: inputs must be contiguous")
    lq, d = q.shape
    k, t, w = docs_packed.shape
    if max(k, t * w, lq * d) >= 2**31:
        raise ValueError("bitsim: input too large for 32-bit sizes")
    lib = _lib()
    if kernel_for(q, docs_packed) == "simt" \
            and lib.bitsim_smem_bytes(d, lq) > _SMEM_LIMIT:
        raise ValueError(f"bitsim: Lq={lq}, D={d} needs more shared memory "
                         "than a block has")
    out = torch.empty(k, dtype=torch.float32, device=docs_packed.device)
    if k == 0:
        return out
    err = lib.bitsim_launch(
        q.data_ptr(), q_mask.data_ptr(), docs_packed.data_ptr(),
        doc_lens.data_ptr(), out.data_ptr(), k, t, w, d, lq,
        torch.cuda.current_stream(docs_packed.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bitsim kernel launch failed: CUDA error {err}")
    bitsim.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
bitsim.launches = 0
