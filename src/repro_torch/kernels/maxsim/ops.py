"""MaxSim op: the hand-written CUDA kernels for CUDA tensors, the plain
PyTorch version for CPU tensors. Dispatch goes by the tensors' device only;
a CUDA tensor never reaches the plain version."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.maxsim.ref import maxsim_ref

_SMEM_LIMIT = 227 * 1024       # shared memory a block may use on Hopper
_LIB = None


def _lib():
    """The kernels' library, its C signatures set once, at load."""
    global _LIB
    if _LIB is None:
        lib = _build.load("maxsim")
        lib.maxsim_launch.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.maxsim_launch.restype = ctypes.c_int
        lib.maxsim_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.maxsim_smem_bytes.restype = ctypes.c_size_t
        lib.maxsim_kernel_for.argtypes = [ctypes.c_void_p] + \
            [ctypes.c_int] * 4
        lib.maxsim_kernel_for.restype = ctypes.c_int
        lib.maxsim_mma_docs_per_block.argtypes = [ctypes.c_int]
        lib.maxsim_mma_docs_per_block.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def kernel_for(q: torch.Tensor, docs: torch.Tensor) -> str:
    """Which of the two CUDA kernels ``maxsim`` launches for these CUDA
    tensors: ``"mma"`` (tensor cores: fp16 docs, D of 16, 32 or 64, Lq of
    1 to 32, T up to 1,024, 16-byte aligned docs) or ``"simt"`` (every
    other case). The launch makes the same choice, in the same C function.
    """
    return "mma" if _lib().maxsim_kernel_for(
        docs.data_ptr(), q.shape[1], q.shape[0], docs.shape[1],
        int(docs.dtype == torch.float16)) else "simt"


def mma_docs_per_block(k: int) -> int:
    """Docs a block of the ``mma`` kernel takes for K docs on this card
    (1, 2, 4 or 8, from K and the SM count): each is its own instance of
    the kernel, chosen by the launch in the same C function."""
    return _lib().maxsim_mma_docs_per_block(k)


def maxsim(q: torch.Tensor, q_mask: torch.Tensor, docs: torch.Tensor,
           doc_lens: torch.Tensor) -> torch.Tensor:
    """MaxSim scores (K,) fp32.

    q (Lq, D) fp32, q_mask (Lq,) fp32, docs (K, T, D) fp32 or fp16,
    doc_lens (K,) int32. Tokens at or past ``doc_lens[k]`` never count.
    On the card fp16 docs run on the tensor cores (``kernel_for``), with q
    in two fp16 parts so that the scores keep fp32 accuracy.
    """
    if docs.device.type == "cpu":
        return maxsim_ref(q, q_mask, docs, doc_lens)
    if docs.device.type != "cuda":
        raise ValueError(f"maxsim: unsupported device {docs.device}")
    for name, t in (("q", q), ("q_mask", q_mask), ("doc_lens", doc_lens)):
        if t.device != docs.device:
            raise ValueError(f"maxsim: {name} is on {t.device}, docs on "
                             f"{docs.device}")
    if q.dtype != torch.float32 or q_mask.dtype != torch.float32:
        raise TypeError("maxsim: q and q_mask must be float32")
    if docs.dtype not in (torch.float32, torch.float16):
        raise TypeError(f"maxsim: docs must be float32 or float16, "
                        f"not {docs.dtype}")
    if doc_lens.dtype != torch.int32:
        raise TypeError("maxsim: doc_lens must be int32")
    if q.dim() != 2 or docs.dim() != 3 or q_mask.shape != (q.shape[0],) \
            or doc_lens.shape != (docs.shape[0],) \
            or docs.shape[2] != q.shape[1]:
        raise ValueError(f"maxsim: shapes q {tuple(q.shape)}, q_mask "
                         f"{tuple(q_mask.shape)}, docs {tuple(docs.shape)}, "
                         f"doc_lens {tuple(doc_lens.shape)} do not agree")
    if not all(t.is_contiguous() for t in (q, q_mask, docs, doc_lens)):
        raise ValueError("maxsim: inputs must be contiguous")
    lq, d = q.shape
    k, t, _ = docs.shape
    if max(k, t * d, lq * d) >= 2**31:
        raise ValueError("maxsim: input too large for 32-bit sizes")
    lib = _lib()
    if kernel_for(q, docs) == "simt" \
            and lib.maxsim_smem_bytes(d, lq) > _SMEM_LIMIT:
        raise ValueError(f"maxsim: Lq={lq}, D={d} needs more shared memory "
                         "than a block has")
    out = torch.empty(k, dtype=torch.float32, device=docs.device)
    if k == 0:
        return out
    err = lib.maxsim_launch(
        q.data_ptr(), q_mask.data_ptr(), docs.data_ptr(), doc_lens.data_ptr(),
        out.data_ptr(), k, t, d, lq, int(docs.dtype == torch.float16),
        torch.cuda.current_stream(docs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"maxsim kernel launch failed: CUDA error {err}")
    maxsim.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
maxsim.launches = 0
