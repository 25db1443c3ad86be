"""Decode-attention op: the hand-written CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors. Dispatch goes by the tensors' device
only; a CUDA tensor never reaches the plain version."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (16, 32, 64, 128)
_BLOCKS_PER_SM = 4      # split the slots until the grid has ~4 blocks an SM
_MIN_SPLIT = 64         # ... but give no block fewer slots than this


def _lib():
    lib = _build.load("flash_decode")
    lib.flash_decode_launch.argtypes = [ctypes.c_void_p] * 8 \
        + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    lib.flash_decode_launch.restype = ctypes.c_int
    return lib


def split_slots(s: int, pairs: int, sms: int) -> tuple[int, int]:
    """(slots per block, number of splits) for a cache of ``s`` slots shared
    by ``pairs`` (b, kv) pairs on a card with ``sms`` SMs."""
    n = max(1, min(-(-_BLOCKS_PER_SM * sms // pairs), -(-s // _MIN_SPLIT)))
    split = -(-s // n)
    split = -(-split // _MIN_SPLIT) * _MIN_SPLIT
    return split, -(-s // split)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention of one new token per sequence, (B, KV, G, Dh) in q's
    dtype.

    q (B, KV, G, Dh); k_cache/v_cache (B, S, KV, Dh), the same dtype as q
    (fp32, bf16 or fp16); lengths (B,) int32, the valid prefix of each
    sequence's cache (see ``ref.py`` for lengths of 0 and above S).
    """
    if k_cache.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, lengths)
    if k_cache.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {k_cache.device}")
    for name, t in (("q", q), ("v_cache", v_cache), ("lengths", lengths)):
        if t.device != k_cache.device:
            raise ValueError(f"flash_decode: {name} is on {t.device}, "
                             f"k_cache on {k_cache.device}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"flash_decode: q, k_cache and v_cache must share "
                        f"one of fp32/bf16/fp16, not {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError("flash_decode: lengths must be int32")
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, k_cache "
                         f"{tuple(k_cache.shape)}, v_cache "
                         f"{tuple(v_cache.shape)} do not agree")
    b, kv, g, dh = q.shape
    s = k_cache.shape[1]
    if k_cache.shape != (b, s, kv, dh) or lengths.shape != (b,):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, k_cache "
                         f"{tuple(k_cache.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not agree")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {dh} not in {_HEAD_DIMS}")
    if s == 0 or b > 65535 or kv * g > 65535:
        raise ValueError(f"flash_decode: unsupported sizes B={b}, S={s}, "
                         f"KV={kv}, G={g}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, lengths)):
        raise ValueError("flash_decode: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("flash_decode: q and the caches must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if b == 0 or kv == 0 or g == 0:
        return out
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    split, n_splits = split_slots(s, b * kv, sms)
    part_m = torch.empty(b, kv, g, n_splits, dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(b, kv, g, n_splits, dh, dtype=torch.float32,
                           device=q.device)
    err = _lib().flash_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        part_acc.data_ptr(), out.data_ptr(), b, s, kv, g, dh, split,
        n_splits, _DTYPES[q.dtype], dh ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    flash_decode.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
flash_decode.launches = 0
