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
_BLOCKS_PER_SM = 2      # the kernel fits two blocks on an SM: one wave
_MIN_SPLIT = 64         # no block gets fewer slots than this
_SPLIT_ALIGN = 16       # a split is a whole number of 16-slot steps

_LIB = None
_SMS: dict[int, int] = {}
_COUNTERS: dict[int, torch.Tensor] = {}


def _lib():
    """The kernel's library, its C signature set once, at load."""
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_decode")
        lib.flash_decode_launch.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        lib.flash_decode_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _sms(device: torch.device) -> int:
    """The card's SM count, looked up once a device."""
    idx = _index(device)
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The kernel's per-(b, head tile) arrival counters: int32 zeros, made
    once a device (and again only to grow); each launch leaves them zero.
    Calls that share them run on one stream."""
    idx = _index(device)
    buf = _COUNTERS.get(idx)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[idx] = buf
    return buf


def split_slots(s: int, groups: int, sms: int) -> tuple[int, int]:
    """(slots per block, number of splits) for a cache of ``s`` slots read
    by ``groups`` blocks a split (one per sequence and head tile) on a card
    with ``sms`` SMs: enough splits for ``_BLOCKS_PER_SM`` blocks an SM, no
    split under ``_MIN_SPLIT`` slots, each a multiple of ``_SPLIT_ALIGN``."""
    n = max(1, min(-(-_BLOCKS_PER_SM * sms // groups), -(-s // _MIN_SPLIT)))
    split = -(-s // n)
    split = -(-split // _SPLIT_ALIGN) * _SPLIT_ALIGN
    return split, -(-s // split)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention of one new token per sequence, (B, KV, G, Dh) in q's
    dtype.

    q (B, KV, G, Dh); k_cache/v_cache (B, S, KV, Dh), the same dtype as q
    (fp32, bf16 or fp16); lengths (B,) int32, the valid prefix of each
    sequence's cache (see ``ref.py`` for lengths of 0 and above S). On the
    card one call is one kernel launch, its splits combined in a fixed
    order (the same bits on every call); calls that share a device share
    its arrival counters, so they run on one stream.
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
    split, n_splits = split_slots(s, b, _sms(q.device))
    part = torch.empty(b, kv, g, n_splits, dh + 4, dtype=torch.float32,
                       device=q.device)
    err = _lib().flash_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), part.data_ptr(),
        _counters(q.device, b * kv * g).data_ptr(), out.data_ptr(), b, s, kv,
        g, dh, split, n_splits, _DTYPES[q.dtype], dh ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    flash_decode.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
flash_decode.launches = 0
