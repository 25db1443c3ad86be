"""Plain PyTorch version of the flash_decode kernel: the CPU path, and the
oracle ``chip_smoke.py`` holds the CUDA kernel against.

Everything runs in fp32 and the output is cast to q's dtype. Slots at or
past ``lengths[b]`` score -1e30, so a length of 0 (or less) weights all S
slots equally (the mean of v over the cache) and a length above S counts
as S.
"""
from __future__ import annotations

import torch

NEG = -1e30


def flash_decode_ref(q, k_cache, v_cache, lengths):
    """q: (B, KV, G, Dh); k/v: (B, S, KV, Dh); lengths (B,) -> (B, KV, G, Dh)."""
    dh = q.shape[-1]
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k_cache.float()) \
        * dh ** -0.5
    slots = torch.arange(k_cache.shape[1], device=k_cache.device)
    valid = (slots[None, :] < lengths.to(k_cache.device)[:, None])
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(NEG, device=s.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p / l.clamp_min(1e-30),
                     v_cache.float())
    return o.to(q.dtype)
