"""Plain PyTorch version of the packed-bit MaxSim kernel: the CPU path, and
the oracle ``chip_smoke.py`` holds the CUDA kernel against."""
from __future__ import annotations

import torch

NEG = -1e30


def unpack_bits(packed: torch.Tensor, d: int) -> torch.Tensor:
    """(..., W) 32-bit lanes (int32 or uint32) -> (..., d) fp32 in {-1, +1}:
    bit i of lane w is dim 32w + i (little-endian, matching
    ``core.quantize.binary_pack``)."""
    lanes = packed.view(torch.int32) if packed.dtype == torch.uint32 \
        else packed
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (lanes[..., None] >> shifts) & 1       # arithmetic shift, masked
    flat = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 32)[..., :d]
    return flat.float() * 2.0 - 1.0


def bitsim_ref(q, q_mask, docs_packed, doc_lens):
    """Asymmetric MaxSim: full-precision query tokens against sign-binarized
    document tokens.

    q: (Lq, D) float; q_mask: (Lq,); docs_packed: (K, T, W) 32-bit lanes
    with 32 * W >= D; doc_lens: (K,) -> (K,) fp32 scores.
    """
    d = q.shape[1]
    sgn = unpack_bits(docs_packed, d)                # (K, T, D) in {-1,+1}
    s = torch.einsum("qd,ktd->kqt", q.float(), sgn)
    t = docs_packed.shape[1]
    tmask = (torch.arange(t, device=s.device)[None, None, :]
             < doc_lens.to(s.device)[:, None, None])
    s = torch.where(tmask, s, torch.tensor(NEG, device=s.device))
    m = s.amax(dim=-1) if t else s.new_full(s.shape[:2], NEG)   # (K, Lq)
    m = m * q_mask.float()[None, :]
    return m.sum(dim=-1)
