"""Plain PyTorch version of the MaxSim kernel: the CPU path, and the oracle
``chip_smoke.py`` holds the CUDA kernel against."""
from __future__ import annotations

import torch

NEG = -1e30


def maxsim_ref(q, q_mask, docs, doc_lens):
    """q: (Lq, D); q_mask: (Lq,); docs: (K, T, D); doc_lens: (K,) -> (K,) fp32."""
    s = torch.einsum("qd,ktd->kqt", q.float(), docs.float())
    t = docs.shape[1]
    tmask = (torch.arange(t, device=docs.device)[None, None, :]
             < doc_lens.to(docs.device)[:, None, None])
    s = torch.where(tmask, s, torch.tensor(NEG, device=s.device))
    m = s.amax(dim=-1) if t else s.new_full(s.shape[:2], NEG)   # (K, Lq)
    m = m * q_mask.float()[None, :]
    return m.sum(dim=-1)
