"""MaxSim late-interaction scoring (paper eq. 1):

    S_{q,d} = sum_i max_j  E_q[i] . E_d[j]^T

Batched plain-PyTorch forms. The rerank path runs the hand-written CUDA
kernel through ``repro_torch.kernels.maxsim.ops.maxsim``.
"""
from __future__ import annotations

import torch

NEG = -1e30


def maxsim_scores(q_bow, q_mask, d_bow, d_mask, score_dtype=torch.float32):
    """Batched MaxSim.

    q_bow: (B, Lq, D) query token vectors; q_mask: (B, Lq) bool
    d_bow: (B, K, Ld, D) candidate doc token vectors; d_mask: (B, K, Ld) bool
    score_dtype: dtype of the (B,K,Lq,Ld) score block (the final sum stays
    fp32). Returns scores (B, K) fp32.
    """
    s = torch.einsum("bqd,bktd->bkqt", q_bow.to(score_dtype),
                     d_bow.to(score_dtype))
    s = torch.where(d_mask[:, :, None, :], s,
                    torch.tensor(NEG, dtype=score_dtype, device=s.device))
    m = s.amax(dim=-1).float()                           # (B, K, Lq)
    m = torch.where(q_mask[:, None, :], m, 0.0)
    m = m.clamp_min(0.0) + m.clamp_max(0.0) * (m > NEG / 2)   # keep finite
    return m.sum(dim=-1)


def maxsim_single(q_bow, d_bow, d_len):
    """Unbatched: q_bow (Lq, D); d_bow (Ld, D); d_len scalar. fp32 score."""
    s = q_bow.float() @ d_bow.float().T                          # (Lq, Ld)
    mask = torch.arange(d_bow.shape[0], device=s.device) < d_len
    s = torch.where(mask[None, :], s, NEG)
    return s.amax(dim=-1).sum()


def aggregate_scores(cls_scores, bow_scores, alpha: float = 1.0):
    """ColBERTer final score: learned mix of candidate-gen (CLS dot) and
    re-rank (BOW MaxSim) scores."""
    return bow_scores + alpha * cls_scores


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last dim, descending, lowest index first among equal
    values (the order ``jax.lax.top_k`` gives; ``torch.topk`` does not
    promise it). Returns (values, indices)."""
    k = min(k, x.shape[-1])
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def rank(scores, k: int):
    """Top-k doc ranking from scores (..., K_cand) -> (values, indices)."""
    return topk_stable(scores, k)
