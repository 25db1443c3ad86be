"""GQA attention: RoPE, blockwise online-softmax attention for prefill, and
the plain single-token decode attention over a KV cache.

Wherever the reference asks for fp32 products of bf16 inputs
(``preferred_element_type=float32``), both operands are widened to fp32
first: widening is exact, and a bf16 ``torch.matmul`` would round its output
to bf16, which is another function. The decode step of the model does not
call ``decode_attention``: it goes to ``kernels/flash_decode`` (see
``models/transformer.py``); ``decode_attention`` stays as its oracle.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import whole_heads

NEG_INF = -1e30
INT32_MAX = 2**31 - 1


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, Dh); positions: (B, S) int. Computed in fp32, cast back."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (Dh/2,)
    ang = positions[..., None].float() * freqs                  # (B, S, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _chunk_step(qg, qp, kb, vb, pb, m, l, o, *, causal: bool, scale: float,
                score_dtype, inplace: bool):
    """One kv chunk of the online softmax: the running (m, l, o) in fp32
    (B, Sq, KV, G[, Dh]) and the chunk kb/vb (B, C, KV, Dh), its positions
    pb (B?, C) -> the new (m, l, o).

    ``inplace`` (serving, under ``no_grad``): one (B, Sq, KV, G, C) fp32
    score block is live; the scale, mask and exp are written into its
    storage. Otherwise the same operations run out of place (each is the
    same elementwise kernel, so both forms give the same bits).
    ``score_dtype`` rounds the masked score block and the probability block
    as the reference does; m and l stay fp32."""
    s = torch.einsum("bqkgd,bckd->bqkgc", qg, kb.float())
    pb = pb[:, None, None, None, :]
    mask = pb <= qp if causal else pb < INT32_MAX
    if inplace:
        s.mul_(scale).masked_fill_(~mask, NEG_INF)
    else:
        s = (s * scale).masked_fill(~mask, NEG_INF)
    del mask
    s = s.to(score_dtype)
    m_new = torch.maximum(m, s.amax(dim=-1).float())
    shift = m_new[..., None].to(score_dtype)
    p = s.sub_(shift).exp_() if inplace else (s - shift).exp()
    del s, shift
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1).float()
    # p is rounded to v's dtype for the PV product, as in the reference
    pv = p.to(vb.dtype).float()
    del p
    o = o * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", pv,
                                           vb.float())
    return m_new, l, o


def blockwise_attention(q, k, v, *, causal: bool, chunk: int,
                        q_positions=None, kv_positions=None,
                        unroll: bool = False, causal_skip: bool = False,
                        score_dtype=torch.float32):
    """Flash-style attention: running (m, l, o) in fp32 over KV chunks.

    q: (B, Sq, H, Dh); k/v: (B, Skv, KV, Dh); GQA by head grouping (no
    repeated KV). The last chunk is zero-padded, its pad slots masked, as in
    the reference.

    unroll: no effect (the reference's Python loop in place of
    ``lax.scan``; this loop is a Python loop either way).
    causal_skip: also chunk the query axis (causal, Sq = Skv) and visit
    only the kv chunks at or below each query chunk's diagonal.
    score_dtype: dtype of the score and probability blocks (m and l stay
    fp32).

    Under ``no_grad`` (serving) one (B, Sq, KV, G, chunk) fp32 score block
    is live at a time, written in place. When autograd records (grad
    enabled and an input requires grad) each chunk's step runs out of place
    under ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint
    (step)``: the backward keeps each chunk's inputs and running state and
    recomputes its score and probability blocks.
    """
    del unroll
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    group = h // kv
    scale = dh ** -0.5
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(sq, dtype=torch.int32, device=dev)[None]
    if kv_positions is None:
        kv_positions = torch.arange(skv, dtype=torch.int32, device=dev)[None]

    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=INT32_MAX)
    step = partial(_chunk_step, causal=causal, scale=scale,
                   score_dtype=score_dtype, inplace=not grad)

    def run_q_block(qg, qp, n_kv):
        """kv chunks [0, n_kv) for the query block qg (B, Sq', KV, G, Dh)."""
        qp = qp[:, :, None, None, None]
        # the running state is made like qg, so that a DTensor q gives it
        # q's layout (a plain tensor gives the same zeros)
        o = torch.zeros_like(qg)
        m = torch.full_like(o[..., 0], NEG_INF)
        l = torch.zeros_like(o[..., 0])
        for i in range(n_kv):
            sl = slice(i * chunk, (i + 1) * chunk)
            inp = (qg, qp, k[:, sl], v[:, sl], kv_positions[:, sl], m, l, o)
            m, l, o = (checkpoint(step, *inp, use_reentrant=False,
                                  preserve_rng_state=False)
                       if grad else step(*inp))
        return o / l.clamp_min(1e-30)[..., None]

    qg = whole_heads(q, 2, kv).reshape(b, sq, kv, group, dh).float()
    if not (causal_skip and causal and sq == skv and n_chunks > 1):
        out = run_q_block(qg, q_positions, n_chunks)
    else:
        out = torch.cat([run_q_block(qg[:, i * chunk:(i + 1) * chunk],
                                     q_positions[:, i * chunk:(i + 1) * chunk],
                                     i + 1)
                         for i in range(n_chunks)], dim=1)
    return out.reshape(b, sq, h, dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_len_positions):
    """Single-token decode over a KV cache, masked per slot: the plain
    oracle of the model's decode attention.

    q: (B, 1, H, Dh); k_cache/v_cache: (B, S, KV, Dh); kv_len_positions:
    (B, S) int32 position of each cache slot, invalid slots >= INT32_MAX.
    """
    b, _, h, dh = q.shape
    kv = k_cache.shape[2]
    qg = q.reshape(b, kv, h // kv, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) \
        * dh ** -0.5
    valid = (kv_len_positions < INT32_MAX)[:, None, None, :]
    s = torch.where(valid, s, torch.tensor(NEG_INF, device=s.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd",
                     (p / l.clamp_min(1e-30)).to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(b, 1, h, dh).to(q.dtype)


def reference_attention(q, k, v, *, causal: bool):
    """Naive attention (tests): repeated KV heads, a full fp32 softmax."""
    b, sq, h, dh = q.shape
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2).float()
    v = v.repeat_interleave(rep, dim=2).float()
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k) * dh ** -0.5
    if causal:
        mask = torch.ones(sq, k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask[None, None], s,
                        torch.tensor(NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p, v).to(q.dtype)
