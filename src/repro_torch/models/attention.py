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

import torch
import torch.nn.functional as F

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


def blockwise_attention(q, k, v, *, causal: bool, chunk: int,
                        q_positions=None, kv_positions=None):
    """Flash-style attention: running (m, l, o) in fp32 over KV chunks.

    q: (B, Sq, H, Dh); k/v: (B, Skv, KV, Dh); GQA by head grouping (no
    repeated KV). The last chunk is zero-padded, its pad slots masked, as in
    the reference.

    Under ``no_grad`` (serving) one (B, Sq, KV, G, chunk) fp32 score block
    is live at a time: the scale, mask and exp are written into its
    storage. When autograd records (grad enabled and an input requires
    grad) the same operations run out of place, since the block is saved
    for the backward; each is the same elementwise kernel, so both forms
    give the same bits.
    """
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

    qg = whole_heads(q, 2, kv).reshape(b, sq, kv, group, dh).float()
    qp = q_positions[:, :, None, None, None]
    # the running state is made like qg, so that a DTensor q gives it q's
    # layout (a plain tensor gives the same zeros)
    o = torch.zeros_like(qg)
    m = torch.full_like(o[..., 0], NEG_INF)
    l = torch.zeros_like(o[..., 0])
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        kb, vb, pb = k[:, sl], v[:, sl], kv_positions[:, sl]
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kb.float())
        pb = pb[:, None, None, None, :]
        mask = pb <= qp if causal else pb < INT32_MAX
        if grad:
            s = (s * scale).masked_fill(~mask, NEG_INF)
        else:
            s.mul_(scale).masked_fill_(~mask, NEG_INF)
        del mask
        m_new = torch.maximum(m, s.amax(dim=-1))
        if grad:
            p = (s - m_new[..., None]).exp()
        else:
            p = s.sub_(m_new[..., None]).exp_()         # s's storage
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        # p is rounded to v's dtype for the PV product, as in the reference
        pv = p.to(vb.dtype).float() if vb.dtype != torch.float32 else p
        del s, p
        o = o * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", pv,
                                               vb.float())
        del pv
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]
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
