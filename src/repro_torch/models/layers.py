"""Shared layers of the models: initializers, RMSNorm and LayerNorm, the
SwiGLU and GELU MLPs, the plain ReLU MLP stack, the token cross-entropy.

Parameters are fp32 masters; compute casts them to the activation dtype
(bf16 by default), with the rounding points of the reference's layers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(generator: torch.Generator, shape, in_axis=-2,
               dtype=torch.float32) -> torch.Tensor:
    """LeCun-normal fan-in init, drawn on ``generator``'s device."""
    std = 1.0 / math.sqrt(shape[in_axis])
    return (torch.randn(shape, generator=generator,
                        device=generator.device) * std).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32,
               scale=0.02) -> torch.Tensor:
    return (torch.randn(shape, generator=generator,
                        device=generator.device) * scale).to(dtype)


def split_rngs(generator: torch.Generator, names) -> dict:
    """One generator per name, on ``generator``'s device, each seeded by a
    draw from ``generator``."""
    seeds = torch.randint(0, 2**62, (len(names),), generator=generator,
                          device=generator.device).tolist()
    return {n: torch.Generator(device=generator.device).manual_seed(s)
            for n, s in zip(names, seeds)}


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """Only the variance reduction runs in fp32: ``inv`` is cast to x's
    dtype and both products stay in it, as in the reference (this decides
    bf16 parity)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (x * inv) * scale.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12):
    """LayerNorm in fp32 (population variance), cast back to x's dtype, as
    in the reference; not ``F.layer_norm`` in the compute dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    d = xf - mu
    var = d.square().mean(dim=-1, keepdim=True)
    y = d * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def gelu_mlp(x, w1, b1, w2, b2):
    """The encoder's FFN: tanh-approximate GELU (the reference's
    ``jax.nn.gelu(approximate=True)``, not torch's default erf form);
    weights and biases already in the compute dtype."""
    h = F.gelu(x @ w1 + b1, approximate="tanh")
    return h @ w2 + b2


def swiglu_mlp(x, w_gate, w_up, w_down):
    """LLaMA-style gated MLP. x: (..., D); weights already in compute dtype."""
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def mlp_stack(x, weights, act=F.relu, act_last=False):
    """Plain MLP from [(w, b), ...]: weights cast to x's dtype, ``act``
    between layers (and after the last with ``act_last``)."""
    for i, (w, b) in enumerate(weights):
        x = x @ w.to(x.dtype) + b.to(x.dtype)
        if act_last or i < len(weights) - 1:
            x = act(x)
    return x


def mlp_params(generator: torch.Generator, dims, dtype=torch.float32
               ) -> dict:
    """An MLP dims[0] -> dims[1] -> ...: {'w0', 'b0', ...}, LeCun-normal
    weights and zero biases on ``generator``'s device."""
    out = {}
    for i in range(len(dims) - 1):
        out[f"w{i}"] = dense_init(generator, (dims[i], dims[i + 1]),
                                  dtype=dtype)
        out[f"b{i}"] = torch.zeros((dims[i + 1],), dtype=dtype,
                                   device=generator.device)
    return out


def mlp_shapes(dims, dtype=torch.float32) -> dict:
    """``mlp_params``' tensors as empty ``meta`` tensors."""
    out = {}
    for i in range(len(dims) - 1):
        out[f"w{i}"] = torch.empty((dims[i], dims[i + 1]), dtype=dtype,
                                   device="meta")
        out[f"b{i}"] = torch.empty((dims[i + 1],), dtype=dtype,
                                   device="meta")
    return out


def mlp_apply(params: dict, x, act=F.relu, act_last=False):
    n = len(params) // 2
    return mlp_stack(x, [(params[f"w{i}"], params[f"b{i}"])
                         for i in range(n)], act=act, act_last=act_last)


def cross_entropy_logits(logits, targets, z_loss: float = 0.0):
    """Token CE with an fp32 logsumexp; logits (..., V) any float dtype,
    targets (...) int."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, targets[..., None].long())[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * lse ** 2
    return loss
