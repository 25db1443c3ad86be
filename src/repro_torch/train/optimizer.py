"""AdamW and SGD-momentum, written out by hand over a flat dict of the
parameters under the reference's names (``embed``, ``layers/wq``, ...).

The state is ``{"m": {name: fp32}, "v": {name: fp32}, "step": int32}``
(``SGDM``: no ``v``), on the parameters' device. ``update`` writes the new
parameters and moments into the given tensors in place (as a donated
buffer would be: a second copy of the moments does not fit on the card
beside dlrm-mlperf's 12.3 GB of tables capped at 4M rows) and returns them
with the new state and the global grad norm before clipping, as the
reference returns its new tree; the gradient is clipped one leaf at a
time, with the reference's arithmetic. Three details of the reference are
kept, so that the two packages step alike: the schedule is read at the
step already incremented (the first AdamW update runs at ``lr * min(1, 2 /
warmup_steps)``), the decay is decoupled (``p - lr * (delta + wd * p)`` in
fp32), and the norm is clipped in fp32. ``torch.optim.AdamW`` differs in
both of the first two.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


def named_params(params) -> dict[str, torch.Tensor]:
    """The flat view of ``params`` under the reference's names: a module's
    parameters ("." becomes "/"), or a dict of tensors, nested ones joined
    by "/"."""
    if isinstance(params, nn.Module):
        return {n.replace(".", "/"): p for n, p in params.named_parameters()}
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({f"{k}/{n}": t for n, t in named_params(v).items()})
        else:
            out[k] = v
    return out


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in fp32."""
    return torch.sqrt(sum(l.float().square().sum() for l in tree.values()))


def clip_by_global_norm(tree: dict[str, torch.Tensor], max_norm: float):
    g = global_norm(tree)
    return {k: _clipped(l, g, max_norm).to(l.dtype)
            for k, l in tree.items()}, g


def _clipped(leaf: torch.Tensor, gnorm: torch.Tensor, max_norm: float):
    """One leaf of ``clip_by_global_norm``'s result, in fp32."""
    scale = torch.clamp(max_norm / gnorm.clamp_min(1e-9), max=1.0)
    return (leaf.float() * scale).to(leaf.dtype).float()


def _zeros(params) -> dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named_params(params).items()}


def _zero_shapes(param_shapes) -> dict[str, torch.Tensor]:
    return {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
            for k, p in named_params(param_shapes).items()}


def _step_shape() -> torch.Tensor:
    return torch.empty((), dtype=torch.int32, device="meta")


def _step0(params) -> torch.Tensor:
    dev = next(iter(named_params(params).values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100

    def init(self, params) -> dict:
        return {"m": _zeros(params), "v": _zeros(params),
                "step": _step0(params)}

    def init_shapes(self, param_shapes) -> dict:
        """``init``'s state as empty ``meta`` tensors."""
        return {"m": _zero_shapes(param_shapes),
                "v": _zero_shapes(param_shapes), "step": _step_shape()}

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        warm = torch.clamp((step + 1) / max(1, self.warmup_steps), max=1.0)
        return self.lr * warm

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params):
        named = named_params(params)
        gnorm = global_norm(grads)
        step = state["step"] + 1
        lr = self.schedule(step)
        b1c = 1.0 - self.b1 ** step.float()
        b2c = 1.0 - self.b2 ** step.float()
        for k, p in named.items():
            gf = (_clipped(grads[k], gnorm, self.grad_clip)
                  if self.grad_clip else grads[k].float())
            m = state["m"][k].mul_(self.b1).add_((1 - self.b1) * gf)
            v = state["v"][k].mul_(self.b2).add_((1 - self.b2) * gf * gf)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            pf = p.float()
            p.copy_((pf - lr * (delta + self.weight_decay * pf)).to(p.dtype))
        return params, {"m": state["m"], "v": state["v"], "step": step}, gnorm


@dataclass(frozen=True)
class SGDM:
    lr: float = 1e-2
    momentum: float = 0.9
    grad_clip: float = 0.0

    def init(self, params) -> dict:
        return {"m": _zeros(params), "step": _step0(params)}

    def init_shapes(self, param_shapes) -> dict:
        """``init``'s state as empty ``meta`` tensors."""
        return {"m": _zero_shapes(param_shapes), "step": _step_shape()}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params):
        gnorm = global_norm(grads)
        for k, p in named_params(params).items():
            gf = (_clipped(grads[k], gnorm, self.grad_clip)
                  if self.grad_clip else grads[k].float())
            m = state["m"][k].mul_(self.momentum).add_(gf)
            p.copy_((p.float() - self.lr * m).to(p.dtype))
        return params, {"m": state["m"], "step": state["step"] + 1}, gnorm
