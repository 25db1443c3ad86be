"""Shared layers of the models: initializers, RMSNorm and LayerNorm, the
SwiGLU and GELU MLPs, the plain ReLU MLP stack, the token cross-entropy;
and the shardings the dry run lays DTensors out by, with the helpers that
keep its DTensors in the reference's layouts (plain tensors pass through).

Parameters are fp32 masters; compute casts them to the activation dtype
(bf16 by default), with the rounding points of the reference's layers.
"""
from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import Any

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


@dataclass(frozen=True)
class Sharding:
    """A mesh and the placements of a tensor on it: the counterpart of
    ``NamedSharding``."""
    mesh: Any
    placements: tuple


def placements_of(spec: tuple, mesh) -> tuple:
    """A spec -> one DTensor placement per mesh dim.

    A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
    tensor dim, ``None`` (replicated), a mesh axis name, or a tuple of
    names (the dim sharded over several mesh axes, major first). DTensor's
    placements go the other way, one per mesh dim: ``Shard(tensor dim)``
    or ``Replicate()``. A tensor dim over several mesh dims is split by
    them in mesh order, so a tuple must name its axes in the mesh's order
    (every rule of ``launch/mesh.mesh_axes`` does); another order raises
    rather than lay the tensor out differently. The placements are always
    spelled out: no ``torch.distributed`` API picks a layout here."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 "shards two dims")
            out[i] = Shard(dim)
    return tuple(out)


def constrain(x, spec):
    """The reference's ``with_sharding_constraint``: a DTensor is
    redistributed to ``spec`` (see ``placements_of``) on its own mesh; a
    plain tensor, a spec of None, or a DTensor on a mesh of one device
    (where every layout is the same) passes through untouched."""
    if spec is None or not is_dtensor(x) or x.device_mesh.size() == 1:
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    placements = list(placements_of(spec, mesh))
    for d in range(x.dim()):
        # a dim split unevenly over several mesh dims keeps the major ones
        # that divide it (DTensor's views mis-size such a split; GSPMD pads)
        on = [i for i, p in enumerate(placements) if p.is_shard(d)]
        while len(on) > 1 and x.shape[d] % math.prod(
                mesh.size(i) for i in on):
            placements[on.pop()] = Replicate()
    return x.redistribute(mesh, placements)


def whole_heads(x, dim: int, n: int):
    """Before ``x``'s dim ``dim`` is split into (n, rest): a DTensor whose
    dim is sharded over mesh dims that do not divide ``n`` (its shards
    would cut across heads, which DTensor cannot split; GSPMD pads) is
    gathered on those mesh dims. Anything else passes through."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.dim()
    sharded = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    shards = math.prod(x.device_mesh.size(i) for i in sharded)
    if n % shards == 0:
        return x
    placements = [Replicate() if i in sharded else p
                  for i, p in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, placements)


def embed_rows(table, ids):
    """``table[ids]``. A DTensor is looked up shard by shard
    (``sharded_rows``): DTensor's own rules take no dim sharded over
    several mesh dims, and gather a table sharded by rows."""
    if is_dtensor(ids) or is_dtensor(table):
        return sharded_rows(table, ids)
    return table[ids]


def sharded_rows(table, ids):
    """``table[ids]`` for a DTensor table (or ids), as GSPMD takes it: the
    ids made whole over the mesh dims that shard the table's rows, each
    shard looks up the ids that fall in its rows (zeros elsewhere), and the
    partial rows are summed onto the ids' layout; a whole table is one
    local lookup in the ids' layout, and a table sharded by columns gives
    rows sharded so. Differentiable: a shard's gradient lands in its own
    rows. (DTensor's own lookup rules take no dim sharded over several
    mesh dims, and would gather the table.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = (table if is_dtensor(table) else ids).device_mesh
    whole_on_all = [Replicate()] * mesh.ndim
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, whole_on_all, run_check=False)
    if not is_dtensor(table):
        table = DTensor.from_local(table, mesh, whole_on_all, run_check=False)
    rows_on = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    cols_on = [i for i, p in enumerate(table.placements) if p.is_shard(1)]
    whole = ids.redistribute(mesh, [
        Replicate() if i in rows_on or i in cols_on else p
        for i, p in enumerate(ids.placements)])
    local, shard = whole.to_local(), table.to_local()
    if rows_on:
        start, n = _local_range(table.shape[0], table.placements, 0, mesh)
        inside = (local >= start) & (local < start + n)
        got = F.embedding((local - start).clamp(0, max(n - 1, 0)),
                          shard) * inside[..., None]
    else:
        got = F.embedding(local, shard)
    placements = [Partial() if i in rows_on else
                  Shard(ids.dim()) if i in cols_on else p
                  for i, p in enumerate(whole.placements)]
    shape = tuple(ids.shape) + (table.shape[1],)
    out = DTensor.from_local(got, mesh, placements, run_check=False,
                             shape=shape, stride=_contiguous(shape))
    return _laid_out_as_ids(out, ids)


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def _local_range(length: int, placements, dim: int,
                 mesh) -> tuple[int, int]:
    """(first index, count) of this rank's part of a dim of ``length``
    split by ``placements``: ``torch.chunk``'s split, mesh dims major
    first."""
    coord, start = mesh.get_coordinate(), 0
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            step = -(-length // mesh.size(i))
            first = min(coord[i] * step, length)
            start, length = start + first, min(step, length - first)
    return start, length


def _laid_out_as_ids(rows, ids):
    """A DTensor lookup's rows (masked partial sums where the table is
    sharded by rows) reduced at once onto the ids' own layout: sharded
    where the ids are, whole elsewhere. Reduced later, two lookups of one
    layout would share DTensor's mask buffer."""
    if not is_dtensor(rows) or not is_dtensor(ids):
        return rows
    from torch.distributed.tensor import Replicate
    placements = [p if p.is_shard() else Replicate() for p in ids.placements]
    return rows.redistribute(rows.device_mesh, placements)


def write_slot(cache, dim: int, pos: int, value) -> None:
    """``cache.select(dim, pos).copy_(value)``. A DTensor cache sharded
    along ``dim`` is written by the shard that holds slot ``pos`` alone, on
    its local tensor (DTensor would gather the cache to select a slot of a
    sharded dim); ``value`` is first laid out as the slot is."""
    if not is_dtensor(cache) or not any(p.is_shard(dim)
                                        for p in cache.placements):
        cache.select(dim, pos).copy_(value)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    slot = [Replicate() if p.is_shard(dim) else
            Shard(p.dim - (p.dim > dim)) if p.is_shard() else p
            for p in cache.placements]
    value = value.redistribute(mesh, slot).to_local()
    start, length = _local_range(cache.shape[dim], cache.placements, dim,
                                 mesh)
    if start <= pos < start + length:
        cache.to_local().select(dim, pos - start).copy_(value)


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


def _logsumexp(x):
    """logsumexp over the last dim as the reference's ``jax.nn.logsumexp``
    takes it: the max held constant, log of the sum of exp(x - max), plus
    the max (its gradient exp(x - max) / sum). A DTensor (sharded over the
    vocab) reduces the max and the sum across its shards as partial values,
    where DTensor's own logsumexp would gather the whole dim; plain tensors
    run the same operations, so the dry run counts what a device runs."""
    m = _reduced(x.amax(dim=-1, keepdim=True).detach())
    return _reduced((x - m).exp().sum(dim=-1)).log() + m[..., 0]


def _reduced(x):
    """A DTensor's partial values reduced in full (all-reduced), its other
    placements kept: DTensor would otherwise reduce-scatter them onto some
    dim, a layout the gradient coming back then has to undo. A plain tensor
    passes through."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    placements = [Replicate() if p.is_partial() else p for p in x.placements]
    return x.redistribute(x.device_mesh, placements)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (none can exist before
    ``torch.distributed.tensor`` is imported: the port never imports it
    for plain tensors)."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    return dtensor is not None and isinstance(x, dtensor.DTensor)


class _Gold(torch.autograd.Function):
    """``x.gather(-1, idx)``, one index per row, whose backward puts the
    gradient at the index by comparison with the vocab's positions (the
    values of gather's zeros-and-scatter backward, made elementwise, so
    that a vocab-sharded DTensor is not gathered whole to make its zeros;
    a plain tensor takes the same operations)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[-1]
        return x.gather(-1, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        pos = torch.arange(ctx.n, device=idx.device)
        return torch.where(pos == idx, g, 0.0), None


def cross_entropy_logits(logits, targets, z_loss: float = 0.0):
    """Token CE with an fp32 logsumexp; logits (..., V) any float dtype,
    targets (...) int."""
    lf = logits.float()
    lse = _logsumexp(lf)
    idx = targets[..., None].long()
    gold = _Gold.apply(lf, idx)
    # subtracted before the trailing dim goes: a DTensor gathered from
    # vocab shards reduces its (..., 1) masked partial sums here
    loss = (lse[..., None] - gold)[..., 0]
    if z_loss:
        loss = loss + z_loss * lse ** 2
    return loss
