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
    """``table[ids]`` for a DTensor table (or ids): ``sharded_lookups`` of
    the one pair."""
    return sharded_lookups([(table, ids)])[0]


def sharded_lookups(pairs) -> list:
    """``table[ids]`` for each (table, ids) of ``pairs`` (a DTensor table,
    or ids), laid out as GSPMD partitions the reference's ``jnp.take``.
    XLA's gather partitioner takes, lookup by lookup, the way whose new
    tensors hold the fewest bytes (``_gather_table_first``):

    - the table sliced where it lies: the ids made whole over the mesh dims
      that shard the table's rows, each shard looks up the ids that fall in
      its rows (zeros elsewhere), one all-reduce sums the whole partial rows
      over those dims, and each device keeps its ids' part;
    - the table gathered over the mesh dims that shard both its rows and
      the ids, each device looking up its own ids; over the dims that shard
      the rows alone, sliced where it lies as above (the shards first
      permuted so that the gather leaves each device a contiguous block of
      rows: GSPMD's collective-permute before its all-gather).

    A whole table is one local lookup in the ids' layout, and a table
    sharded by columns gives rows sharded so. The lookups go stage by stage
    together (every table's gathers and partial rows, then every
    all-reduce, then each device's part), so that what GSPMD's combined
    collectives hold at once is live at once here too. Differentiable: a
    shard's gradient lands in its own rows. (DTensor's own lookup rules
    take no dim sharded over several mesh dims, and would gather the
    table.)"""
    runs = [_lookup(table, ids) for table, ids in pairs]
    out: list = [None] * len(runs)
    waves = [list(range(len(runs)))]
    if any(_mesh_of(t, i).size() == 1 for t, i in pairs):
        waves = [[k] for k in range(len(runs))]     # one device: in turn
    for live in waves:
        while live:
            for k in live:
                try:
                    next(runs[k])
                except StopIteration as done:
                    out[k], runs[k] = done.value, None
            live = [k for k in live if runs[k] is not None]
    return out


def _mesh_of(table, ids):
    return (table if is_dtensor(table) else ids).device_mesh


def _lookup(table, ids):
    """One lookup of ``sharded_lookups``, a generator that yields between
    its stages and returns the rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = _mesh_of(table, ids)
    whole_on_all = [Replicate()] * mesh.ndim
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, whole_on_all, run_check=False)
    if not is_dtensor(table):
        table = DTensor.from_local(table, mesh, whole_on_all, run_check=False)
    rows_on = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    cols_on = [i for i, p in enumerate(table.placements) if p.is_shard(1)]
    both = ([i for i in rows_on if ids.placements[i].is_shard()]
            if rows_on and _gather_table_first(table, ids, rows_on) else [])
    sliced = [i for i in rows_on if i not in both]
    mine = ids.redistribute(mesh, [
        Replicate() if i in sliced or i in cols_on else p
        for i, p in enumerate(ids.placements)])
    local = mine.to_local()
    if both and not sliced:
        gathered = table.redistribute(mesh, [
            Replicate() if i in both else p
            for i, p in enumerate(table.placements)])
        yield
        got = F.embedding(local, gathered.to_local(grad_placements=[
            Partial() if i in both else p
            for i, p in enumerate(gathered.placements)]))
    elif both:
        block = _row_block(table.to_local(), mesh, rows_on, both)
        coord, b = mesh.get_coordinate(), 0
        for i in sliced:
            b = b * mesh.size(i) + coord[i]
        got = _masked_rows(block, local, b * block.shape[0], block.shape[0])
    elif rows_on:
        start, n = _local_range(table.shape[0], table.placements, 0, mesh)
        got = _masked_rows(table.to_local(), local, start, n)
    else:
        got = F.embedding(local, table.to_local())
    placements = [Partial() if i in sliced else
                  Shard(ids.dim()) if i in cols_on else p
                  for i, p in enumerate(mine.placements)]
    shape = tuple(ids.shape) + (table.shape[1],)
    rows = DTensor.from_local(got, mesh, placements, run_check=False,
                              shape=shape, stride=_contiguous(shape))
    if sliced:
        yield
        # the partial rows all-reduced whole, in one collective over the
        # mesh dims that shard them (GSPMD's; a reduce-scatter onto the
        # ids' layout would move half the bytes), then each device's part
        summed = rows.redistribute(mesh, [Replicate() if p.is_partial()
                                          else p for p in rows.placements])
        yield
        rows = summed
    return rows.redistribute(mesh, [p if p.is_shard() else Replicate()
                                    for p in ids.placements])


def _masked_rows(shard, ids, start: int, n: int):
    """The rows of ``ids`` that fall in ``shard`` (the table's rows
    ``start`` .. ``start + n``), zeros for the others."""
    inside = (ids >= start) & (ids < start + n)
    return F.embedding((ids - start).clamp(0, max(n - 1, 0)),
                       shard) * inside[..., None]


def _gather_table_first(table, ids, rows_on) -> bool:
    """Whether XLA's gather partitioner gathers the table over the mesh
    dims that shard both its rows and the ids (index passthrough) rather
    than slicing it where it lies (trivially sliced operand). It takes the
    way of the lower memory cost, the bytes of the new tensors (a tie
    slices): gathered, the whole table and the larger of its part over
    those dims and the local rows with their ids; sliced, the partial rows
    of the ids made whole over those dims, those ids, and the table's
    shard. The table's rows must split evenly over ``rows_on``."""
    mesh = table.device_mesh
    both = [i for i in rows_on if ids.placements[i].is_shard()]
    if (not both or mesh.size() == 1
            or table.shape[0] % math.prod(mesh.size(i) for i in rows_on)):
        return False
    shard = table.to_local()
    row = shard.shape[1] * shard.element_size()
    per_id = row + ids.element_size()
    n_local = ids.to_local().numel()
    n_both = math.prod(mesh.size(i) for i in both)
    whole_table = table.shape[0] * row
    gathered = whole_table + max(whole_table // n_both, n_local * per_id)
    sliced = n_local * n_both * per_id + shard.numel() * shard.element_size()
    return gathered < sliced


def _row_block(shard, mesh, rows_on, both):
    """This device's block of a table's rows sharded over ``rows_on`` (its
    ``shard`` is chunk ``ravel(coordinate over rows_on)``) once the table is
    whole over ``both``: block ``b = ravel(coordinate over the other dims of
    rows_on)``, the chunks ``b * |both| + k``. Chunk ``b * |both| + k`` first
    moves to the device whose coordinate over ``both`` ravels to ``k`` (a
    permute within ``rows_on``'s group), then an all-gather over ``both``
    collects the block. Both collectives are differentiable (their
    backward: the inverse permute, a reduce-scatter)."""
    import torch.distributed._functional_collectives as funcol
    rest = [i for i in rows_on if i not in both]
    n_both = math.prod(mesh.size(i) for i in both)
    me = dict(enumerate(mesh.get_coordinate()))
    b_to, k_to = divmod(_ravel(mesh, me, rows_on), n_both)
    dst = _ravel(mesh, {**_unravel(mesh, k_to, both),
                        **_unravel(mesh, b_to, rest)}, rows_on)
    src = _ravel(mesh, me, rest) * n_both + _ravel(mesh, me, both)
    moved = _permute(shard, mesh, rows_on, src, dst)
    return funcol.all_gather_tensor_autograd(moved, 0,
                                             _group_of(mesh, both))


def moved_shards(x, src, dst):
    """A DTensor ``x`` sharded on dim 0 over the mesh dims ``src`` and whole
    over ``dst``, laid out the other way round: sharded on dim 0 over
    ``dst``, whole over ``src``. Where the two sets of dims hold as many
    devices and lie together in the mesh, that is one permute (the device
    at ``a`` over ``src`` and ``b`` over ``dst`` swaps its chunk with the
    device at ``b`` over ``src`` and ``a`` over ``dst``: GSPMD's
    collective-permute); elsewhere DTensor redistributes it.
    Differentiable (the permute's backward is the inverse permute)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    want = [Shard(0) if k in dst else Replicate() if k in src else p
            for k, p in enumerate(x.placements)]
    dims = sorted(src + dst)
    size = math.prod(mesh.size(k) for k in src)
    if (size != math.prod(mesh.size(k) for k in dst)
            or dims != list(range(dims[0], dims[-1] + 1))
            or x.shape[0] % size):
        return x.redistribute(mesh, want)
    me = dict(enumerate(mesh.get_coordinate()))
    peer = _ravel(mesh, {**me, **_unravel(mesh, _ravel(mesh, me, dst), src),
                         **_unravel(mesh, _ravel(mesh, me, src), dst)}, dims)
    moved = _permute(x.to_local(), mesh, dims, peer, peer)
    return DTensor.from_local(moved, mesh, want, run_check=False,
                              shape=x.shape, stride=x.stride())


def _ravel(mesh, coord, dims) -> int:
    """The flat index of ``coord`` (mesh dim -> index) over ``dims``, the
    first dim major."""
    r = 0
    for i in dims:
        r = r * mesh.size(i) + coord[i]
    return r


def _unravel(mesh, n: int, dims) -> dict:
    """``_ravel``'s inverse: mesh dim -> index."""
    out = {}
    for i in reversed(dims):
        n, out[i] = divmod(n, mesh.size(i))
    return out


def _permute(local, mesh, dims, src: int, dst: int):
    """``local`` sent to rank ``dst`` of the group over mesh dims ``dims``
    while this rank takes rank ``src``'s: a collective-permute (an
    all-to-all whose every rank sends one block and receives one, as
    ``funcol.permute_tensor`` issues it; differentiable)."""
    import torch.distributed._functional_collectives as funcol
    ins = [0] * math.prod(mesh.size(i) for i in dims)
    outs = list(ins)
    ins[dst] = outs[src] = local.shape[0]
    return funcol.all_to_all_single_autograd(local.contiguous(), outs, ins,
                                             _group_of(mesh, dims))


def in_batch_scores(q, items):
    """``q @ items.T`` for DTensors q (B, d) and items (B, d) laid out as
    the batch (sharded on dim 0 over the batch's mesh dims, whole over the
    others), as GSPMD lays out the reference's in-batch logits: the items
    moved to the other mesh dims (``moved_shards``) and gathered whole
    there, each device scoring its queries against every item (the (B, B)
    scores sharded as q); in the backward each device takes its block of
    columns alone (the queries' gradient all-reduced over the other dims,
    the items' over the batch's, and moved back)."""
    batch = [k for k, p in enumerate(q.placements) if p.is_shard(0)]
    other = [k for k, p in enumerate(q.placements) if p.is_replicate()]
    if not batch or not other or q.device_mesh.size() == 1:
        return q @ items.T
    return _InBatchScores.apply(q, moved_shards(items, batch, other))


class _InBatchScores(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, block):
        from torch.distributed.tensor import Replicate
        ctx.save_for_backward(q, block)
        whole = block.redistribute(block.device_mesh,
                                   [Replicate()] * block.device_mesh.ndim)
        return q @ whole.T

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Shard
        q, block = ctx.saved_tensors
        mesh = q.device_mesh
        cols = g.redistribute(mesh, [p if p.is_shard() else Shard(1)
                                     for p in g.placements])
        return partials_reduced(cols @ block), partials_reduced(cols.T @ q)


def _group_of(mesh, dims):
    """The process group over mesh dims ``dims`` (consecutive: a run of
    two or more is one of the mesh's flattened dims)."""
    from torch.utils._python_dispatch import _disable_current_modes
    names = [mesh.mesh_dim_names[i] for i in dims]
    if len(names) == 1:
        return mesh.get_group(dims[0])
    with _disable_current_modes():     # slicing the mesh runs tensor ops
        return mesh["_".join(names)].get_group()


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
    m = partials_reduced(x.amax(dim=-1, keepdim=True).detach())
    return partials_reduced((x - m).exp().sum(dim=-1)).log() + m[..., 0]


def partials_reduced(x):
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
