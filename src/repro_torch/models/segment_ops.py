"""Row gathers and segment sums that give the same bits on every run.

A gather's backward and a segment sum are scatter-adds. On the card,
``index_add_`` and the backward of an indexing op add with atomics, whose
order (and so whose fp32 rounding) changes from run to run. Here an index
is sorted once, stably; each segment's rows are summed in their original
order by ``torch.segment_reduce`` (one sequential sum per segment and lane,
no atomics), and each sum is written to its row once (``index_copy``).

Indices equal to ``n`` are pads (the reference's ``dst = n_nodes`` sink
edges): no sum reaches them, in the forward or in the backward, and where
the index is made ``padded`` a gather gives zeros for them, without indexing
out of range. An index that holds no pad (an embedding lookup's ids, a
GNN's sources) gathers with one ``index_select``.

An index without values (a ``FakeTensorMode`` tensor: the dry run's) takes
the static bound of each data-dependent size: every position counts, and
there are min(E, n) distinct indices.

On a mesh (the dry run's DTensors), a sum whose rows lie sharded as the
index is taken where they lie, as GSPMD lowers the reference's
``segment_sum``: each shard sorts its part of the index and sums its own
rows in their order, and one all-reduce of the (n, ...) partial sums makes
them whole. No edge-sized tensor crosses the wire. A gather's backward
sums its gradient rows the same way.
"""
from __future__ import annotations

from functools import cached_property

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.models.layers import embed_rows, is_dtensor


class Segments:
    """An index vector ``idx`` (E,) into ``n`` rows (values in [0, n]; n is
    a pad, which only a ``padded`` index may hold where it is gathered),
    sorted on first use and kept for every sum over it."""

    def __init__(self, idx: torch.Tensor, n: int, *, padded: bool = False):
        self.idx, self.n, self.padded = idx.long(), int(n), padded

    @cached_property
    def _sorted(self):
        """(order of the non-pad positions by index, stable; the distinct
        indices; the count of each)."""
        order = torch.sort(self.idx, stable=True).indices
        s = self.idx[order]
        if is_fake(s):                           # no values: the bounds
            m = min(s.shape[0], self.n)
            return order, s[:m], torch.ones_like(s[:m])
        n_valid = int((s < self.n).sum())        # the pads sort last
        order, s = order[:n_valid], s[:n_valid]
        uniq, counts = torch.unique_consecutive(s, return_counts=True)
        return order, uniq, counts

    @cached_property
    def _local(self) -> "Segments":
        """This shard's part of a DTensor index, as an index of its own."""
        return Segments(self.idx.to_local(), self.n, padded=self.padded)

    def _sharded_like_idx(self, x) -> bool:
        """Whether ``x`` is a DTensor laid out as the index: its rows split
        over the mesh dims that split the index, whole over the others."""
        if not (is_dtensor(x) and is_dtensor(self.idx)):
            return False
        rows = tuple(self.idx.placements)
        return (x.device_mesh == self.idx.device_mesh
                and tuple(x.placements) == rows
                and any(p.is_shard(0) for p in rows)
                and all(p.is_shard(0) or p.is_replicate() for p in rows))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """x (E, ...) -> (n, ...) in x's dtype: row i is the sum of the rows
        of x whose index is i, taken in their order (0 where there are
        none). Differentiable in x. A DTensor ``x`` sharded by rows as the
        index is summed shard by shard (see the module's docstring) and
        comes back whole on every rank."""
        if self._sharded_like_idx(x):
            return self._mesh_sum(x)
        order, uniq, counts = self._sorted
        out = x.new_zeros((self.n,) + tuple(x.shape[1:]))
        if order.numel() == 0:
            return out
        sums = torch.segment_reduce(x.index_select(0, order), "sum",
                                    lengths=counts, axis=0, unsafe=True)
        return out.index_copy_(0, uniq, sums)

    def _mesh_sum(self, x):
        """``sum`` of a DTensor sharded as the index: local sums, then one
        all-reduce over the mesh dims that split the rows (flattened into
        one group, as GSPMD reduces over both axes at once)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        from torch.utils._python_dispatch import _disable_current_modes
        mesh = x.device_mesh
        rows = tuple(mesh.mesh_dim_names[i]
                     for i, p in enumerate(x.placements) if p.is_shard(0))
        with _disable_current_modes():   # mesh bookkeeping, not the step's
            group = mesh[rows]
            if len(rows) > 1:
                group = group._flatten()
        part = self._local.sum(x.to_local())
        whole = DTensor.from_local(part, group, [Partial()], run_check=False
                                   ).redistribute(group, [Replicate()])
        return DTensor.from_local(whole.to_local(), mesh,
                                  [Replicate()] * mesh.ndim, run_check=False)

    def counts(self) -> torch.Tensor:
        """(n,) int64: how many positions index each row."""
        _, uniq, counts = self._sorted
        return torch.zeros(self.n, dtype=torch.int64,
                           device=self.idx.device).index_copy(0, uniq, counts)

    def gather(self, h: torch.Tensor) -> torch.Tensor:
        """h (n, ...) -> (E, ...): ``h[idx]``, zeros at the pads of a
        ``padded`` index. Its backward sums the gradient rows by ``sum`` (in fp32, cast back to
        h's dtype)."""
        return _Gather.apply(h, self)


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, seg: Segments):
        ctx.seg, ctx.dtype = seg, h.dtype
        if not seg.padded:
            if h.dim() == 2 and is_dtensor(h):      # the dry run's layouts
                return embed_rows(h, seg.idx)
            return h.index_select(0, seg.idx)
        out = h.index_select(0, seg.idx.clamp(max=seg.n - 1))
        pad = (seg.idx >= seg.n).view((-1,) + (1,) * (h.dim() - 1))
        return out.masked_fill_(pad, 0)

    @staticmethod
    def backward(ctx, g):
        return ctx.seg.sum(g.float()).to(ctx.dtype), None
