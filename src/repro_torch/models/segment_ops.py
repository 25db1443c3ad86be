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
"""
from __future__ import annotations

from functools import cached_property

import torch


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
        n_valid = int((s < self.n).sum())        # the pads sort last
        order, s = order[:n_valid], s[:n_valid]
        uniq, counts = torch.unique_consecutive(s, return_counts=True)
        return order, uniq, counts

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """x (E, ...) -> (n, ...) in x's dtype: row i is the sum of the rows
        of x whose index is i, taken in their order (0 where there are
        none). Differentiable in x."""
        order, uniq, counts = self._sorted
        out = x.new_zeros((self.n,) + tuple(x.shape[1:]))
        if order.numel() == 0:
            return out
        sums = torch.segment_reduce(x.index_select(0, order), "sum",
                                    lengths=counts, axis=0, unsafe=True)
        return out.index_copy_(0, uniq, sums)

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
            return h.index_select(0, seg.idx)
        out = h.index_select(0, seg.idx.clamp(max=seg.n - 1))
        pad = (seg.idx >= seg.n).view((-1,) + (1,) * (h.dim() - 1))
        return out.masked_fill_(pad, 0)

    @staticmethod
    def backward(ctx, g):
        return ctx.seg.sum(g.float()).to(ctx.dtype), None
