"""Embedding tables and EmbeddingBag for the RecSys models.

``lookup`` gathers one row per field from each table; ``embedding_bag``
gathers a ragged multi-hot bag of rows and reduces each bag. The lookup is
the direct analogue of ESPN's BOW-table access: the tables are what does not
fit (``storage/espn_embedding.py`` serves them from the storage tier).

Stored row counts are the reference's: a table of at least
``SHARD_MIN_ROWS`` rows rounds up to a multiple of ``PAD_MULTIPLE`` (its
mesh); ids never touch the pad rows. Both reductions give the same bits on
every run: a gather's backward sums its gradient rows in row order
(``segment_ops``), and a bag is summed in row order by
``torch.segment_reduce`` over its CSR offsets, with no atomics.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import (is_dtensor, sharded_lookups,
                                       sharded_rows)
from repro_torch.models.segment_ops import Segments

# tables with fewer rows than this are neither padded nor sharded
SHARD_MIN_ROWS = 65_536
# stored row counts of the larger tables round up to a multiple of this
PAD_MULTIPLE = 512


def padded_rows(r: int) -> int:
    return -(-r // PAD_MULTIPLE) * PAD_MULTIPLE if r >= SHARD_MIN_ROWS else r


def table_shapes(table_sizes, embed_dim, dtype=torch.float32) -> dict:
    """The tables as empty ``meta`` tensors (stored rows, ``embed_dim``)."""
    return {f"table_{i}": torch.empty((padded_rows(r), embed_dim),
                                      dtype=dtype, device="meta")
            for i, r in enumerate(table_sizes)}


def table_logical_axes(table_sizes) -> dict:
    """Each table's logical axes: rows over the whole mesh ("rows") from
    ``SHARD_MIN_ROWS`` rows on, replicated below."""
    return {f"table_{i}": (("rows", None) if r >= SHARD_MIN_ROWS
                           else (None, None))
            for i, r in enumerate(table_sizes)}


def init_tables(generator: torch.Generator, table_sizes, embed_dim,
                dtype=torch.float32, scale=None) -> dict:
    """N(0, 1) x ``scale`` (default rows^-0.25 x 0.1) per table, drawn in
    place on ``generator``'s device (a table set larger than the host's
    memory is drawn on the card)."""
    out = {}
    for i, rows in enumerate(table_sizes):
        s = scale if scale is not None else rows ** -0.25 * 0.1
        t = torch.empty((padded_rows(rows), embed_dim),
                        device=generator.device)
        out[f"table_{i}"] = t.normal_(generator=generator).mul_(s).to(dtype)
    return out


def _rows_sharded(table) -> bool:
    return is_dtensor(table) and any(p.is_shard(0) for p in table.placements)


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` whose backward sums the gradient rows of equal ids in
    their order (the same bits on every run). A DTensor table sharded by
    rows is read where it lies (``layers.sharded_rows``)."""
    if _rows_sharded(table):
        return sharded_rows(table, ids)
    return Segments(ids, table.shape[0]).gather(table)


def lookup(tables: dict, ids: torch.Tensor,
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """ids: (B, n_fields) one id per field -> (B, n_fields, D) in
    ``compute_dtype``, each row cast after its gather. The DTensor tables
    sharded by rows are looked up together (``layers.sharded_lookups``)."""
    fields = [(tables[f"table_{i}"], ids[:, i]) for i in range(ids.shape[1])]
    on_mesh = [k for k, (t, _) in enumerate(fields) if _rows_sharded(t)]
    got = dict(zip(on_mesh, sharded_lookups([fields[k] for k in on_mesh])))
    return torch.stack([(got[k] if k in got else take(*fields[k]))
                        .to(compute_dtype) for k in range(len(fields))],
                       dim=1)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  offsets: torch.Tensor, *, combiner="sum",
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """EmbeddingBag: table (R, D); ids (T,) flat; offsets (B+1,) CSR bag
    boundaries (offsets[0] = 0, offsets[-1] = T). Returns (B, D): each
    bag's rows summed in fp32 in row order (zeros for an empty bag), for
    ``mean`` divided by max(count, 1)."""
    rows = take(table, ids).float()
    offsets = offsets.to(device=rows.device, dtype=torch.int64)
    summed = torch.segment_reduce(rows, "sum", offsets=offsets, axis=0)
    if combiner == "mean":
        cnt = (offsets[1:] - offsets[:-1]).float()
        summed = summed / torch.clamp(cnt[:, None], min=1.0)
    return summed.to(compute_dtype)


def embedding_bag_ref(table, ids, offsets, *, combiner="sum") -> np.ndarray:
    """Pure-python oracle for tests."""
    table = np.asarray(table, np.float32)
    ids = np.asarray(ids)
    offsets = np.asarray(offsets)
    out = []
    for b in range(len(offsets) - 1):
        rows = table[ids[offsets[b]:offsets[b + 1]]]
        if rows.shape[0] == 0:
            out.append(np.zeros(table.shape[1], np.float32))
        elif combiner == "mean":
            out.append(rows.mean(0))
        else:
            out.append(rows.sum(0))
    return np.stack(out)
