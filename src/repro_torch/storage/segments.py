"""Append segments: block-aligned sub-layouts layered over a shard.

The mutation layer (``repro_torch.storage.mutation``) never rewrites a
shard's base blob on ingest: new documents land in per-shard *segments*,
each a self-contained block-aligned ``EmbeddingLayout`` plus the global doc
ids it holds. A query that spans the base layout and k segments pays k+1
device reads on the simulated clock; compaction (``merge_rows`` into one
fresh run) removes that read amplification.

All row movement here is the raw block copy of ``build_shard_layout``:
blocks are gathered through a fancy index over the block-reshaped blob,
never unpacked and re-packed, so merged layouts equal a from-scratch
``pack`` of the same rows byte for byte, checksums included. Host numpy
only, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.storage.cluster import build_shard_layout
from repro_torch.storage.layout import EmbeddingLayout


@dataclass
class Segment:
    """One append run: a block-aligned layout + the global ids of its rows
    (row ``i`` of ``layout`` is document ``global_ids[i]``)."""
    layout: EmbeddingLayout
    global_ids: np.ndarray        # (n,) int64

    @property
    def n_docs(self) -> int:
        return len(self.global_ids)

    @property
    def n_blocks(self) -> int:
        return int(self.layout.offsets[:, 1].sum())


def empty_layout(like: EmbeddingLayout) -> EmbeddingLayout:
    """A zero-doc layout with ``like``'s dimensions, dtype, and mode."""
    return EmbeddingLayout(
        blob=np.zeros(0, np.uint8), offsets=np.zeros((0, 2), np.int64),
        n_tokens=np.zeros(0, np.int32), d_cls=like.d_cls, d_bow=like.d_bow,
        dtype=like.dtype,
        scales=(np.zeros(0, np.float32) if like.scales is not None else None),
        block=like.block, mode=like.mode, stride_blocks=like.stride_blocks,
        pool_k=like.pool_k,
        checksums=(np.zeros(0, np.uint32)
                   if like.checksums is not None else None))


def concat_layouts(layouts: list[EmbeddingLayout],
                   like: EmbeddingLayout | None = None) -> EmbeddingLayout:
    """Concatenate block-aligned layouts into one (row order preserved).

    Every input must share dimensions, dtype, block size, and scales
    presence (all-``None`` or all-present — a mix has no consistent
    dequant story and raises).
    """
    like = like if like is not None else layouts[0]
    if not layouts:
        return empty_layout(like)
    for lay in layouts:
        if (lay.d_cls, lay.d_bow, lay.block) != (like.d_cls, like.d_bow,
                                                 like.block):
            raise ValueError("cannot concat layouts with mismatched "
                             "dimensions or block size")
        if np.dtype(lay.dtype) != np.dtype(like.dtype):
            raise ValueError("cannot concat layouts with mismatched dtypes")
        if lay.mode != like.mode:
            raise ValueError("cannot concat layouts with mismatched "
                             "layout modes")
    has_scales = [lay.scales is not None for lay in layouts]
    if any(has_scales) and not all(has_scales):
        raise ValueError("cannot concat layouts mixing scaled and "
                         "unscaled rows")
    blob = np.concatenate([lay.blob for lay in layouts])
    shift = 0
    offs = []
    for lay in layouts:
        o = lay.offsets.copy()
        o[:, 0] += shift
        offs.append(o)
        shift += lay.blob.nbytes // lay.block
    # per-record checksums survive the raw block concat unchanged; a single
    # un-checksummed input drops the table (no consistent integrity story)
    has_ck = [lay.checksums is not None for lay in layouts]
    return EmbeddingLayout(
        blob=blob, offsets=np.concatenate(offs),
        n_tokens=np.concatenate([lay.n_tokens for lay in layouts]),
        d_cls=like.d_cls, d_bow=like.d_bow, dtype=np.dtype(like.dtype),
        scales=(np.concatenate([lay.scales for lay in layouts])
                if all(has_scales) else None),
        block=like.block, mode=like.mode, stride_blocks=like.stride_blocks,
        pool_k=like.pool_k,
        checksums=(np.concatenate([lay.checksums for lay in layouts])
                   if all(has_ck) else None))


def merge_rows(pieces: list[tuple[EmbeddingLayout, np.ndarray, np.ndarray]],
               like: EmbeddingLayout) -> tuple[EmbeddingLayout, np.ndarray]:
    """Compaction primitive: extract selected rows from several source
    layouts into ONE fresh block-aligned run.

    ``pieces`` is ``[(layout, local_rows, global_ids)]`` — the rows to keep
    from each source and the global doc ids they carry. Returns the merged
    layout plus the merged global-id order (piece order, row order within a
    piece). Raw block copies only; the sources are never modified.
    """
    kept = [(lay, np.asarray(rows, np.int64), np.asarray(gids, np.int64))
            for lay, rows, gids in pieces if len(rows)]
    if not kept:
        return empty_layout(like), np.zeros(0, np.int64)
    subs = [build_shard_layout(lay, rows) for lay, rows, _ in kept]
    gids = np.concatenate([g for _, _, g in kept])
    return concat_layouts(subs, like=like), gids
