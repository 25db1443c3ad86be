"""Embedding binary layout: CLS + BOW co-located, block-aligned (ESPN §4.1).

The CLS vector and the BOW token matrix of a document are packed together
and aligned so a typical compressed document costs ONE I/O block instead of
two. The "disk image" is a single uint8 numpy array on the host; an offsets
table (kept in host memory, as in the paper) maps doc id ->
(start_block, n_blocks, n_tokens). Gathers stay host numpy and yield fp32
buffers; the rerank moves them to the device.

Only the paper's ``ragged`` layout is ported (per-doc ``n_tokens``, variable
``n_blocks``, offsets stored in host memory).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.storage.ssd import DEFAULT_BLOCK


@dataclass
class EmbeddingLayout:
    blob: np.ndarray              # uint8 disk image (block-aligned)
    offsets: np.ndarray           # (N, 2) int64: start_block, n_blocks
    n_tokens: np.ndarray          # (N,) int32
    d_cls: int
    d_bow: int
    dtype: np.dtype               # stored element dtype (e.g. float16/int8)
    scales: np.ndarray | None     # (N,) fp32 dequant scales (a carried-over
                                  # int8 layout; pack() stores none)
    block: int = DEFAULT_BLOCK

    @property
    def n_docs(self) -> int:
        return len(self.offsets)

    @property
    def nbytes(self) -> int:
        return self.blob.nbytes

    def doc_bytes(self, i: int) -> int:
        elt = np.dtype(self.dtype).itemsize
        return (self.d_cls + int(self.n_tokens[i]) * self.d_bow) * elt

    def blocks_for(self, ids) -> int:
        """Total blocks touched by a set of doc ids (the IO bill)."""
        ids = np.asarray(ids, np.int64)
        return int(self.offsets[ids, 1].sum())


def pack(cls_embs: np.ndarray, bow_embs: list[np.ndarray], *,
         dtype=np.float16, block: int = DEFAULT_BLOCK,
         d_bow: int | None = None) -> EmbeddingLayout:
    """Build the block-aligned disk image.

    cls_embs: (N, d_cls) fp32; bow_embs: list of (t_i, d_bow) fp32 arrays,
    stored as ``dtype`` (fp16 default). An empty corpus packs to a valid
    empty layout (``d_bow`` may be passed explicitly when it cannot be
    inferred from a zero-doc ``bow_embs``).
    """
    n = len(bow_embs)
    cls_embs = np.asarray(cls_embs)
    d_cls = cls_embs.shape[1] if cls_embs.ndim == 2 else 0
    if n:
        d_bow = bow_embs[0].shape[1]
    elif d_bow is None:
        d_bow = 0
    n_tokens = np.array([b.shape[0] for b in bow_embs], np.int32)
    sizes = (d_cls + n_tokens.astype(np.int64) * d_bow) \
        * np.dtype(dtype).itemsize
    n_blocks = (sizes + block - 1) // block
    starts = np.zeros(n, np.int64)
    np.cumsum(n_blocks[:-1], out=starts[1:])
    blob = np.zeros(int(n_blocks.sum()) * block, np.uint8)
    if n and (n_tokens == n_tokens[0]).all():
        # uniform token count: one bulk write — bit-identical to the per-doc
        # loop, which writes the same record bytes at the same block starts
        recs = np.concatenate(
            [cls_embs, np.stack(bow_embs).reshape(n, -1)], axis=1)
        raw = np.ascontiguousarray(recs.astype(dtype)).view(np.uint8)
        view = blob.reshape(n, int(n_blocks[0]) * block)
        view[:, :raw.shape[1]] = raw
    else:
        for i in range(n):
            rec = np.concatenate([cls_embs[i].ravel(), bow_embs[i].ravel()])
            raw = rec.astype(dtype).view(np.uint8)
            s = starts[i] * block
            blob[s:s + raw.nbytes] = raw
    offsets = np.zeros((n, 2), np.int64)
    offsets[:, 0] = starts
    offsets[:, 1] = n_blocks
    return EmbeddingLayout(blob=blob, offsets=offsets, n_tokens=n_tokens,
                           d_cls=d_cls, d_bow=d_bow, dtype=np.dtype(dtype),
                           scales=None, block=block)


def unpack_doc(layout: EmbeddingLayout, i: int):
    """Read one doc back: returns (cls (d_cls,), bow (t_i, d_bow)) fp32."""
    start = layout.offsets[i, 0]
    t = int(layout.n_tokens[i])
    elt = layout.dtype.itemsize
    raw = layout.blob[start * layout.block:
                      start * layout.block + (layout.d_cls + t * layout.d_bow) * elt]
    vals = raw.view(layout.dtype).astype(np.float32)
    if layout.scales is not None:
        vals = vals * layout.scales[i]
    return vals[:layout.d_cls], vals[layout.d_cls:].reshape(t, layout.d_bow)


def gather_docs_at(layout: EmbeddingLayout, ids, rows, out_cls: np.ndarray,
                   out_bow: np.ndarray, out_lens: np.ndarray) -> None:
    """Gather ``ids`` into arbitrary (non-contiguous) buffer rows."""
    ids = np.asarray(ids, np.int64)
    rows = np.asarray(rows, np.int64)
    t_max = out_bow.shape[1]
    for i, row in zip(ids, rows):
        c, b = unpack_doc(layout, int(i))
        t = min(b.shape[0], t_max)
        out_bow[row, :t] = b[:t]
        out_cls[row] = c
        out_lens[row] = t


def gather_docs_into(layout: EmbeddingLayout, ids, out_cls: np.ndarray,
                     out_bow: np.ndarray, out_lens: np.ndarray) -> None:
    """Gather ``ids`` into caller-owned buffer slices (rows ``0..len(ids)``).

    The batch I/O engine preallocates one shared arena for a whole query
    batch and hands each run a disjoint slice, so runs can gather
    concurrently on the tier's thread pool with no further copies.
    """
    ids = np.asarray(ids, np.int64)
    gather_docs_at(layout, ids, np.arange(len(ids)), out_cls, out_bow,
                   out_lens)


def gather_docs(layout: EmbeddingLayout, ids, t_max: int):
    """Host-side ragged gather -> padded (len(ids), t_max, d_bow) + lengths."""
    ids = np.asarray(ids, np.int64)
    out = np.zeros((len(ids), t_max, layout.d_bow), np.float32)
    cls = np.zeros((len(ids), layout.d_cls), np.float32)
    lens = np.zeros(len(ids), np.int32)
    gather_docs_into(layout, ids, cls, out, lens)
    return cls, out, lens
