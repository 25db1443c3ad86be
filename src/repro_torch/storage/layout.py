"""Embedding binary layout: CLS + BOW co-located, block-aligned (ESPN §4.1).

The CLS vector and the BOW token matrix of a document are packed together
and aligned so a typical compressed document costs ONE I/O block instead of
two. The "disk image" is a single uint8 numpy array on the host; an offsets
table (kept in host memory, as in the paper) maps doc id ->
(start_block, n_blocks, n_tokens).

Two layout **modes** share the accessor API:

- ``ragged`` (the paper's layout): per-doc ``n_tokens``, variable
  ``n_blocks``, offsets stored in host memory.
- ``fixed_stride`` (constant-space, MacAvaney et al. 2025): every doc holds
  exactly ``pool_k`` pooled tokens (``repro_torch.core.pool``), so every
  record spans the same ``stride_blocks`` blocks and the offsets and token
  counts are arithmetic, not stored: ``meta_nbytes`` is zero. In-process
  they are materialized once in ``__post_init__``, so every consumer of
  ``layout.offsets`` works on both modes unchanged.

Reads never unpack a doc at a time: ``stage_rows`` copies the stored token
rows of a run of docs into a caller-owned buffer of stored-dtype rows with
one fancy index, and the rerank packs and widens them on the device
(``kernels/gather_pack``).

``BitTable`` is the second, *resident* tier (Nardini et al. 2024): every
document token sign-binarized and bit-packed, ~1/16th of the fp16 BOW bytes,
so the ``bitvec`` and ``cascade`` backends filter candidates in memory and
read only the survivors from storage. It stays host numpy, as in the
reference; the filter moves each query's gathered lanes to the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.quantize import binary_pack, to_uint32_lanes
from repro_torch.storage.faults import add_checksums
from repro_torch.storage.ssd import DEFAULT_BLOCK

#: docs decoded per chunk when a resident table is built from the blob
#: (~3.8M tokens at the synthetic corpus's mean length)
CHUNK_DOCS = 65_536
LAYOUT_MODES = ("ragged", "fixed_stride")


@dataclass
class EmbeddingLayout:
    blob: np.ndarray              # uint8 disk image (block-aligned)
    offsets: np.ndarray | None    # (N, 2) int64: start_block, n_blocks
    n_tokens: np.ndarray | None   # (N,) int32
    d_cls: int
    d_bow: int
    dtype: np.dtype               # stored element dtype (e.g. float16/int8)
    scales: np.ndarray | None     # (N,) fp32 per-doc dequant scales
    block: int = DEFAULT_BLOCK
    mode: str = "ragged"          # "ragged" | "fixed_stride"
    stride_blocks: int = 0        # fixed mode: blocks per doc (uniform)
    pool_k: int = 0               # fixed mode: tokens per doc (uniform)
    checksums: np.ndarray | None = field(default=None, repr=False)
                                  # (N,) uint32 per-record crc32 over the
                                  # record's stored bytes (None = packed
                                  # without checksums)

    def __post_init__(self):
        if self.mode not in LAYOUT_MODES:
            raise ValueError(f"unknown layout mode {self.mode!r}; "
                             f"expected one of {LAYOUT_MODES}")
        if self.mode == "fixed_stride":
            if self.stride_blocks <= 0 or self.pool_k <= 0:
                raise ValueError("fixed_stride layout requires positive "
                                 "stride_blocks and pool_k")
            n = self.blob.nbytes // (self.stride_blocks * self.block)
            # pure arithmetic in fixed mode: materialized here, never
            # stored or billed (meta_nbytes stays 0)
            if self.offsets is None:
                starts = np.arange(n, dtype=np.int64) * self.stride_blocks
                self.offsets = np.stack(
                    [starts, np.full(n, self.stride_blocks, np.int64)],
                    axis=1)
            if self.n_tokens is None:
                self.n_tokens = np.full(n, self.pool_k, np.int32)
        elif self.offsets is None or self.n_tokens is None:
            raise ValueError("ragged layout requires stored offsets "
                             "and n_tokens")

    @property
    def n_docs(self) -> int:
        return len(self.offsets)

    @property
    def nbytes(self) -> int:
        return self.blob.nbytes

    @property
    def meta_nbytes(self) -> int:
        """Host-resident metadata bytes (the offsets table and token
        counts). Zero in fixed-stride mode: both are computable."""
        if self.mode == "fixed_stride":
            return 0
        return self.offsets.nbytes + self.n_tokens.nbytes

    def doc_bytes(self, i: int) -> int:
        elt = np.dtype(self.dtype).itemsize
        return (self.d_cls + int(self.n_tokens[i]) * self.d_bow) * elt

    def blocks_for(self, ids) -> int:
        """Total blocks touched by a set of doc ids (the IO bill)."""
        ids = np.asarray(ids, np.int64)
        if self.mode == "fixed_stride":
            return len(ids) * self.stride_blocks
        return int(self.offsets[ids, 1].sum())


def pack(cls_embs: np.ndarray, bow_embs: list[np.ndarray], *,
         dtype=np.float16, scales: np.ndarray | None = None,
         block: int = DEFAULT_BLOCK, mode: str = "ragged",
         pool_k: int = 0, d_bow: int | None = None,
         checksum: bool = False) -> EmbeddingLayout:
    """Build the block-aligned disk image.

    cls_embs: (N, d_cls) fp32; bow_embs: list of (t_i, d_bow) fp32 arrays,
    stored as ``dtype`` (fp16 default); with ``scales`` (N,), each record is
    divided by its doc's scale before the cast (an int8 layout's per-doc
    scale). ``mode="fixed_stride"`` requires every doc to hold exactly
    ``pool_k`` tokens (pool first: ``repro_torch.core.pool``); the layout
    then stores no per-doc offset or token tables. An empty corpus packs to a valid empty layout (``d_bow``
    may be passed explicitly when it cannot be inferred from a zero-doc
    ``bow_embs``).

    ``checksum=True`` attaches each record's crc32
    (``repro_torch.storage.faults``); the record bytes are unchanged, so a
    checksummed layout ranks and bills as a plain one.
    """
    n = len(bow_embs)
    cls_embs = np.asarray(cls_embs)
    d_cls = cls_embs.shape[1] if cls_embs.ndim == 2 else 0
    if n:
        d_bow = bow_embs[0].shape[1]
    elif d_bow is None:
        d_bow = 0
    elt = np.dtype(dtype).itemsize
    n_tokens = np.array([b.shape[0] for b in bow_embs], np.int32)
    if mode == "fixed_stride":
        if pool_k <= 0:
            raise ValueError("fixed_stride pack requires pool_k > 0")
        if n and not (n_tokens == pool_k).all():
            raise ValueError("fixed_stride pack requires every doc to hold "
                             f"exactly pool_k={pool_k} tokens; "
                             "pool the corpus first (repro_torch.core.pool)")
        stride = (d_cls + pool_k * d_bow) * elt
        stride_blocks = max(1, -(-stride // block))
        n_blocks = np.full(n, stride_blocks, np.int64)
    else:
        sizes = (d_cls + n_tokens.astype(np.int64) * d_bow) * elt
        n_blocks = (sizes + block - 1) // block
    starts = np.zeros(n, np.int64)
    np.cumsum(n_blocks[:-1], out=starts[1:])
    blob = np.zeros(int(n_blocks.sum()) * block, np.uint8)
    if n and (n_tokens == n_tokens[0]).all():
        # uniform token count (always so in fixed mode): one bulk write —
        # bit-identical to the per-doc loop, which writes the same record
        # bytes at the same block starts
        recs = np.concatenate(
            [cls_embs, np.stack(bow_embs).reshape(n, -1)], axis=1)
        if scales is not None:
            recs = recs / scales[:, None]
        raw = np.ascontiguousarray(recs.astype(dtype)).view(np.uint8)
        view = blob.reshape(n, int(n_blocks[0]) * block)
        view[:, :raw.shape[1]] = raw
    else:
        for i in range(n):
            rec = np.concatenate([cls_embs[i].ravel(), bow_embs[i].ravel()])
            if scales is not None:
                rec = rec / scales[i]
            raw = rec.astype(dtype).view(np.uint8)
            s = starts[i] * block
            blob[s:s + raw.nbytes] = raw
    if mode == "fixed_stride":
        out = EmbeddingLayout(blob=blob, offsets=None, n_tokens=None,
                              d_cls=d_cls, d_bow=d_bow,
                              dtype=np.dtype(dtype), scales=scales,
                              block=block, mode=mode,
                              stride_blocks=int(stride_blocks),
                              pool_k=pool_k)
    else:
        offsets = np.zeros((n, 2), np.int64)
        offsets[:, 0] = starts
        offsets[:, 1] = n_blocks
        out = EmbeddingLayout(blob=blob, offsets=offsets, n_tokens=n_tokens,
                              d_cls=d_cls, d_bow=d_bow,
                              dtype=np.dtype(dtype), scales=scales,
                              block=block)
    if checksum:
        add_checksums(out)
    return out


def _token_rows(layout: EmbeddingLayout, ids: np.ndarray,
                counts: np.ndarray) -> np.ndarray:
    """The first ``counts[j]`` stored BOW token rows of each doc
    ``ids[j]``, concatenated in ``ids`` order: (sum(counts), d_bow) in the
    layout's dtype, scales not applied.

    Every token row is one contiguous byte range of the blob, so this is
    one fancy-index over a strided (byte offset, row) view of the blob, at
    one int64 per token."""
    elt = layout.dtype.itemsize
    row = layout.d_bow * elt
    nt = counts.astype(np.int64)
    tot = int(nt.sum())
    if tot == 0 or row == 0:
        return np.zeros((tot, layout.d_bow), layout.dtype)
    starts = layout.offsets[ids, 0] * layout.block + layout.d_cls * elt
    first = np.zeros(len(nt), np.int64)            # first token of each doc
    np.cumsum(nt[:-1], out=first[1:])
    src = (np.repeat(starts - first * row, nt)
           + np.arange(tot, dtype=np.int64) * row)
    blob = layout.blob
    rows = np.lib.stride_tricks.as_strided(
        blob, shape=(blob.size - row + 1, row), strides=(1, 1),
        writeable=False)
    return rows[src].view(layout.dtype)


def stage_rows(layout: EmbeddingLayout, ids, t_max: int,
               out: np.ndarray) -> None:
    """Stage a run of docs for the device: copy the stored BOW token rows
    of ``ids``, each doc clipped at ``t_max`` tokens, concatenated in
    ``ids`` order, into the caller-owned ``out`` ((sum of the clipped
    counts, d_bow) in the layout's dtype). Raw stored values: no widening,
    no scales, no padding (the rerank packs, widens and scales on the
    device). Serves both layout modes."""
    ids = np.asarray(ids, np.int64)
    out[...] = _token_rows(layout, ids,
                           np.minimum(layout.n_tokens[ids], t_max))


def bow_rows(layout: EmbeddingLayout, d0: int, d1: int) -> np.ndarray:
    """The stored BOW token rows of docs ``d0..d1``, concatenated in doc
    order: (tokens, d_bow) in the layout's dtype, scales not applied (the
    same bytes the reference's per-byte gather picks)."""
    return _token_rows(layout, np.arange(d0, d1, dtype=np.int64),
                       layout.n_tokens[d0:d1])


def token_scales(layout: EmbeddingLayout, d0: int, d1: int):
    """(tokens, 1) fp32 dequant scale of each token of docs ``d0..d1``, or
    ``None`` for a layout stored without scales."""
    if layout.scales is None:
        return None
    return np.repeat(layout.scales[d0:d1],
                     layout.n_tokens[d0:d1].astype(np.int64))[:, None]


@dataclass
class BitTable:
    """Resident sign-bit table over all document tokens.

    ``packed`` concatenates every doc's (t_i, W) bit-packed token matrix
    along axis 0; ``starts`` is the (N+1,) token-offset prefix sum. Lane
    dtype is a storage knob (``StorageConfig.bit_dtype``): uint8 wastes no
    pad bytes when d_bow % 32 != 0, uint32 is the bitsim kernel's native
    width. ``gather`` always hands back uint32 lanes (bit-exact re-view).
    """
    packed: np.ndarray            # (total_tokens, W) unsigned int lanes
    starts: np.ndarray            # (N + 1,) int64 token offsets
    d_bow: int
    _lanes32: np.ndarray | None = field(default=None, repr=False,
                                        compare=False)

    @property
    def n_docs(self) -> int:
        return len(self.starts) - 1

    @property
    def nbytes(self) -> int:
        return self.packed.nbytes + self.starts.nbytes

    def doc(self, i: int) -> np.ndarray:
        return self.packed[self.starts[i]:self.starts[i + 1]]

    @property
    def lanes32(self) -> np.ndarray:
        """Kernel-native uint32 view of the whole table, converted once (a
        no-copy re-view when the pack dtype is already uint32)."""
        if self._lanes32 is None:
            self._lanes32 = to_uint32_lanes(self.packed)
        return self._lanes32

    def append(self, bow_embs: list[np.ndarray]) -> None:
        """Extend the table with newly ingested docs' tokens, in doc-id
        order. Sign packing is per token, so this equals re-packing the
        grown corpus from scratch bit for bit; the cached uint32 re-view is
        dropped."""
        if not bow_embs:
            return
        add = pack_bits(list(bow_embs), dtype=str(self.packed.dtype))
        self.packed = np.concatenate([self.packed, add.packed], axis=0)
        self.starts = np.concatenate(
            [self.starts, add.starts[1:] + self.starts[-1]])
        self._lanes32 = None

    def gather(self, ids, t_max: int):
        """Padded uint32-lane gather: (len(ids), t_max, W32) + lengths, one
        bulk fancy-index over the lane table via the ``starts`` prefix
        sums (the bit filter's per-query hot path)."""
        ids = np.asarray(ids, np.int64)
        lanes = self.lanes32
        m = len(ids)
        out = np.zeros((m, t_max, lanes.shape[-1]), np.uint32)
        lens = np.zeros(m, np.int32)
        if m == 0:
            return out, lens
        s = self.starts[ids]
        t = np.minimum(self.starts[ids + 1] - s, t_max)
        off = np.zeros(m, np.int64)
        np.cumsum(t[:-1], out=off[1:])
        tot = int(t.sum())
        if tot:
            flat = np.arange(tot, dtype=np.int64)
            rows = np.repeat(np.arange(m, dtype=np.int64), t)
            pos = flat - np.repeat(off, t)
            src = np.repeat(s - off, t) + flat
            out[rows, pos] = lanes[src]
        lens[:] = t.astype(np.int32)
        return out, lens


def pack_bits(bow_embs: list[np.ndarray], *, dtype: str = "uint32",
              d_bow: int = 0) -> BitTable:
    """Sign-binarize and bit-pack a ragged BOW list into one resident table.
    An empty list packs to a valid empty table of ``d_bow`` dims."""
    n_tokens = np.array([b.shape[0] for b in bow_embs], np.int64)
    starts = np.zeros(len(bow_embs) + 1, np.int64)
    np.cumsum(n_tokens, out=starts[1:])
    flat = np.concatenate([b for b in bow_embs], axis=0) if bow_embs else \
        np.zeros((0, d_bow), np.float32)
    return BitTable(packed=binary_pack(flat, dtype=dtype), starts=starts,
                    d_bow=flat.shape[-1])


def bits_from_layout(layout: EmbeddingLayout, *, dtype: str = "uint32",
                     chunk_docs: int = CHUNK_DOCS) -> BitTable:
    """Build the resident bit table from an already-packed disk layout.
    Signs survive fp16/int8 storage quantization, so this is equivalent to
    packing the original embeddings.

    The blob is decoded ``chunk_docs`` docs at a time (``bow_rows``), so
    the transient fp32 tokens stay bounded; sign packing is per token, so
    the chunks concatenate to the reference's table bit for bit."""
    n = layout.n_docs
    if n == 0:
        return pack_bits([], dtype=dtype, d_bow=layout.d_bow)
    parts = []
    for d0 in range(0, n, chunk_docs):
        d1 = min(n, d0 + chunk_docs)
        vals = bow_rows(layout, d0, d1).astype(np.float32)
        scale = token_scales(layout, d0, d1)
        if scale is not None:
            vals = vals * scale
        parts.append(binary_pack(vals, dtype=dtype))
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(layout.n_tokens.astype(np.int64), out=starts[1:])
    return BitTable(packed=np.concatenate(parts), starts=starts,
                    d_bow=layout.d_bow)


# -- decoded host gathers (the reference's buffer API) -------------------------

def unpack_doc(layout: EmbeddingLayout, i: int):
    """Read one doc back: returns (cls (d_cls,), bow (t_i, d_bow)) fp32."""
    start, _ = layout.offsets[i]
    t = int(layout.n_tokens[i])
    elt = layout.dtype.itemsize
    raw = layout.blob[start * layout.block:
                      start * layout.block
                      + (layout.d_cls + t * layout.d_bow) * elt]
    vals = raw.view(layout.dtype).astype(np.float32)
    if layout.scales is not None:
        vals = vals * layout.scales[i]
    return vals[:layout.d_cls], vals[layout.d_cls:].reshape(t, layout.d_bow)


def _gather_fixed_at(layout: EmbeddingLayout, ids: np.ndarray,
                     rows: np.ndarray, out_cls: np.ndarray,
                     out_bow: np.ndarray, out_lens: np.ndarray) -> None:
    """Fixed-stride bulk gather: one strided fancy-index over the blob.
    Bit-identical to the ragged unpack path (same record bytes, same fp32
    conversion, same scale multiply)."""
    k = layout.pool_k
    t = min(k, out_bow.shape[1])
    elt = layout.dtype.itemsize
    stride_bytes = layout.stride_blocks * layout.block
    rec_bytes = (layout.d_cls + k * layout.d_bow) * elt
    raw = layout.blob.reshape(-1, stride_bytes)[ids, :rec_bytes]
    vals = raw.view(layout.dtype).astype(np.float32)
    if layout.scales is not None:
        vals = vals * layout.scales[ids, None]
    out_cls[rows] = vals[:, :layout.d_cls]
    out_bow[rows, :t] = vals[:, layout.d_cls:layout.d_cls + t * layout.d_bow] \
        .reshape(len(ids), t, layout.d_bow)
    out_lens[rows] = t


def gather_docs_at(layout: EmbeddingLayout, ids, rows, out_cls: np.ndarray,
                   out_bow: np.ndarray, out_lens: np.ndarray) -> None:
    """Decode ``ids`` into arbitrary (non-contiguous) rows of caller-owned
    fp32 buffers: CLS, BOW padded to ``out_bow.shape[1]`` tokens, and the
    token counts."""
    ids = np.asarray(ids, np.int64)
    rows = np.asarray(rows, np.int64)
    if layout.mode == "fixed_stride" and len(ids):
        _gather_fixed_at(layout, ids, rows, out_cls, out_bow, out_lens)
        return
    t_max = out_bow.shape[1]
    for i, row in zip(ids, rows):
        c, b = unpack_doc(layout, int(i))
        t = min(b.shape[0], t_max)
        out_bow[row, :t] = b[:t]
        out_cls[row] = c
        out_lens[row] = t


def gather_docs_into(layout: EmbeddingLayout, ids, out_cls: np.ndarray,
                     out_bow: np.ndarray, out_lens: np.ndarray) -> None:
    """Decode ``ids`` into caller-owned buffer rows ``0..len(ids)``."""
    ids = np.asarray(ids, np.int64)
    gather_docs_at(layout, ids, np.arange(len(ids)), out_cls, out_bow,
                   out_lens)


def gather_docs(layout: EmbeddingLayout, ids, t_max: int):
    """Host-side decoded gather -> (cls (n, d_cls), bow (n, t_max, d_bow)
    padded, lens (n,)), fp32. The read path does not use it: it stages raw
    token rows (``stage_rows``) and packs them on the device
    (``kernels/gather_pack``)."""
    ids = np.asarray(ids, np.int64)
    out = np.zeros((len(ids), t_max, layout.d_bow), np.float32)
    cls = np.zeros((len(ids), layout.d_cls), np.float32)
    lens = np.zeros(len(ids), np.int32)
    gather_docs_into(layout, ids, cls, out, lens)
    return cls, out, lens
