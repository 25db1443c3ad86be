"""Artifact persistence for the ported pipeline: the IVF index, the packed
embedding layout (with its record checksums), the resident bit and FDE
tables, a storage cluster's shard sub-layouts and the synthetic corpus, each
one ``.npz`` file. Used by ``Pipeline.save``/``Pipeline.load``.

The file format is the reference package's, field for field: the same npz
names and dtypes and the same ``.crc32`` sidecar, so a directory saved by
either package loads in the other. Tensors come off the device with
``.cpu().numpy()`` on save and go onto the caller's device on load.

Crash safety and integrity: every artifact is written to a temp file in the
same directory and published with ``os.replace`` (a crash mid-save leaves
the previous artifact intact, never a torn one), then a ``.crc32`` sidecar
records the final file's crc32 and byte size. ``verified_load`` checks the
sidecar before parsing and raises ``ArtifactIntegrityError`` on a missing
sidecar, a size mismatch or a checksum mismatch.
"""
from __future__ import annotations

import os
import zlib

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.fde import FDETable
from repro_torch.core.ivf import IVFIndex
from repro_torch.data.synthetic import Corpus
from repro_torch.storage.layout import BitTable, EmbeddingLayout

_EMPTY = np.zeros(0, np.float32)
_EMPTY_U32 = np.zeros(0, np.uint32)


class ArtifactIntegrityError(IOError):
    """A persisted artifact failed its sidecar integrity check."""


def _sidecar(path: str) -> str:
    return path + ".crc32"


def _file_crc(path: str) -> tuple[int, int]:
    crc, size = 0, 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return crc, size


def atomic_savez(path: str, **fields) -> None:
    """``np.savez`` with crash-safe publication: write to a temp file in the
    target directory, fsync, ``os.replace`` into place, then publish the
    ``.crc32`` sidecar (crc + size of the final bytes) the same way. A crash
    at any point leaves either the old consistent (artifact, sidecar) pair
    or a mismatched pair that ``verified_load`` rejects."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **fields)
            f.flush()
            os.fsync(f.fileno())
        crc, size = _file_crc(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    side_tmp = _sidecar(path) + ".tmp"
    with open(side_tmp, "w") as f:
        f.write(f"{crc:08x} {size}\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(side_tmp, _sidecar(path))


def verified_load(path: str):
    """``np.load`` behind the sidecar check: the artifact's bytes must match
    the recorded crc32 and size exactly."""
    side = _sidecar(path)
    if not os.path.exists(side):
        raise ArtifactIntegrityError(
            f"{path}: missing integrity sidecar {side} (torn save, or an "
            "artifact from before checksummed persistence — rebuild it)")
    with open(side) as f:
        want_crc_hex, want_size = f.read().split()
    crc, size = _file_crc(path)
    if size != int(want_size) or crc != int(want_crc_hex, 16):
        raise ArtifactIntegrityError(
            f"{path}: integrity check failed (have crc32 {crc:08x}/{size}B, "
            f"sidecar says {want_crc_hex}/{want_size}B) — the artifact is "
            "torn or corrupted; rebuild it")
    return np.load(path, allow_pickle=False)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# -- IVF index --------------------------------------------------------------

def save_index(index: IVFIndex, path: str) -> None:
    atomic_savez(path, centroids=_host(index.centroids),
                 cell_ids=_host(index.cell_ids),
                 cell_vecs=_host(index.cell_vecs),
                 cell_scale=(_host(index.cell_scale)
                             if index.cell_scale is not None else _EMPTY),
                 cell_sizes=index.cell_sizes, n_docs=index.n_docs,
                 quant=str(index.quant))


def load_index(path: str, device) -> IVFIndex:
    return convert.ivf_index_from_numpy(verified_load(path), device)


# -- packed embedding layout ------------------------------------------------

def _layout_fields(layout: EmbeddingLayout) -> dict:
    """npz field dict for a layout. A fixed-stride layout persists no
    offsets or token counts: they are arithmetic, recomputed on load."""
    fields = dict(blob=layout.blob, d_cls=layout.d_cls, d_bow=layout.d_bow,
                  dtype=str(np.dtype(layout.dtype)),
                  scales=(layout.scales if layout.scales is not None
                          else _EMPTY),
                  block=layout.block, mode=layout.mode,
                  stride_blocks=layout.stride_blocks, pool_k=layout.pool_k,
                  checksums=(layout.checksums
                             if layout.checksums is not None else _EMPTY_U32))
    if layout.mode != "fixed_stride":
        fields["offsets"] = layout.offsets
        fields["n_tokens"] = layout.n_tokens
    return fields


def _layout_from_npz(z) -> EmbeddingLayout:
    layout = convert.layout_from_numpy(z)
    if "checksums" in z.files and z["checksums"].size:
        layout.checksums = z["checksums"]
    return layout


def save_layout(layout: EmbeddingLayout, path: str) -> None:
    atomic_savez(path, **_layout_fields(layout))


def load_layout(path: str) -> EmbeddingLayout:
    return _layout_from_npz(verified_load(path))


# -- sharded layouts (storage cluster) --------------------------------------

def save_shard_layout(layout: EmbeddingLayout, global_ids: np.ndarray,
                      path: str) -> None:
    """One cluster shard: its sub-layout plus the global doc ids it owns
    (the cluster rebuilds its doc -> shard maps from these on load)."""
    atomic_savez(path, **_layout_fields(layout),
                 global_ids=np.asarray(global_ids, np.int64))


def load_shard_layout(path: str) -> tuple[EmbeddingLayout, np.ndarray]:
    z = verified_load(path)
    return _layout_from_npz(z), z["global_ids"]


# -- resident bit table (bitvec, cascade) -----------------------------------

def save_bits(bits: BitTable, path: str) -> None:
    atomic_savez(path, packed=bits.packed, starts=bits.starts,
                 d_bow=bits.d_bow)


def load_bits(path: str) -> BitTable:
    return convert.bit_table_from_numpy(verified_load(path))


# -- resident FDE table (fde, cascade) --------------------------------------

def save_fde(fde: FDETable, path: str) -> None:
    """The generating FDEConfig rides along: a reloaded table must encode
    queries with the same partitions and projection."""
    c = fde.cfg
    atomic_savez(path, vecs=_host(fde.vecs), d_bow=c.d_bow, k_sim=c.k_sim,
                 r_reps=c.r_reps, d_final=c.d_final,
                 fill_empty=int(c.fill_empty), seed=c.seed)


def load_fde(path: str, device) -> FDETable:
    return convert.fde_table_from_numpy(verified_load(path), device)


# -- corpus -----------------------------------------------------------------

def save_corpus(corpus: Corpus, path: str) -> None:
    """Ragged BOW lists and qrels sets are flattened with length tables."""
    bow_flat = (np.concatenate([b.reshape(-1, b.shape[-1])
                                for b in corpus.bow])
                if corpus.bow else np.zeros((0, 0), np.float32))
    qrel_lens = np.array([len(r) for r in corpus.qrels], np.int64)
    qrel_flat = np.array([i for r in corpus.qrels for i in sorted(r)],
                         np.int64)
    atomic_savez(path, cls=corpus.cls, doc_lens=corpus.doc_lens,
                 bow_flat=bow_flat, has_bow=bool(corpus.bow),
                 queries_cls=corpus.queries_cls,
                 queries_bow=corpus.queries_bow,
                 query_lens=corpus.query_lens,
                 qrel_lens=qrel_lens, qrel_flat=qrel_flat)


def load_corpus(path: str) -> Corpus:
    z = verified_load(path)
    bow: list[np.ndarray] = []
    if bool(z["has_bow"]):
        splits = np.cumsum(z["doc_lens"])[:-1]
        bow = list(np.split(z["bow_flat"], splits))
    cuts = np.cumsum(z["qrel_lens"])[:-1]
    qrels = [set(int(i) for i in chunk)
             for chunk in np.split(z["qrel_flat"], cuts)]
    return Corpus(cls=z["cls"], bow=bow, doc_lens=z["doc_lens"],
                  queries_cls=z["queries_cls"], queries_bow=z["queries_bow"],
                  query_lens=z["query_lens"], qrels=qrels)
