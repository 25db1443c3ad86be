"""Disk-resident candidate generation (the paper's §7 roadmap: "take
inspiration from DiskANN/SPANN and offload the majority of the candidate
generation index to SSDs as well").

SPANN-style split: the centroids stay on the index's device (tiny); the
per-cell postings (doc id + fp16 CLS vector records) live block-aligned in a
host disk image, with an LRU hot-cell cache in DRAM (SPANN keeps frequently
probed list heads memory-resident). With ESPN's BOW offload, the resident
index drops to centroids + offsets.

Search = centroid scoring on the device (``probe_cells``: the ``ivf_scan``
kernel on CUDA) -> read the probed cells from the image (one batched
submission billed on the simulated clock; cache hits bill nothing) -> one
(m, d) x (d,) product over the gathered postings on the device -> top-k on
the host, the reference's ``argpartition`` then ``argsort``. The disk image,
the offsets, the cache and the bill are the reference's numpy, so blob,
``stats`` and ``sim_seconds`` equal the reference's exactly.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.ivf import IVFIndex, probe_cells
from repro_torch.storage import ssd as ssd_lib

NEG = -1e30


@dataclass
class DiskIVFIndex:
    centroids: torch.Tensor         # (ncells, d) fp32, on the device
    cell_offsets: np.ndarray        # (ncells, 2) start_block, n_blocks
    cell_sizes: np.ndarray          # (ncells,) true postings per cell
    blob: np.ndarray                # uint8 disk image of postings (host)
    d: int
    n_docs: int
    block: int = ssd_lib.DEFAULT_BLOCK
    spec: ssd_lib.StorageSpec = ssd_lib.PM983_PCIE3
    cache_cells: int = 0            # hot-cell LRU capacity (SPANN list heads)
    _cache: OrderedDict = field(default_factory=OrderedDict)
    stats: dict = field(default_factory=lambda: {
        "cells_read": 0, "cache_hits": 0, "blocks": 0, "sim_seconds": 0.0})

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    # -- memory accounting ---------------------------------------------------
    def memory_bytes(self) -> int:
        cached = self.cache_cells * (int(self.cell_sizes.mean()) + 1) \
            * (4 + self.d * 2)
        return (self.centroids.numel() * 4 + self.cell_offsets.nbytes
                + self.cell_sizes.nbytes + cached)

    # -- posting reads -------------------------------------------------------
    def _read_cell(self, c: int):
        """Returns (ids (m,), vecs (m, d) fp32, was_cached)."""
        if c in self._cache:
            self._cache.move_to_end(c)
            self.stats["cache_hits"] += 1
            return (*self._cache[c], True)
        start, _ = self.cell_offsets[c]
        m = int(self.cell_sizes[c])
        rec = 4 + self.d * 2
        raw = self.blob[start * self.block:start * self.block + m * rec]
        rows = raw.reshape(m, rec)
        ids = rows[:, :4].copy().view(np.int32)[:, 0]
        vecs = rows[:, 4:].copy().view(np.float16).astype(np.float32)
        if self.cache_cells:
            self._cache[c] = (ids, vecs)
            self._cache.move_to_end(c)
            while len(self._cache) > self.cache_cells:
                self._cache.popitem(last=False)
        return ids, vecs, False

    def read_cells(self, cells) -> tuple[np.ndarray, np.ndarray, float]:
        """Batched read of probed cells. Returns (ids, vecs, sim_seconds);
        only cache misses bill the SSD (one batched submission)."""
        ids_l, vecs_l, miss_blocks = [], [], 0
        for c in cells:
            ids, vecs, cached = self._read_cell(int(c))
            ids_l.append(ids)
            vecs_l.append(vecs)
            if not cached:
                miss_blocks += int(self.cell_offsets[int(c), 1])
            self.stats["cells_read"] += 1
        t = 0.0
        if miss_blocks:
            t = self.spec.read_time(miss_blocks, qd=64) \
                + ssd_lib.h2d_time(miss_blocks * self.block)
        self.stats["blocks"] += miss_blocks
        self.stats["sim_seconds"] += t
        return (np.concatenate(ids_l) if ids_l else np.zeros(0, np.int32),
                np.concatenate(vecs_l) if vecs_l
                else np.zeros((0, self.d), np.float32),
                t)


def build_disk_ivf(index: IVFIndex, *, spec=ssd_lib.PM983_PCIE3,
                   cache_cells: int = 0,
                   block: int = ssd_lib.DEFAULT_BLOCK) -> DiskIVFIndex:
    """Pack an in-memory ``IVFIndex``'s postings into a block-aligned host
    disk image (int8 cells dequantised through ``cell_scale`` before the
    fp16 cast). The centroids stay where the index keeps them."""
    ncells, d = index.centroids.shape
    cell_ids = index.cell_ids.cpu().numpy()
    vecs = index.cell_vecs.cpu().numpy().astype(np.float32)
    if index.cell_scale is not None:
        vecs = vecs * index.cell_scale.cpu().numpy()[..., None]
    rec = 4 + d * 2
    offsets = np.zeros((ncells, 2), np.int64)
    sizes = np.asarray(index.cell_sizes)
    n_blocks = (sizes.astype(np.int64) * rec + block - 1) // block
    starts = np.zeros(ncells, np.int64)
    np.cumsum(n_blocks[:-1], out=starts[1:])
    offsets[:, 0] = starts
    offsets[:, 1] = n_blocks
    blob = np.zeros(int(n_blocks.sum()) * block, np.uint8)
    for c in range(ncells):
        m = int(sizes[c])
        if m == 0:
            continue
        ids = cell_ids[c, :m].astype(np.int32)
        vv = vecs[c, :m].astype(np.float16)
        rows = np.zeros((m, rec), np.uint8)
        rows[:, :4] = ids[:, None].view(np.uint8).reshape(m, 4)
        rows[:, 4:] = vv.view(np.uint8).reshape(m, d * 2)
        s = starts[c] * block
        blob[s:s + m * rec] = rows.reshape(-1)
    return DiskIVFIndex(centroids=index.centroids, cell_offsets=offsets,
                        cell_sizes=sizes, blob=blob, d=d,
                        n_docs=index.n_docs, block=block, spec=spec,
                        cache_cells=cache_cells)


def search_disk(index: DiskIVFIndex, q: np.ndarray, nprobe: int, k: int):
    """Per-query disk-IVF search. q: (B, d). Returns numpy (scores (B, k),
    ids (B, k), io_s), unfilled slots ``NEG`` / -1.

    Each query's scores are one (m, d) x (d,) product on the index's
    device, a shape of its own, so a query's answer does not depend on the
    batch it came in."""
    dev = index.device
    qt = torch.as_tensor(np.asarray(q), dtype=torch.float32,
                         device=dev).contiguous()
    probe = probe_cells(index.centroids, qt, nprobe=nprobe).cpu().numpy()
    out_s, out_i, io_total = [], [], 0.0
    for b in range(qt.shape[0]):
        ids, vecs, io_s = index.read_cells(probe[b])
        io_total += io_s
        if len(ids) == 0:
            out_s.append(np.full(k, NEG, np.float32))
            out_i.append(np.full(k, -1, np.int32))
            continue
        s = (torch.from_numpy(vecs).to(dev) @ qt[b]).cpu().numpy()
        kk = min(k, len(ids))
        top = np.argpartition(-s, kk - 1)[:kk]
        order = top[np.argsort(-s[top])]
        sc = np.full(k, NEG, np.float32)
        ii = np.full(k, -1, np.int32)
        sc[:kk] = s[order]
        ii[:kk] = ids[order]
        out_s.append(sc)
        out_i.append(ii)
    return np.stack(out_s), np.stack(out_i), io_total
