"""Cross-batch arena cache: a memory-budgeted LRU over gathered doc rows.

The batch I/O engine already dedups doc ids *within* one query batch, but
consecutive batches of a serving workload re-request the same hot documents
(head queries, trending docs) and each batch pays the SSD clock again. This
cache keeps recently gathered rows keyed by doc id under a byte budget, like
``PageCache`` but at doc granularity so a hit serves a whole rerank row
without touching the device.

An entry is what the port's arena holds for a doc: its stored-dtype token
rows (clipped at the ``t_max`` they were read under), its dequant scale
(``None`` for a layout stored without scales) and its token count. The
budget is charged at the reference's row size, the fp32 CLS vector plus the
fp32 token rows (``d_cls`` is the layout's), so the same traffic evicts the
same entries in both packages and the simulated clocks stay equal.

``StorageCluster.read_batch`` consults it before planning: cached rows are
copied into the batch's host staging buffer synchronously (a memory access,
like ``read_bits``: no simulated device time) and only the remainder goes
to the shards. Insertion happens on the coordinating thread in arena-row
order once the batch's gathers land: deterministic LRU recency, so same-seed
runs evict identically and reproduce identical simulated clocks.

The lock keeps the structure safe anyway (probes may come from serving
threads while another batch inserts).
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np


class ArenaCache:
    def __init__(self, capacity_bytes: int, *, d_cls: int = 0):
        self.capacity_bytes = max(0, int(capacity_bytes))
        self.d_cls = int(d_cls)
        # id -> (rows, scale, t, charged bytes)
        self._lru: OrderedDict[int, tuple] = OrderedDict()
        self._lock = threading.Lock()
        self.bytes_used = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.insertions = 0

    @property
    def enabled(self) -> bool:
        return self.capacity_bytes > 0

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        """Point-in-time counter snapshot (a ``MetricsRegistry`` source)."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "insertions": self.insertions,
                    "bytes_used": self.bytes_used,
                    "entries": len(self._lru),
                    "capacity_bytes": self.capacity_bytes,
                    "hit_rate": round(self.hit_rate, 6)}

    # -- lookup --------------------------------------------------------------
    def get(self, doc_id: int, t_need: int):
        """Return the cached ``(rows, scale, t)`` for ``doc_id`` if the
        stored row covers at least ``t_need`` tokens (a row gathered under a
        smaller ``t_max`` cannot serve a wider read), else None. Counts
        hit/miss."""
        with self._lock:
            ent = self._lru.get(int(doc_id))
            if ent is not None and ent[2] >= t_need:
                self._lru.move_to_end(int(doc_id))
                self.hits += 1
                return ent[:3]
            self.misses += 1
            return None

    def get_many(self, doc_ids, t_needs) -> list:
        """Bulk probe under ONE lock acquisition (the per-batch hot path):
        returns the cached entry or None per id, with the same coverage rule
        and hit/miss accounting as ``get``."""
        out = []
        with self._lock:
            for i, t in zip(doc_ids, t_needs):
                ent = self._lru.get(int(i))
                if ent is not None and ent[2] >= t:
                    self._lru.move_to_end(int(i))
                    self.hits += 1
                    out.append(ent[:3])
                else:
                    self.misses += 1
                    out.append(None)
        return out

    # -- insert --------------------------------------------------------------
    def put(self, doc_id: int, rows: np.ndarray, t: int,
            scale: float | None = None) -> None:
        """Insert a gathered row: its first ``t`` token rows (copied: the
        staging buffers are batch-owned) and its scale. Evicts LRU entries
        past the byte budget."""
        if not self.enabled:
            return
        rows_c = np.array(rows[:t], copy=True)
        # charged as the reference's fp32 CLS + fp32 token rows
        nbytes = 4 * (self.d_cls + rows_c.size)
        if nbytes > self.capacity_bytes:
            return
        with self._lock:
            old = self._lru.pop(int(doc_id), None)
            if old is not None:
                self.bytes_used -= old[3]
            self._lru[int(doc_id)] = (rows_c, scale, int(t), nbytes)
            self.bytes_used += nbytes
            self.insertions += 1
            while self.bytes_used > self.capacity_bytes and self._lru:
                _, old = self._lru.popitem(last=False)
                self.bytes_used -= old[3]
                self.evictions += 1

    def remove(self, doc_ids) -> int:
        """Invalidate cached rows (deleted docs must never be served from
        memory again), giving back exactly what each insert charged. Returns
        how many entries were dropped."""
        dropped = 0
        with self._lock:
            for i in doc_ids:
                ent = self._lru.pop(int(i), None)
                if ent is not None:
                    self.bytes_used -= ent[3]
                    dropped += 1
        return dropped

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self.bytes_used = 0
