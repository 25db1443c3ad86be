"""ESPN-for-RecSys: the paper's storage-offload + prefetch mechanism applied
to sparse embedding tables (beyond the paper; mirrors RecSSD, which ESPN
cites). Host numpy over the simulated storage clock of ``storage/ssd.py``,
the same model and constants as the reference package's, so both bill a
fetch identically.

The big embedding table (10^6-10^9 rows x 16-128 dims) moves to the storage
tier, packed multiple rows per 4K block. Online inference knows the candidate
items only after first-stage retrieval — exactly ESPN's structure — so the
server prefetches candidate-item rows DURING the query-tower forward pass
(the compute that plays the role of ESPN's λ remaining probes) and fetches
only the re-ranker's misses in the critical path.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.storage import ssd as ssd_lib


@dataclass
class EmbeddingBlockStore:
    """Row-blocked table image: rows_per_block rows per 4K block."""
    table: np.ndarray             # (R, D) stored dtype (fp16 default)
    block: int = ssd_lib.DEFAULT_BLOCK

    def __post_init__(self):
        elt = self.table.dtype.itemsize
        self.rows_per_block = max(1, self.block // (self.table.shape[1] * elt))

    @property
    def nbytes(self) -> int:
        return self.table.nbytes

    def blocks_for(self, rows: np.ndarray) -> int:
        return len(np.unique(np.asarray(rows) // self.rows_per_block))

    def gather(self, rows: np.ndarray) -> np.ndarray:
        return self.table[np.asarray(rows)].astype(np.float32)


@dataclass
class EmbeddingFetchStats:
    hit_rate: float
    prefetch_io_s: float
    critical_io_s: float
    hidden_s: float
    blocks: int


class ESPNEmbeddingServer:
    """Serve embedding lookups from storage with candidate-driven prefetch."""

    def __init__(self, store: EmbeddingBlockStore, *,
                 spec: ssd_lib.StorageSpec = ssd_lib.PM983_PCIE3,
                 qd: int = 64):
        self.store = store
        self.spec = spec
        self.qd = qd

    def _io_time(self, rows) -> tuple[float, int]:
        if len(rows) == 0:
            return 0.0, 0
        nb = self.store.blocks_for(rows)
        t = self.spec.read_time(nb, qd=self.qd) \
            + ssd_lib.h2d_time(nb * self.store.block)
        return t, nb

    def fetch(self, approx_rows: np.ndarray, final_rows: np.ndarray,
              overlap_budget_s: float) -> tuple[np.ndarray, EmbeddingFetchStats]:
        """approx_rows: candidate ids known early (prefetch list);
        final_rows: ids actually needed; overlap_budget_s: compute time the
        prefetch hides behind (e.g. the query-tower forward)."""
        approx_rows = np.unique(np.asarray(approx_rows))
        final_rows = np.asarray(final_rows)
        pref = set(approx_rows.tolist())
        hit = np.fromiter((r in pref for r in final_rows), bool,
                          len(final_rows))
        t_pref, nb1 = self._io_time(approx_rows)
        t_miss, nb2 = self._io_time(final_rows[~hit])
        leaked = max(0.0, t_pref - overlap_budget_s)
        stats = EmbeddingFetchStats(
            hit_rate=float(hit.mean()) if len(final_rows) else 1.0,
            prefetch_io_s=t_pref,
            critical_io_s=leaked + t_miss,
            hidden_s=min(t_pref, overlap_budget_s),
            blocks=nb1 + nb2)
        return self.store.gather(final_rows), stats

    def fetch_direct(self, rows: np.ndarray) -> tuple[np.ndarray,
                                                      EmbeddingFetchStats]:
        """No prefetch: the whole lookup sits in the critical path."""
        t, nb = self._io_time(np.unique(rows))
        return self.store.gather(rows), EmbeddingFetchStats(
            hit_rate=0.0, prefetch_io_s=0.0, critical_io_s=t, hidden_s=0.0,
            blocks=nb)
