"""Coalesced batch I/O: dedup'd, pipelined, async storage reads across a
query batch.

``BatchReadPlan`` takes the per-query candidate-id arrays for a whole batch,
deduplicates doc ids across queries, and orders the union by start block.
``StorageTier.read_batch`` executes the plan: runs are submitted to the
tier's thread pool and gathered concurrently into one shared buffer arena
while the caller reranks queries whose rows already arrived
(``ensure_query`` is the synchronization point). Each query sees a
zero-copy view: the arena arrays plus an id->row map.

The *clock* follows the same shape: the batch is billed ONE coalesced read
of the unique blocks at the tier's queue depth, deduplicated bytes are
billed once (``LatencyBreakdown.dedup_bytes_saved``), and per-query
attribution assigns each unique block to the first query that requested
it, so per-query shares sum exactly to the batch total.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _exclusive_cumsum(counts: np.ndarray) -> np.ndarray:
    out = np.zeros(len(counts), np.int64)
    np.cumsum(counts[:-1], out=out[1:])
    return out


def run_chunk(n_docs: int, chunk_docs: int | None = None) -> int:
    """Pipelining granularity for gather runs: explicit override, else equal
    chunks targeting ~16 runs with a 32-doc floor."""
    return int(chunk_docs) if chunk_docs else max(32, -(-n_docs // 16))


@dataclass
class BatchReadPlan:
    """Dedup + coalesce schedule for one batch of per-query id lists.

    Pure planning (no I/O): everything is derived from the layout's offsets
    table with vectorized numpy.
    """
    lists: list[np.ndarray]            # per-query requested ids (as given)
    arena_ids: np.ndarray              # (U,) unique ids in arena (block) order
    arena_blocks: np.ndarray           # (U,) n_blocks per arena row
    runs: list[tuple[int, int]]        # [row0, row1) pipelined gather chunks
    query_rows: list[np.ndarray]       # per-query arena rows (list order)
    query_runs: list[np.ndarray]       # per-query run indices to wait on
    owned_blocks: np.ndarray           # (B,) blocks first-owned by each query
    n_unique: int
    n_requested: int
    n_blocks: int
    _sorted_ids: np.ndarray = field(repr=False, default=None)
    _sorted_rows: np.ndarray = field(repr=False, default=None)

    @classmethod
    def build(cls, layout, lists: list[np.ndarray], *,
              chunk_docs: int | None = None) -> "BatchReadPlan":
        lists = [np.asarray(x, np.int64).ravel() for x in lists]
        n_req = int(sum(len(x) for x in lists))
        if n_req == 0:
            return cls(lists=lists, arena_ids=np.empty(0, np.int64),
                       arena_blocks=np.empty(0, np.int64), runs=[],
                       query_rows=[np.empty(0, np.int64) for _ in lists],
                       query_runs=[np.empty(0, np.int64) for _ in lists],
                       owned_blocks=np.zeros(len(lists), np.int64),
                       n_unique=0, n_requested=0, n_blocks=0,
                       _sorted_ids=np.empty(0, np.int64),
                       _sorted_rows=np.empty(0, np.int64))
        concat = np.concatenate(lists)
        uids, first_idx = np.unique(concat, return_index=True)
        u = len(uids)
        # arena order: sort the union by start block so adjacent docs merge
        # into sequential runs (the device's favourite pattern)
        offs = layout.offsets[uids]
        order = np.argsort(offs[:, 0], kind="stable")
        arena_ids = uids[order]
        arena_blocks = offs[order, 1]
        # sorted-unique position -> arena row (uids ascending already)
        sorted_rows = np.empty(u, np.int64)
        sorted_rows[order] = np.arange(u)
        chunk = run_chunk(u, chunk_docs)
        runs = [(r0, min(r0 + chunk, u)) for r0 in range(0, u, chunk)]
        run_starts = np.array([r0 for r0, _ in runs], np.int64)
        query_rows, query_runs = [], []
        for q_ids in lists:
            rows = sorted_rows[np.searchsorted(uids, q_ids)] if len(q_ids) \
                else np.empty(0, np.int64)
            query_rows.append(rows)
            query_runs.append(np.unique(
                np.searchsorted(run_starts, rows, side="right") - 1)
                if len(rows) else np.empty(0, np.int64))
        # first-owner attribution: each unique id's blocks are billed to the
        # first query that requested it; later requesters ride for free
        bounds_q = _exclusive_cumsum(
            np.array([len(x) for x in lists], np.int64))
        owner = np.searchsorted(bounds_q, first_idx, side="right") - 1
        owned = np.zeros(len(lists), np.int64)
        np.add.at(owned, owner, offs[:, 1])
        return cls(lists=lists, arena_ids=arena_ids,
                   arena_blocks=arena_blocks, runs=runs,
                   query_rows=query_rows, query_runs=query_runs,
                   owned_blocks=owned, n_unique=u, n_requested=n_req,
                   n_blocks=int(arena_blocks.sum()),
                   _sorted_ids=uids, _sorted_rows=sorted_rows)

    def contains(self, ids) -> np.ndarray:
        """Boolean mask: which of ``ids`` live in the arena."""
        ids = np.asarray(ids, np.int64)
        if self.n_unique == 0 or len(ids) == 0:
            return np.zeros(len(ids), bool)
        return np.isin(ids, self._sorted_ids, assume_unique=False)

    def rows_of(self, ids) -> np.ndarray:
        """Arena rows of ``ids`` (caller guarantees membership)."""
        ids = np.asarray(ids, np.int64)
        return self._sorted_rows[np.searchsorted(self._sorted_ids, ids)]


class BatchReadResult:
    """Executed (or executing) batch read: shared arena + per-query views.

    ``coalesced=True``: one dedup'd read, runs possibly still in flight —
    call ``ensure_query(b)`` before touching query ``b``'s rows.
    ``coalesced=False``: the serial path — B blocking per-query
    ``tier.read`` calls, each billed separately.
    """

    def __init__(self, *, coalesced: bool, plan: BatchReadPlan | None,
                 sim_seconds: float, n_blocks: int,
                 arena: tuple | None = None, futures: list | None = None,
                 serial_reads: list | None = None):
        self.coalesced = coalesced
        self.plan = plan
        self.sim_seconds = sim_seconds
        self.n_blocks = n_blocks
        self.arena = arena                      # (cls, bow, lens) shared
        self._futures = futures or []
        self._serial_reads = serial_reads       # list[ReadResult | None]

    # -- fault surface (the fault layer is not ported: no read fails) --------
    def query_failed(self, b: int) -> bool:
        return False

    def rows_failed(self, rows) -> bool:
        return False

    # -- synchronization -----------------------------------------------------
    def ensure_query(self, b: int) -> None:
        """Block until every run holding query ``b``'s rows has landed."""
        if not self.coalesced:
            return
        for ri in self.plan.query_runs[b]:
            self._futures[int(ri)].result()

    def ensure_rows(self, rows) -> None:
        """Block until the runs covering arbitrary arena ``rows`` have
        landed — the barrier for rows a query borrows from OTHER queries'
        requests (a miss served from the batch's prefetch arena)."""
        rows = np.asarray(rows, np.int64)
        if not self.coalesced or len(rows) == 0:
            return
        run_starts = np.array([r0 for r0, _ in self.plan.runs], np.int64)
        for ri in np.unique(np.searchsorted(run_starts, rows,
                                            side="right") - 1):
            self._futures[int(ri)].result()

    # -- per-query views -----------------------------------------------------
    def view(self, b: int) -> tuple[tuple | None, dict, float]:
        """(buffers, id->row map, attributed io seconds) for query ``b``.

        ``buffers`` are the SHARED arena arrays (zero-copy). Serial mode
        hands back that query's own read buffers with a positional map.
        """
        if self.coalesced:
            rows = self.plan.query_rows[b]
            ids = self.plan.lists[b]
            return (self.arena,
                    dict(zip(ids.tolist(), rows.tolist())),
                    self.io_s(b))
        read = self._serial_reads[b]
        if read is None:
            return None, {}, 0.0
        ids = self.plan.lists[b]
        return ((read.cls, read.bow, read.lens),
                {int(i): j for j, i in enumerate(ids)},
                read.sim_seconds)

    def io_s(self, b: int) -> float:
        """Query ``b``'s share of the batch clock (first-owner attribution:
        shares sum exactly to ``sim_seconds``)."""
        if not self.coalesced:
            read = self._serial_reads[b]
            return read.sim_seconds if read is not None else 0.0
        if self.plan.n_blocks == 0:
            return 0.0
        return self.sim_seconds * (
            float(self.plan.owned_blocks[b]) / float(self.plan.n_blocks))

    def dedup_bytes_saved(self, doc_bytes) -> int:
        """Bytes the batch did NOT move because duplicate requests were
        billed once (0 in serial mode, which billed every duplicate)."""
        if not self.coalesced:
            return 0
        return consumption_dedup_saved(self.plan.lists, doc_bytes)


def serial_batch(read_fn, lists: list[np.ndarray],
                 skip_empty: bool = False) -> BatchReadResult:
    """The serial path: one blocking ``read_fn(ids)`` per query, duplicates
    billed per requesting query (``skip_empty`` skips zero-id queries)."""
    reads = [None if skip_empty and len(ids) == 0 else read_fn(ids)
             for ids in lists]
    plan = BatchReadPlan(
        lists=lists, arena_ids=np.empty(0, np.int64),
        arena_blocks=np.empty(0, np.int64), runs=[],
        query_rows=[np.empty(0, np.int64) for _ in lists],
        query_runs=[np.empty(0, np.int64) for _ in lists],
        owned_blocks=np.zeros(len(lists), np.int64), n_unique=0,
        n_requested=int(sum(len(x) for x in lists)), n_blocks=0)
    return BatchReadResult(
        coalesced=False, plan=plan,
        sim_seconds=sum(r.sim_seconds for r in reads if r),
        n_blocks=sum(r.n_blocks for r in reads if r),
        serial_reads=reads)


def consumption_dedup_saved(id_lists, doc_bytes) -> int:
    """Bytes saved by billing each doc consumed by >1 request once.

    ``id_lists``: per-query consumed-id arrays; ``doc_bytes``: id -> bytes.
    """
    lists = [np.asarray(x, np.int64).ravel() for x in id_lists]
    if not lists or not sum(len(x) for x in lists):
        return 0
    uids, counts = np.unique(np.concatenate(lists), return_counts=True)
    dup = counts > 1
    if not dup.any():
        return 0
    return int(sum(int(c - 1) * int(doc_bytes(int(i)))
                   for i, c in zip(uids[dup], counts[dup])))
