"""Coalesced batch I/O: dedup'd, pipelined, async storage reads across a
query batch.

``BatchReadPlan`` takes the per-query candidate-id arrays for a whole batch,
deduplicates doc ids across queries, and orders the union by start block.
Each arena row (unique doc) gets a range of pool rows: its token rows,
clipped at ``t_max``, laid end to end in arena order, so every run of
arena rows is one contiguous range of pool rows.

``StorageTier.read_batch`` executes the plan: runs are staged as raw
stored-dtype rows into one host buffer on the tier's thread pool while the
caller reranks queries whose rows already arrived. ``ensure_query`` is the
synchronization point: it waits for a run's staging and then, on the
caller's thread, issues that run's one host->device copy into the batch's
``DeviceArena``. Each query sees the shared arena plus an id->row map; the
rerank packs its tiles there with ``kernels/gather_pack``.

The *clock* follows the same shape: the batch is billed ONE coalesced read
of the unique blocks at the tier's queue depth, deduplicated bytes are
billed once (``LatencyBreakdown.dedup_bytes_saved``), and per-query
attribution assigns each unique block to the first query that requested
it, so per-query shares sum exactly to the batch total.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.storage.faults import ReadFaultError


def _exclusive_cumsum(counts: np.ndarray) -> np.ndarray:
    out = np.zeros(len(counts), np.int64)
    np.cumsum(counts[:-1], out=out[1:])
    return out


@dataclass
class DeviceArena:
    """A batch's token rows on the tier's device, shared by every query of
    the batch: arena row ``u``'s token rows are
    ``pool[first[u]:first[u] + lens[u]]``. ``first``, ``lens`` and
    ``scales`` live beside ``pool``, so the rerank builds its row-index
    tables on the device."""
    pool: torch.Tensor              # (R, d_bow) stored dtype
    first: torch.Tensor             # (U,) int64 first pool row of each row
    lens: torch.Tensor              # (U,) int32 token counts, clipped at
                                    # t_max
    scales: torch.Tensor | None     # (U,) fp32 per-doc dequant scales
    t_max: int


def upload(arena: DeviceArena, staging: torch.Tensor, a: int,
           b: int) -> None:
    """Issue the host->device copy of staged pool rows ``[a, b)`` on the
    caller's stream. A host arena's pool IS its staging buffer: nothing to
    copy. A pinned buffer freed while its copy is in flight is not handed
    out again before the copy ends (PyTorch's pinned-memory allocator
    records the copy)."""
    if arena.pool is not staging and b > a:
        arena.pool[a:b].copy_(staging[a:b], non_blocking=True)


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
    arena_lens: np.ndarray             # (U,) int32 tokens, clipped at t_max
    arena_first: np.ndarray            # (U,) int64 first pool row (exclusive
                                       # cumsum of arena_lens)
    n_rows: int                        # pool rows of the whole arena
    runs: list[tuple[int, int]]        # [row0, row1) pipelined gather chunks
    query_rows: list[np.ndarray]       # per-query arena rows (list order)
    query_runs: list[np.ndarray]       # per-query run indices to wait on
    owned_blocks: np.ndarray           # (B,) blocks first-owned by each query
    n_unique: int
    n_requested: int
    n_blocks: int
    owner_rows: np.ndarray = field(repr=False, default=None)
                                       # (U,) first-owner query of each arena
                                       # row (the cluster re-attributes per
                                       # row when some rows are cache-served)
    span: object = field(repr=False, default=None, compare=False)
                                       # the planning step's trace span
    _sorted_ids: np.ndarray = field(repr=False, default=None)
    _sorted_rows: np.ndarray = field(repr=False, default=None)

    @classmethod
    def build(cls, layout, lists: list[np.ndarray], *, t_max: int,
              chunk_docs: int | None = None,
              with_query_runs: bool = True) -> "BatchReadPlan":
        """``with_query_runs=False`` skips the per-query run-index tables
        (the storage cluster schedules its own runs over the arena)."""
        lists = [np.asarray(x, np.int64).ravel() for x in lists]
        n_req = int(sum(len(x) for x in lists))
        if n_req == 0:
            return cls(lists=lists, arena_ids=np.empty(0, np.int64),
                       arena_blocks=np.empty(0, np.int64),
                       arena_lens=np.empty(0, np.int32),
                       arena_first=np.empty(0, np.int64), n_rows=0, runs=[],
                       query_rows=[np.empty(0, np.int64) for _ in lists],
                       query_runs=[np.empty(0, np.int64) for _ in lists],
                       owned_blocks=np.zeros(len(lists), np.int64),
                       n_unique=0, n_requested=0, n_blocks=0,
                       owner_rows=np.empty(0, np.int64),
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
        arena_lens = np.minimum(layout.n_tokens[arena_ids],
                                t_max).astype(np.int32)
        arena_first = _exclusive_cumsum(arena_lens.astype(np.int64))
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
                if with_query_runs and len(rows)
                else np.empty(0, np.int64))
        # first-owner attribution: each unique id's blocks are billed to the
        # first query that requested it; later requesters ride for free
        bounds_q = _exclusive_cumsum(
            np.array([len(x) for x in lists], np.int64))
        owner = np.searchsorted(bounds_q, first_idx, side="right") - 1
        owned = np.zeros(len(lists), np.int64)
        np.add.at(owned, owner, offs[:, 1])
        return cls(lists=lists, arena_ids=arena_ids,
                   arena_blocks=arena_blocks, arena_lens=arena_lens,
                   arena_first=arena_first,
                   n_rows=int(arena_lens.sum(dtype=np.int64)), runs=runs,
                   query_rows=query_rows, query_runs=query_runs,
                   owned_blocks=owned, n_unique=u, n_requested=n_req,
                   n_blocks=int(arena_blocks.sum()),
                   owner_rows=owner[order],
                   _sorted_ids=uids, _sorted_rows=sorted_rows)

    def pool_range(self, r0: int, r1: int) -> tuple[int, int]:
        """The pool rows ``[a, b)`` that arena rows ``r0..r1`` occupy."""
        end = (int(self.arena_first[r1]) if r1 < len(self.arena_first)
               else self.n_rows)
        return (int(self.arena_first[r0]) if r0 < r1 else end), end

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

    ``coalesced=True``: one dedup'd read, runs possibly still staging —
    call ``ensure_query(b)`` before touching query ``b``'s rows.
    ``coalesced=False``: the serial path — B blocking per-query
    ``tier.read`` calls, each billed separately, each with its own arena.
    """

    def __init__(self, *, coalesced: bool, plan: BatchReadPlan | None,
                 sim_seconds: float, n_blocks: int,
                 arena: DeviceArena | None = None,
                 staging: torch.Tensor | None = None,
                 futures: list | None = None,
                 serial_reads: list | None = None,
                 failed_queries=None):
        self.coalesced = coalesced
        self.plan = plan
        self.sim_seconds = sim_seconds
        self.n_blocks = n_blocks
        self.arena = arena                      # shared DeviceArena
        self._staging = staging                 # host rows behind the arena
        self._futures = futures or []
        self._landed = [False] * len(self._futures)
        self._serial_reads = serial_reads       # list[ReadResult | None]
        self._failed_queries = failed_queries   # (B,) bool | None: queries
                                                # whose read exhausted the
                                                # fault retry budget
        self.span = None                        # the read's trace span (set
                                                # by a traced tier)
        self.tracer = None                      # a traced tier's Tracer:
                                                # waits on staging are timed

    # -- fault surface -------------------------------------------------------
    def query_failed(self, b: int) -> bool:
        """True when query ``b``'s storage read failed: it has no rows and
        must not be scored. Backends answer such queries from resident
        scores (``degraded``) or fail them."""
        if self._failed_queries is None:
            return False
        return bool(self._failed_queries[b])

    def rows_failed(self, rows) -> bool:
        """Whether any of the given arena rows came from a failed read. A
        single tier's arena is all or nothing per query (a failed coalesced
        read fails every query), so this is never the case."""
        return False

    @property
    def any_failed(self) -> bool:
        return self._failed_queries is not None \
            and bool(np.any(self._failed_queries))

    # -- sizes ---------------------------------------------------------------
    @property
    def n_queries(self) -> int:
        return len(self.plan.lists) if self.plan is not None \
            else len(self._serial_reads)

    @property
    def unique_docs(self) -> int:
        return self.plan.n_unique if self.coalesced else self.requested_docs

    @property
    def requested_docs(self) -> int:
        if self.plan is not None:
            return self.plan.n_requested
        return sum(len(r.arena.lens) for r in self._serial_reads
                   if r is not None)

    # -- synchronization -----------------------------------------------------
    def _run_rows(self, ri: int) -> tuple[int, int]:
        """The pool rows ``[a, b)`` run ``ri`` stages."""
        return self.plan.pool_range(*self.plan.runs[ri])

    def _land(self, runs) -> None:
        """Wait for each of ``runs``' staging, then issue its one
        host->device copy (on the caller's thread: the staging threads
        touch no CUDA). With a tracer, the runs not landed yet are waited
        on and copied under one ``io_wait`` span (their count and bytes)."""
        todo = [int(ri) for ri in runs if not self._landed[ri]]
        if not todo:
            return
        tr = self.tracer
        sp = tr.begin("io_wait", cat="host") if tr is not None else None
        for ri in todo:
            self._futures[ri].result()
            upload(self.arena, self._staging, *self._run_rows(ri))
            self._landed[ri] = True
        if tr is not None:
            rows = sum(b - a for a, b in map(self._run_rows, todo))
            tr.end(sp, n_runs=len(todo), bytes=rows
                   * self._staging.shape[1] * self._staging.element_size())

    def ensure_query(self, b: int) -> None:
        """Block until every run holding query ``b``'s rows has landed."""
        if not self.coalesced:
            return
        if self.query_failed(b):
            raise RuntimeError(f"query {b}'s read failed: it has no rows")
        self._land(self.plan.query_runs[b])

    def ensure_rows(self, rows) -> None:
        """Block until the runs covering arbitrary arena ``rows`` have
        landed — the barrier for rows a query borrows from OTHER queries'
        requests (a miss served from the batch's prefetch arena)."""
        rows = np.asarray(rows, np.int64)
        if not self.coalesced or len(rows) == 0:
            return
        run_starts = np.array([r0 for r0, _ in self.plan.runs], np.int64)
        self._land(np.unique(np.searchsorted(run_starts, rows,
                                             side="right") - 1))

    def wait_all(self) -> None:
        """Block until every run has been staged and copied to the arena's
        device."""
        self._land(range(len(self._futures)))

    # -- per-query views -----------------------------------------------------
    def view(self, b: int) -> tuple[DeviceArena | None, dict, float]:
        """(arena, id->row map, attributed io seconds) for query ``b``.

        The arena is the batch's SHARED one. Serial mode hands back that
        query's own read arena with a positional map.
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
        return (read.arena,
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
    billed per requesting query (``skip_empty`` skips zero-id queries). A
    query whose read exhausts the fault retry budget is marked failed, not
    raised: the other queries of the batch still complete."""
    reads, failed = [], np.zeros(len(lists), bool)
    for b, ids in enumerate(lists):
        if skip_empty and len(ids) == 0:
            reads.append(None)
            continue
        try:
            reads.append(read_fn(ids))
        except ReadFaultError:
            reads.append(None)
            failed[b] = True
    plan = BatchReadPlan(
        lists=lists, arena_ids=np.empty(0, np.int64),
        arena_blocks=np.empty(0, np.int64), arena_lens=np.empty(0, np.int32),
        arena_first=np.empty(0, np.int64), n_rows=0, runs=[],
        query_rows=[np.empty(0, np.int64) for _ in lists],
        query_runs=[np.empty(0, np.int64) for _ in lists],
        owned_blocks=np.zeros(len(lists), np.int64), n_unique=0,
        n_requested=int(sum(len(x) for x in lists)), n_blocks=0)
    return BatchReadResult(
        coalesced=False, plan=plan,
        sim_seconds=sum(r.sim_seconds for r in reads if r),
        n_blocks=sum(r.n_blocks for r in reads if r),
        serial_reads=reads,
        failed_queries=failed if failed.any() else None)


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
