"""StorageTier: serves document embeddings through a device model + software
stack. The GDS-analogue path ("espn") issues batched block reads at high
queue depth; "mmap"/"swap" model the conventional O/S paths the paper
compares against; "dram" is the all-in-memory upper bound.

Data movement is real: the tier's threads stage the stored token rows of
each run from the disk-image blob into one host buffer per read (pinned
when the tier's device is CUDA), and the caller's thread copies each run to
the device once (``BatchReadResult.ensure_query``); the *clock* is the
model in storage/ssd.py. Every read returns its simulated duration so the
pipeline can account overlap exactly like the paper's prefetch-budget math.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.fde import FDETable
from repro_torch.storage import ssd as ssd_lib
from repro_torch.storage.batch_io import (BatchReadPlan, BatchReadResult,
                                          DeviceArena, _exclusive_cumsum,
                                          serial_batch, upload)
from repro_torch.storage.cache import PageCache
from repro_torch.storage.layout import BitTable, EmbeddingLayout, stage_rows

STACKS = ("espn", "mmap", "swap", "dram")


@dataclass
class ReadResult:
    arena: DeviceArena        # the read's token rows, row j = ids[j]
    sim_seconds: float        # modeled device+software time
    n_blocks: int


class StorageTier:
    def __init__(self, layout: EmbeddingLayout, *,
                 spec: ssd_lib.StorageSpec = ssd_lib.PM983_PCIE3,
                 stack: str = "espn", mem_budget_bytes: int | None = None,
                 t_max: int = 180, qd: int = 64, include_h2d: bool = True,
                 n_io_threads: int = 4, bits: BitTable | None = None,
                 fde: FDETable | None = None, coalesce: bool = True,
                 io_chunk_docs: int | None = None,
                 device: str | torch.device = "cuda"):
        if stack not in STACKS:
            raise ValueError(f"unknown storage stack {stack!r}; "
                             f"expected one of {STACKS}")
        self.layout = layout
        self.bits = bits              # resident sign-bit tier (bit filter)
        self.fde = fde                # resident FDE tier (fde candidate gen)
        self._closed = False
        self.spec = spec
        self.stack = stack
        self.t_max = t_max
        self.qd = qd
        self.include_h2d = include_h2d
        self.coalesce = coalesce      # read_batch default: coalesced vs serial
        self.io_chunk_docs = io_chunk_docs   # pipelining granularity (docs/run)
        self.device = torch.device(device)   # where read arenas live
        self._pool = ThreadPoolExecutor(max_workers=n_io_threads,
                                        thread_name_prefix="espn-io")
        self._lock = threading.Lock()
        budget = mem_budget_bytes if mem_budget_bytes is not None else 0
        self.page_cache = PageCache(budget, layout.block)
        if stack == "swap":
            self.swap_capacity = (mem_budget_bytes or 0) + 32 * 2**30
        self.stats = {"reads": 0, "docs": 0, "doc_requests": 0, "blocks": 0,
                      "sim_seconds": 0.0, "batch_reads": 0, "io_runs": 0,
                      "dedup_docs": 0}

    # -- timing ------------------------------------------------------------
    def _pages_of(self, ids) -> np.ndarray:
        """Pages (device blocks) touched by ``ids``, vectorized."""
        offs = self.layout.offsets[np.asarray(ids, np.int64).ravel()]
        starts, counts = offs[:, 0], offs[:, 1]
        total = int(counts.sum())
        if total == 0:
            return np.empty(0, np.int64)
        base = np.repeat(starts - _exclusive_cumsum(counts), counts)
        return base + np.arange(total, dtype=np.int64)

    def _sim_time(self, ids) -> tuple[float, int]:
        n_blocks = self.layout.blocks_for(ids)
        bytes_moved = n_blocks * self.layout.block
        if self.stack == "dram":
            t = ssd_lib.DRAM.read_time(n_blocks, qd=self.qd)
        elif self.stack == "espn":
            t = self.spec.read_time(n_blocks, qd=self.qd)
        else:
            pages = self._pages_of(ids)
            with self._lock:
                h, m = self.page_cache.access_many(pages)
            hr = h / max(1, h + m)
            if self.stack == "mmap":
                t = ssd_lib.mmap_read_time(self.spec, len(pages), hr)
            else:
                if self.layout.nbytes > self.swap_capacity:
                    raise MemoryError("OOM: index exceeds memory + swap space")
                t = ssd_lib.swap_read_time(self.spec, len(pages), hr)
        if self.include_h2d and self.stack != "dram":
            t += ssd_lib.h2d_time(bytes_moved)
        return t, n_blocks

    # -- reads ---------------------------------------------------------------
    def _arena(self, ids: np.ndarray, lens: np.ndarray, t_max: int):
        """The arena of a read of ``ids`` (``lens`` token rows each) on the
        tier's device, and the host buffer its rows are staged in (pinned on
        CUDA; on the CPU the two are one tensor). Called on the caller's
        thread."""
        dtype = torch.from_numpy(np.empty(0, self.layout.dtype)).dtype
        on_card = self.device.type == "cuda"
        staging = torch.empty((int(lens.sum(dtype=np.int64)),
                               self.layout.d_bow), dtype=dtype,
                              pin_memory=on_card)
        pool = (torch.empty_like(staging, device=self.device) if on_card
                else staging)
        scales = self.layout.scales
        arena = DeviceArena(
            pool=pool, first=torch.as_tensor(
                _exclusive_cumsum(lens.astype(np.int64)), device=self.device),
            lens=torch.as_tensor(lens, device=self.device),
            scales=(torch.as_tensor(np.asarray(scales[ids], np.float32),
                                    device=self.device)
                    if scales is not None else None),
            t_max=t_max)
        return arena, staging

    def read(self, ids, t_max: int | None = None) -> ReadResult:
        """One blocking read of ``ids``: staged on the caller's thread and
        copied to the tier's device."""
        ids = np.asarray(ids, np.int64)
        t_max = t_max or self.t_max
        sim, n_blocks = self._sim_time(ids)
        lens = np.minimum(self.layout.n_tokens[ids], t_max).astype(np.int32)
        arena, staging = self._arena(ids, lens, t_max)
        stage_rows(self.layout, ids, t_max, staging.numpy())
        upload(arena, staging, 0, len(staging))
        with self._lock:
            self.stats["reads"] += 1
            self.stats["docs"] += len(ids)
            self.stats["doc_requests"] += len(ids)
            self.stats["blocks"] += n_blocks
            self.stats["sim_seconds"] += sim
        return ReadResult(arena, sim, n_blocks)

    def read_batch(self, per_query_ids, t_max: int | None = None, *,
                   coalesce: bool | None = None,
                   skip_empty: bool = False) -> BatchReadResult:
        """One storage transaction for a whole query batch.

        Coalesced (the default, ``self.coalesce``): doc ids are dedup'd
        across queries, runs are staged concurrently on the tier's thread
        pool into one host buffer (call ``ensure_query(b)`` before
        consuming query ``b``'s rows: it also issues the runs' copies to
        the device), and the clock bills ONE read of the unique blocks at
        this tier's queue depth.

        ``coalesce=False``: one blocking ``read`` per query, duplicates
        billed per requesting query (``skip_empty`` skips zero-id queries).
        """
        t_max = t_max or self.t_max
        coalesce = self.coalesce if coalesce is None else coalesce
        lists = [np.asarray(x, np.int64).ravel() for x in per_query_ids]
        if not coalesce:
            return serial_batch(lambda ids: self.read(ids, t_max), lists,
                                skip_empty)
        plan = BatchReadPlan.build(self.layout, lists, t_max=t_max,
                                   chunk_docs=self.io_chunk_docs)
        u = plan.n_unique
        arena, staging = self._arena(plan.arena_ids, plan.arena_lens, t_max)
        if u == 0:
            return BatchReadResult(coalesced=True, plan=plan,
                                   sim_seconds=0.0, n_blocks=0, arena=arena,
                                   staging=staging)
        sim, n_blocks = self._sim_time(plan.arena_ids)
        rows = staging.numpy()
        futures = [self._pool.submit(
            stage_rows, self.layout, plan.arena_ids[r0:r1], t_max,
            rows[slice(*plan.pool_range(r0, r1))]) for r0, r1 in plan.runs]
        with self._lock:
            self.stats["reads"] += 1
            self.stats["batch_reads"] += 1
            self.stats["io_runs"] += len(plan.runs)
            self.stats["docs"] += u
            self.stats["doc_requests"] += plan.n_requested
            self.stats["dedup_docs"] += plan.n_requested - u
            self.stats["blocks"] += n_blocks
            self.stats["sim_seconds"] += sim
        return BatchReadResult(coalesced=True, plan=plan, sim_seconds=sim,
                               n_blocks=n_blocks, arena=arena,
                               staging=staging, futures=futures)

    def read_bits(self, ids, t_max: int | None = None):
        """Gather packed sign bits for ``ids`` from the *resident* bit tier:
        no SSD blocks, no simulated device time (the read is a memory
        access)."""
        if self.bits is None:
            raise RuntimeError(
                "this StorageTier was built without a resident BitTable; "
                "construct it with bits=pack_bits(...)")
        return self.bits.gather(ids, t_max or self.t_max)

    # -- reporting -----------------------------------------------------------
    def memory_resident_bytes(self) -> int:
        """Host/device memory this tier requires (ESPN: offsets only, plus
        any resident side tables)."""
        meta = self.layout.meta_nbytes
        if self.bits is not None:
            meta += self.bits.nbytes
        if self.fde is not None:
            meta += self.fde.nbytes
        if self.stack == "dram":
            return self.layout.nbytes + meta
        if self.stack in ("mmap", "swap"):
            return self.page_cache.capacity_pages * self.layout.block + meta
        return meta

    def close(self):
        """Idempotent shutdown: pending reads are cancelled rather than
        abandoned; in-flight reads finish."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._pool.shutdown(wait=False, cancel_futures=True)
