"""Step-indexed host data pipeline with a rank's share of each batch.

Fault-tolerance contract: the batch for step i is a pure function of
(seed, i), so restart-from-checkpoint replays identically on any number of
ranks. Each rank materializes only its slice of the global batch (the
``torch.distributed`` world size and rank; 1 and 0 without a process
group) and hands it over as tensors on the pipeline's device; a background
thread keeps ``prefetch`` batches ready.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


@dataclass
class PipelineConfig:
    global_batch: int
    seed: int = 0
    prefetch: int = 2


def world() -> tuple[int, int]:
    """(world size, rank) of the default process group, (1, 0) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ShardedPipeline:
    """generator_fn(rng, indices) -> dict of np arrays for those examples.

    ``indices`` are the global example ids for the step; each rank computes
    only its slice. On a single process this is the full batch.
    """

    def __init__(self, cfg: PipelineConfig,
                 generator_fn: Callable[[np.random.Generator, np.ndarray],
                                        dict],
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.generator_fn = generator_fn
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- deterministic per-step batch ---------------------------------------
    def global_indices(self, step: int) -> np.ndarray:
        start = np.int64(step) * self.cfg.global_batch
        return np.arange(start, start + self.cfg.global_batch)

    def host_slice(self, step: int) -> tuple[np.ndarray, slice]:
        idx = self.global_indices(step)
        n_proc, rank = world()
        per = self.cfg.global_batch // n_proc
        lo = rank * per
        return idx[lo:lo + per], slice(lo, lo + per)

    def batch_for(self, step: int) -> dict:
        """This rank's slice of step ``step``'s batch, as tensors on the
        pipeline's device."""
        rng = np.random.default_rng((self.cfg.seed, step))
        host_idx, _ = self.host_slice(step)
        host_batch = self.generator_fn(rng, host_idx)
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in host_batch.items()}

    # -- background prefetch -------------------------------------------------
    def start(self, first_step: int = 0):
        def loop():
            step = first_step
            while not self._stop.is_set():
                try:
                    self._q.put((step, self.batch_for(step)), timeout=0.2)
                    step += 1
                except queue.Full:
                    continue
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def next(self) -> tuple[int, dict]:
        return self._q.get(timeout=30)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


def lm_generator(vocab: int, seq: int):
    def gen(rng: np.random.Generator, idx: np.ndarray) -> dict:
        toks = rng.integers(0, vocab, (len(idx), seq + 1)).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return gen
