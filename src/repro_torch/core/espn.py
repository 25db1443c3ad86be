"""Shared types of the ESPN query path (paper Fig 4): the configuration, the
simulated compute clock, the per-stage latency breakdown and the response.

Every stage contributes to a per-query latency breakdown on the simulated
device clock, reproducing the paper's Tables 4/5 and Figures 8-10. The
per-mode query paths live in ``repro_torch.pipeline.backends`` behind the
``RetrievalBackend`` registry; ``ESPNRetriever`` is the thin
mode-dispatching entry point over it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.ivf import ANNCostModel, IVFIndex
from repro_torch.core.rerank import RerankOutput
from repro_torch.storage.io_engine import StorageTier


@dataclass(frozen=True)
class ComputeModel:
    """Compute clock of the simulation. The constants are the simulation's
    clock parameters, kept equal to the reference's for parity: the
    breakdown it bills is the paper's model, not a measurement of the card
    the port runs on."""
    maxsim_flops_s: float = 30e12
    encode_base_s: float = 2.2e-3
    encode_flops_s: float = 60e12
    encoder_gflops: float = 4.4        # distilBERT fwd @ 32 tokens
    bitsim_speedup: float = 10.0       # packed-bit MaxSim vs full precision
                                       # in the simulation (the ratio
                                       # Nardini et al. 2024 report)

    def encode_time(self, batch: int) -> float:
        return self.encode_base_s + batch * self.encoder_gflops * 1e9 / self.encode_flops_s

    def maxsim_time(self, n_docs: int, q_len: int, mean_tokens: float,
                    d_bow: int) -> float:
        flops = 2.0 * n_docs * q_len * mean_tokens * d_bow
        return 0.3e-3 + flops / self.maxsim_flops_s

    def bitsim_time(self, n_docs: int, q_len: int, mean_tokens: float,
                    d_bow: int) -> float:
        flops = 2.0 * n_docs * q_len * mean_tokens * d_bow
        return 0.05e-3 + flops / (self.maxsim_flops_s * self.bitsim_speedup)


@dataclass(frozen=True)
class ESPNConfig:
    mode: str = "espn"                 # any registered backend name
    nprobe: int = 128
    k_candidates: int = 1000
    prefetch_step: float = 0.10
    rerank_count: int | None = None    # None = exact (re-rank all candidates)
    alpha: float = 1.0                 # CLS/BOW aggregation weight
    bit_filter: int = 128              # bitvec: full-precision rerank width R
    fde_brute_threshold: int = 100_000  # fde: brute-scan the FDE table below
                                        # this corpus size, IVF above
    cascade_filter: int = 64           # cascade: bit-score survivors that
                                       # reach the SSD rerank stage
    cascade_candidates: int = 0        # cascade: FDE candidate width
                                       # (0 = reuse k_candidates)


@dataclass
class LatencyBreakdown:
    """The reference's breakdown, field for field. ``hedge_bytes_read`` is
    the extra duplicate bytes the storage cluster's hedged re-issues moved
    (0 on a single tier); the fault counters are this batch's deltas of the
    tier's, and
    ``degraded_queries`` counts the queries answered from candidate scores
    after a failed read."""
    encode_s: float = 0.0
    ann_s: float = 0.0
    hidden_s: float = 0.0              # overlapped prefetch+early-rerank work
    critical_io_s: float = 0.0
    rerank_s: float = 0.0
    total_s: float = 0.0
    hit_rate: float = 1.0
    bytes_read: int = 0                # unique bytes billed for the batch
    dedup_bytes_saved: int = 0         # duplicate-request bytes billed once
    hedge_bytes_read: int = 0
    retries: int = 0
    checksum_failures: int = 0
    repair_bytes: int = 0
    faults_injected: int = 0
    degraded_queries: int = 0

    def ms(self) -> dict:
        return {k: round(v * 1e3, 3) for k, v in self.__dict__.items()
                if k.endswith("_s")} | {"hit_rate": round(self.hit_rate, 4)}

    def as_dict(self) -> dict:
        """COMPLETE breakdown: every field, ``_s`` stages converted to
        milliseconds (``*_ms`` keys) and the counters passed through."""
        out: dict = {}
        for k, v in self.__dict__.items():
            if k.endswith("_s"):
                out[k[:-2] + "_ms"] = round(v * 1e3, 6)
            elif k == "hit_rate":
                out[k] = round(v, 6)
            else:
                out[k] = int(v)
        return out


@dataclass
class RetrievalResponse:
    ranked: list[RerankOutput]
    breakdown: LatencyBreakdown
    per_query: list = field(default_factory=list)


class ESPNRetriever:
    """Mode-dispatching retriever: resolves ``cfg.mode`` against the backend
    registry and delegates the query path to the backend instance."""

    def __init__(self, index: IVFIndex, tier: StorageTier, cfg: ESPNConfig,
                 *, cost_model: ANNCostModel | None = None,
                 compute: ComputeModel | None = None,
                 doc_bytes=None, tracer=None):
        # late import: repro_torch.pipeline.backends imports this module
        from repro_torch.pipeline.backends import get_backend
        self.backend = get_backend(cfg.mode)(
            index, tier, cfg, cost_model=cost_model, compute=compute,
            doc_bytes=doc_bytes, tracer=tracer)

    @property
    def index(self):
        return self.backend.index

    @property
    def tier(self):
        return self.backend.tier

    @property
    def cfg(self):
        return self.backend.cfg

    @property
    def cost(self):
        return self.backend.cost

    @property
    def compute(self):
        return self.backend.compute

    @property
    def doc_bytes(self):
        return self.backend.doc_bytes

    @property
    def tracer(self):
        return self.backend.tracer

    @tracer.setter
    def tracer(self, tr):
        self.attach_tracer(tr)

    def attach_tracer(self, tracer) -> None:
        self.backend.attach_tracer(tracer)

    def query_batch(self, q_cls: np.ndarray, q_bow: np.ndarray,
                    q_lens: np.ndarray) -> RetrievalResponse:
        return self.backend.query_batch(q_cls, q_bow, q_lens)
