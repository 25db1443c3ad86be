"""MUVERA-style fixed dimensional encodings (Dhulipala et al. 2024), on the
device.

A multi-vector document (ragged token matrix) is collapsed into ONE vector
whose inner product with a query's FDE approximates the Chamfer / MaxSim
similarity, so candidate generation becomes a single-vector scan over a
small resident table, and only the top candidates are read from storage
for full-precision rerank.

Construction (asymmetric between queries and documents):

  1. SimHash space partitioning: ``r_reps`` independent repetitions, each
     drawing ``k_sim`` random hyperplanes; a token's bucket in repetition r
     is the integer formed by its ``k_sim`` sign bits (``2^k_sim`` buckets).
  2. Per-bucket aggregation: queries SUM their tokens per bucket, documents
     AVERAGE them.
  3. ``fill_empty`` backfill (documents only): an empty bucket copies the
     aggregate of the nearest non-empty bucket in Hamming distance over the
     SimHash bit codes, the first such bucket on ties.
  4. Optional final random projection to ``d_final`` dims (+-1/sqrt(d_final)
     entries), shared by both encodings.

The planes and the projection are drawn with numpy's ``default_rng(seed)``
exactly as the reference draws them, then moved to the device, where the
bucketing, the bucket sums (segment sums in token order) and the projection
run. The projection is taken in float64, as the reference's numpy product
is (its projection matrix is float64), and rounded to fp32. A token within
rounding of a hyperplane may land in another bucket than in the reference
(the fp32 sign test sums in another order).

A doc's encoding does not depend on the docs encoded with it: both
products run in blocks of a fixed number of rows (``_fixed_rows_mm``), so
the library takes the same kernel, and each row the same summation order,
whatever the batch. The FDEs of docs ingested into a live index
(``FDETable.append``) therefore equal a rebuild of the grown table bit for
bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.storage.layout import CHUNK_DOCS, bow_rows, token_scales

#: rows per product block: token rows for the SimHash sign tests, doc rows
#: for the projection
TOKEN_BLOCK = 4096
DOC_BLOCK = 128


def _fixed_rows_mm(x: torch.Tensor, w: torch.Tensor,
                   rows: int) -> torch.Tensor:
    """``x @ w``, ``rows`` rows of ``x`` at a time, the last block padded
    with zero rows: every product has one shape, so a row's result is the
    same whichever rows came with it (a product over all of ``x`` at once
    lets the library pick its kernel, and so its summation order, by the
    row count)."""
    n = x.shape[0]
    pad = -n % rows
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    return torch.cat([x[i:i + rows] @ w for i in range(0, n + pad, rows)]
                     or [x.new_zeros((0, w.shape[1]))])[:n]


@dataclass(frozen=True)
class FDEConfig:
    """Shared randomness + shape of one FDE family. Two encodings are only
    comparable when they come from the same config (same planes, same
    projection), which is why the table carries these fields."""
    d_bow: int
    k_sim: int = 3                # 2^k_sim SimHash buckets per repetition
    r_reps: int = 16
    d_final: int = 256            # 0 = keep the raw concatenation
    fill_empty: bool = True
    seed: int = 0

    @property
    def n_buckets(self) -> int:
        return 1 << self.k_sim

    @property
    def d_raw(self) -> int:
        return self.r_reps * self.n_buckets * self.d_bow

    @property
    def d_fde(self) -> int:
        return self.d_final or self.d_raw


class FDEEncoder:
    """Materializes the random partitions/projection of an ``FDEConfig`` on
    ``device`` and encodes queries (sum aggregation) and documents (average
    + backfill)."""

    def __init__(self, cfg: FDEConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        planes = rng.standard_normal(
            (cfg.r_reps, cfg.k_sim, cfg.d_bow)).astype(np.float32)
        # all repetitions' hyperplanes as one (r_reps * k_sim, d_bow) matrix
        self.planes = torch.as_tensor(
            planes.reshape(-1, cfg.d_bow), device=self.device)
        self.proj = None
        if cfg.d_final:
            proj = ((rng.integers(0, 2, (cfg.d_raw, cfg.d_final))
                     .astype(np.float32)) * 2.0 - 1.0) / np.sqrt(cfg.d_final)
            self.proj = torch.as_tensor(proj, dtype=torch.float64,
                                        device=self.device)
        nb = cfg.n_buckets
        codes = (np.arange(nb)[:, None] >> np.arange(cfg.k_sim)[None, :]) & 1
        ham = (codes[:, None, :] != codes[None, :, :]).sum(-1)   # (B, B)
        # nearest-bucket key: Hamming distance, then bucket id, so the
        # smallest key is the first bucket at the least distance; an empty
        # bucket sits past every real distance
        self._near_key = torch.as_tensor(ham * nb + np.arange(nb)[None, :],
                                         device=self.device)
        self._empty_key = (cfg.k_sim + 1) * nb + torch.arange(
            nb, device=self.device)
        self._bit_weights = torch.as_tensor(1 << np.arange(cfg.k_sim),
                                            device=self.device)

    # -- shared internals ---------------------------------------------------
    def _bucketize(self, flat: torch.Tensor) -> torch.Tensor:
        """(t, d_bow) fp32 tokens -> (t, r_reps) bucket ids in
        [0, 2^k_sim), every repetition at once (one product with all the
        hyperplanes)."""
        cfg = self.cfg
        bits = _fixed_rows_mm(flat, self.planes.T, TOKEN_BLOCK) > 0
        return (bits.view(-1, cfg.r_reps, cfg.k_sim).long()
                * self._bit_weights).sum(-1)

    def _aggregate(self, flat: torch.Tensor, lens: torch.Tensor, *,
                   average: bool, fill_empty: bool) -> torch.Tensor:
        """(total, d_bow) fp32 tokens of ``len(lens)`` docs, concatenated
        in order -> (n, d_raw) fp32 per-bucket aggregates."""
        cfg = self.cfg
        n, nb, d = len(lens), cfg.n_buckets, cfg.d_bow
        out = torch.zeros(n, cfg.r_reps, nb, d, dtype=torch.float32,
                          device=self.device)
        if n == 0:
            return out.reshape(0, cfg.d_raw)
        doc_of = torch.repeat_interleave(
            torch.arange(n, device=self.device), lens)
        bucket = self._bucketize(flat)                      # (total, r)
        for r in range(cfg.r_reps):
            slot = doc_of * nb + bucket[:, r]
            # each slot's tokens summed in token order, one thread a slot
            # and lane on CUDA: the same sums on every run and on the CPU
            # (an atomic index_add_ adds them in no fixed order on CUDA)
            cnt = torch.bincount(slot, minlength=n * nb)
            agg = torch.segment_reduce(
                flat[torch.argsort(slot, stable=True)], "sum", lengths=cnt,
                axis=0, unsafe=True).view(n, nb, d)
            cnt = cnt.view(n, nb)
            if average:
                agg = agg / cnt.clamp_min(1)[..., None].float()
            if fill_empty:
                key = torch.where(cnt[:, None, :] > 0, self._near_key[None],
                                  self._empty_key[None, None, :])
                nearest = key.amin(-1) % nb                # (n, B)
                filled = torch.gather(agg, 1,
                                      nearest[..., None].expand(-1, -1, d))
                agg = torch.where((cnt > 0)[..., None], agg, filled)
            out[:, r] = agg
        return out.reshape(n, cfg.d_raw)

    def _project(self, raw: torch.Tensor) -> torch.Tensor:
        """(n, d_raw) -> (n, d_fde) fp32 (the product in float64)."""
        if self.proj is None:
            return raw
        return _fixed_rows_mm(raw.double(), self.proj, DOC_BLOCK).float()

    def encode_flat(self, flat: torch.Tensor, lens) -> torch.Tensor:
        """Document FDEs of ``len(lens)`` docs whose tokens are ``flat``,
        concatenated in doc order: (n, d_fde) fp32."""
        lens = torch.as_tensor(np.asarray(lens, np.int64), device=self.device)
        flat = flat.to(self.device, torch.float32)
        return self._project(self._aggregate(
            flat, lens, average=True, fill_empty=self.cfg.fill_empty))

    # -- public encodings ---------------------------------------------------
    def encode_docs(self, bows: list[np.ndarray], *,
                    chunk: int = 8192) -> torch.Tensor:
        """Document FDEs: per-bucket average + empty-bucket backfill.
        Returns (len(bows), d_fde) fp32 on the device, encoded ``chunk``
        docs at a time."""
        parts = []
        for s in range(0, len(bows), chunk):
            sub = bows[s:s + chunk]
            lens = [b.shape[0] for b in sub]
            flat = (np.concatenate(sub, axis=0).astype(np.float32)
                    if sum(lens) else np.zeros((0, self.cfg.d_bow),
                                               np.float32))
            parts.append(self.encode_flat(torch.from_numpy(flat), lens))
        if not parts:
            return torch.zeros(0, self.cfg.d_fde, device=self.device)
        return torch.cat(parts)

    def encode_doc(self, toks: np.ndarray) -> torch.Tensor:
        return self.encode_docs([toks])[0]

    def encode_queries(self, q_bow: np.ndarray,
                       q_lens: np.ndarray) -> torch.Tensor:
        """Query FDEs from a padded (B, L, d_bow) batch + lengths: per-bucket
        SUM, no backfill. Returns (B, d_fde) fp32 on the device."""
        q_lens = np.asarray(q_lens, np.int64)
        flat = np.concatenate([np.asarray(q_bow[i][:int(q_lens[i])],
                                          np.float32)
                               for i in range(q_bow.shape[0])]) \
            if len(q_lens) else np.zeros((0, self.cfg.d_bow), np.float32)
        lens = torch.as_tensor(q_lens, device=self.device)
        return self._project(self._aggregate(
            torch.as_tensor(flat, device=self.device), lens, average=False,
            fill_empty=False))

    def encode_query(self, toks: np.ndarray) -> torch.Tensor:
        return self.encode_queries(np.asarray(toks)[None],
                                   np.array([len(toks)]))[0]


@dataclass
class FDETable:
    """Resident single-vector tier: one FDE per document (a tensor, on the
    device it was built on), plus the config that generated it."""
    vecs: torch.Tensor            # (N, d_fde) stored dtype
    cfg: FDEConfig

    @property
    def n_docs(self) -> int:
        return self.vecs.shape[0]

    @property
    def nbytes(self) -> int:
        return self.vecs.numel() * self.vecs.element_size()

    def matches(self, cfg: FDEConfig, dtype: str) -> bool:
        """True when this table can serve queries encoded under ``cfg`` at
        storage dtype ``dtype``."""
        return self.cfg == cfg and self.vecs.dtype == getattr(torch, dtype)

    def append(self, vecs: torch.Tensor) -> None:
        """Extend the table with newly ingested docs' FDEs (encoded under
        this table's own ``cfg``; a doc's encoding is independent of its
        batch, so the appended rows equal a rebuild's), on the table's
        device, in its dtype."""
        if len(vecs) == 0:
            return
        self.vecs = torch.cat([self.vecs, vecs.to(self.vecs.device,
                                                  self.vecs.dtype)])


def build_fde_table(bows: list[np.ndarray], cfg: FDEConfig, *,
                    dtype: str = "float16",
                    device: str | torch.device = "cuda") -> FDETable:
    enc = FDEEncoder(cfg, device)
    return FDETable(vecs=enc.encode_docs(bows).to(getattr(torch, dtype)),
                    cfg=cfg)


def fde_from_layout(layout, cfg: FDEConfig, *, dtype: str = "float16",
                    device: str | torch.device = "cuda",
                    chunk_docs: int = CHUNK_DOCS) -> FDETable:
    """Build the resident FDE table from an already-packed disk layout,
    decoding the blob ``chunk_docs`` docs at a time (the stored dtype goes
    to the device and widens there)."""
    enc = FDEEncoder(cfg, device)
    n = layout.n_docs
    vecs = torch.empty(n, cfg.d_fde, dtype=getattr(torch, dtype),
                       device=enc.device)
    for d0 in range(0, n, chunk_docs):
        d1 = min(n, d0 + chunk_docs)
        flat = torch.from_numpy(bow_rows(layout, d0, d1)).to(
            enc.device).float()
        scale = token_scales(layout, d0, d1)
        if scale is not None:
            flat = flat * torch.from_numpy(scale).to(enc.device)
        vecs[d0:d1] = enc.encode_flat(flat, layout.n_tokens[d0:d1])
    return FDETable(vecs=vecs, cfg=cfg)
