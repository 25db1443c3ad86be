"""IVF (inverted-file) ANN index in PyTorch: spherical k-means build +
two-phase nprobe search with the δ-snapshot hook ESPN's prefetcher needs.

Cells are padded to a fixed width so probing is a dense gather + one batched
product + top-k. Centroid scoring (``probe_cells``) runs the hand-written
``kernels/ivf_scan`` kernel on CUDA. Every top-k here is stable: among equal
scores the lowest index comes first, the order of the reference's
``jax.lax.top_k`` (padded slots all score ``NEG``, so ties are routine).
The scan cost model (``ANNCostModel``) reproduces the paper's accuracy/speed
trade-off (Fig 5) and the PrefetchBudget equation (2).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core.maxsim import topk_stable
from repro_torch.device import resolve_device
from repro_torch.kernels.ivf_scan.ops import centroid_scores

NEG = -1e30


@dataclass
class IVFIndex:
    centroids: torch.Tensor             # (ncells, d) fp32 unit-norm
    cell_ids: torch.Tensor              # (ncells, max_cell) int32, -1 padded
    cell_vecs: torch.Tensor             # (ncells, max_cell, d) quantized
    cell_scale: torch.Tensor | None     # (ncells, max_cell) dequant (int8)
    cell_sizes: np.ndarray              # (ncells,) host
    n_docs: int
    quant: str = "fp32"                 # fp32 | fp16 | int8

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @property
    def ncells(self) -> int:
        return self.centroids.shape[0]

    @property
    def max_cell(self) -> int:
        return self.cell_ids.shape[1]

    def memory_bytes(self) -> int:
        return (self.centroids.numel() * 4 + self.cell_ids.numel() * 4
                + self.cell_vecs.numel() * self.cell_vecs.element_size()
                + (self.cell_scale.numel() * 4
                   if self.cell_scale is not None else 0))

    def to(self, device) -> "IVFIndex":
        """This index with every tensor on ``device``."""
        return replace(
            self, centroids=self.centroids.to(device),
            cell_ids=self.cell_ids.to(device),
            cell_vecs=self.cell_vecs.to(device),
            cell_scale=(self.cell_scale.to(device)
                        if self.cell_scale is not None else None))


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)


def _assign_chunked(x: torch.Tensor, cent: torch.Tensor, *,
                    chunk: int = 65_536) -> torch.Tensor:
    """Nearest centroid (max inner product, first index on ties) per row,
    a chunk of rows at a time so the (chunk, ncells) score block stays
    bounded."""
    if x.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=x.device)
    return torch.cat([torch.argmax(x[i:i + chunk] @ cent.T, dim=-1)
                      for i in range(0, x.shape[0], chunk)])


def _kmeans(x: torch.Tensor, init_idx: np.ndarray, *, ncells: int,
            iters: int):
    """Spherical k-means: ``iters`` assign/mean/renormalize steps from the
    rows ``init_idx``. Empty cells keep their previous centroid."""
    cent = _normalize(x[torch.as_tensor(init_idx, device=x.device)])
    for _ in range(iters):
        assign = _assign_chunked(x, cent)
        # each cell's rows summed in row order, one thread a cell and lane
        # on CUDA: the same sums on every run and on the CPU (an atomic
        # index_add_ adds them in no fixed order on CUDA)
        cnt = torch.bincount(assign, minlength=ncells)
        sums = torch.segment_reduce(
            x[torch.argsort(assign, stable=True)], "sum", lengths=cnt,
            axis=0, unsafe=True)
        new = torch.where(cnt[:, None] > 0,
                          sums / cnt.clamp_min(1)[:, None].to(x.dtype), cent)
        cent = _normalize(new)
    return cent


def build_ivf(cls_embs: np.ndarray, ncells: int, *, iters: int = 8,
              seed: int = 0, quant: str = "fp32",
              max_cell_factor: float = 3.0,
              train_sample: int | None = 200_000,
              device: str | torch.device = "cuda") -> IVFIndex:
    """Cluster ``cls_embs`` into ``ncells`` padded cells on ``device`` (the
    card unless the caller asks for the CPU).

    The subsample and the initial centroids come from numpy's
    ``default_rng(seed)`` exactly as in the reference, so both packages
    start from the same rows. The k-means sums run in row order (the same
    on every run, on the CPU and the card), another order than the
    reference's, so the result is held by assignment agreement, not
    bitwise."""
    device = resolve_device(device)
    xs = np.asarray(cls_embs, np.float32)
    x = torch.as_tensor(xs, device=device)
    n, d = xs.shape
    rng = np.random.default_rng(seed)
    # fit k-means on a subsample (FAISS-style), assign the full corpus after
    fit_n = min(n, train_sample or n)
    fit_idx = rng.choice(n, size=fit_n, replace=False) if fit_n < n \
        else np.arange(n)
    init_idx = rng.choice(fit_n, size=ncells, replace=fit_n < ncells)
    cent = _kmeans(x[torch.as_tensor(fit_idx, device=x.device)], init_idx,
                   ncells=ncells, iters=iters)
    assign = _assign_chunked(x, cent).cpu().numpy()

    # host-side CSR -> padded cells (clamped width: overflow docs are
    # truncated, as in the reference)
    order = np.argsort(assign, kind="stable")
    sizes = np.bincount(assign, minlength=ncells)
    max_cell = int(min(max(8, sizes.mean() * max_cell_factor), sizes.max()))
    cell_ids = np.full((ncells, max_cell), -1, np.int32)
    cell_vecs = np.zeros((ncells, max_cell, d), np.float32)
    starts = np.zeros(ncells + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    for c in range(ncells):
        docs = order[starts[c]:starts[c + 1]][:max_cell]
        cell_ids[c, :len(docs)] = docs
        cell_vecs[c, :len(docs)] = xs[docs]

    scale = None
    if quant == "int8":
        amax = np.abs(cell_vecs).max(axis=-1)               # (ncells, max_cell)
        scale = np.maximum(amax / 127.0, 1e-9).astype(np.float32)
        vecs = np.round(cell_vecs / scale[..., None]).astype(np.int8)
    elif quant == "fp16":
        vecs = cell_vecs.astype(np.float16)
    else:
        vecs = cell_vecs
    return IVFIndex(
        centroids=cent, cell_ids=torch.as_tensor(cell_ids, device=device),
        cell_vecs=torch.as_tensor(vecs, device=device),
        cell_scale=(torch.as_tensor(scale, device=device)
                    if scale is not None else None),
        cell_sizes=np.minimum(sizes, max_cell), n_docs=n, quant=quant)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def _as_queries(index: IVFIndex, q) -> torch.Tensor:
    return torch.as_tensor(q, dtype=torch.float32,
                           device=index.device).contiguous()


def probe_cells(centroids: torch.Tensor, q: torch.Tensor, *,
                nprobe: int) -> torch.Tensor:
    """q: (B, d) -> (B, nprobe) cell ids, nearest-first (the probe order)."""
    _, idx = topk_stable(centroid_scores(q, centroids),
                         min(nprobe, centroids.shape[0]))
    return idx


def _scan_block(cell_ids, cell_vecs, cell_scale, q, probe, *, k: int):
    """One probe block: gather (B, P, M, d), one product per query, local
    top-k. Plain PyTorch: the reference leaves this product to XLA too.

    Each query's scores are a (P*M, d) x (d,) product of their own, whose
    shape does not depend on the batch: a batched product lets the library
    pick its kernel (and so its summation order) by B, and then a query's
    candidate scores, and its ranking among near ties, would depend on the
    batch it was served in."""
    ids = cell_ids[probe]                                     # (B, P, M)
    vf = cell_vecs[probe].float()                             # (B, P, M, d)
    if cell_scale is not None:
        vf = vf * cell_scale[probe][..., None]
    B, P, M, d = vf.shape
    qf = q.float()
    s = (torch.stack([vf[b].reshape(P * M, d) @ qf[b] for b in range(B)])
         if B else vf.new_zeros((0, P * M))).reshape(B, P, M)
    s = torch.where(ids >= 0, s, NEG)
    top_s, pos = topk_stable(s.reshape(B, -1), k)
    return top_s, torch.gather(ids.reshape(B, -1), 1, pos)


def _merge_topk(s1, i1, s2, i2, *, k: int):
    s = torch.cat([s1, s2], dim=1)
    i = torch.cat([i1, i2], dim=1)
    top_s, pos = topk_stable(s, k)
    return top_s, torch.gather(i, 1, pos)


def scan_cells(cell_ids, cell_vecs, cell_scale, q, probe, *, k: int,
               probe_chunk: int = 64):
    """Scan the probe cells, return per-query top-k (scores, doc_ids).

    q: (B, d); probe: (B, P). Probes are processed in chunks with a running
    top-k merge so the gathered working set stays bounded.
    """
    B, P = probe.shape
    if P <= probe_chunk:
        return _scan_block(cell_ids, cell_vecs, cell_scale, q, probe, k=k)
    top_s = top_i = None
    for s0 in range(0, P, probe_chunk):
        blk = probe[:, s0:s0 + probe_chunk]
        bs, bi = _scan_block(cell_ids, cell_vecs, cell_scale, q, blk, k=k)
        if top_s is None:
            top_s, top_i = bs, bi
        else:
            top_s, top_i = _merge_topk(top_s, top_i, bs, bi, k=k)
    return top_s, top_i


def search(index: IVFIndex, q, nprobe: int, k: int):
    """Single-phase search (no prefetch hook). ``q`` (B, d) numpy or tensor;
    returns (scores, doc_ids) tensors on the index's device."""
    q = _as_queries(index, q)
    probe = probe_cells(index.centroids, q, nprobe=nprobe)
    return scan_cells(index.cell_ids, index.cell_vecs, index.cell_scale, q,
                      probe, k=k)


def search_two_phase(index: IVFIndex, q, nprobe: int, k: int, delta: int):
    """ESPN's two-phase search: returns (approx top-k after δ probes,
    final top-k after all η probes, probe order). δ-snapshot = prefetch list.
    """
    q = _as_queries(index, q)
    probe = probe_cells(index.centroids, q, nprobe=nprobe)
    approx = scan_cells(index.cell_ids, index.cell_vecs, index.cell_scale, q,
                        probe[:, :max(1, delta)], k=k)
    final = scan_cells(index.cell_ids, index.cell_vecs, index.cell_scale, q,
                       probe, k=k)
    return approx, final, probe


def valid_candidates(ids_row: np.ndarray, scores_row: np.ndarray):
    """Drop ``-1`` padding from one query's candidate row, keeping ids and
    scores PAIRED (duplicated ids across merged top-k blocks can interleave
    the padding, so both arrays are masked with the same predicate)."""
    ids_row = np.asarray(ids_row)
    mask = ids_row >= 0
    return ids_row[mask], np.asarray(scores_row)[mask]


def mask_dead(ids, alive: np.ndarray | None):
    """Tombstone filter for candidate rows: ids whose doc is deleted become
    ``-1`` padding. ``alive=None`` (no mutation layer) is the identity."""
    if alive is None:
        return ids
    ids = np.asarray(ids)
    safe = np.clip(ids, 0, len(alive) - 1)
    return np.where((ids >= 0) & ~alive[safe], -1, ids)


# ---------------------------------------------------------------------------
# online insertion
# ---------------------------------------------------------------------------

def _grown(index: IVFIndex, need: np.ndarray):
    """New cell tensors wide enough for ``need`` docs in the fullest cell:
    copies of the index's, padded once (ids with ``-1``, int8 scales with
    the builder's floor scale ``1e-9``) when a cell overflows."""
    grow = max(0, int(need.max()) - index.max_cell)
    ids, vecs, scale = index.cell_ids, index.cell_vecs, index.cell_scale
    if not grow:
        return (ids.clone(), vecs.clone(),
                scale.clone() if scale is not None else None)
    c = index.ncells
    ids = torch.cat([ids, ids.new_full((c, grow), -1)], dim=1)
    vecs = torch.cat([vecs, vecs.new_zeros((c, grow, vecs.shape[2]))], dim=1)
    if scale is not None:
        scale = torch.cat([scale, scale.new_full((c, grow), 1e-9)], dim=1)
    return ids, vecs, scale


def _quantized(index: IVFIndex, v: torch.Tensor):
    """Rows ``v`` (n, d) fp32 in the index's storage: (vecs, scales). int8
    rows take the builder's per-vector scale ``max(|v|.max() / 127,
    1e-9)``."""
    if index.quant == "int8":
        amax = v.abs().amax(-1)
        # divided by a tensor: CUDA divides by a host scalar through its
        # reciprocal, which rounds otherwise than the builder's division
        sc = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-9)
        return torch.round(v / sc[:, None]).to(torch.int8), sc
    return v.to(index.cell_vecs.dtype), None


def ivf_add(index: IVFIndex, cls_embs, doc_ids) -> IVFIndex:
    """Online insertion on the index's device: assign new docs to their
    nearest existing centroid and append them to that cell, in input order
    within a cell (growing the pad width once when a cell fills).

    Centroids are not retrained (FAISS ``add`` does the same). The slots
    are the reference's sequential loop's (``ivf_add_plain``), reached at
    once: a stable sort of the assignments, each cell's running count, and
    one scatter into fresh copies of the cell tensors (a search holding
    the old ones is undisturbed). Deterministic, so replaying the same
    ingests on a freshly built index reproduces it bit for bit. Mutates
    ``index`` in place and returns it."""
    ids = np.asarray(doc_ids, np.int64)
    if len(ids) == 0:
        return index
    dev = index.device
    v = torch.as_tensor(cls_embs, dtype=torch.float32, device=dev)
    assign = _assign_chunked(v, index.centroids)
    counts = torch.bincount(assign, minlength=index.ncells)
    sizes = index.cell_sizes.astype(np.int64)
    need = counts.cpu().numpy() + sizes
    cell_ids, cell_vecs, cell_scale = _grown(index, need)
    # slot of each new doc: its cell's size so far + its rank among the
    # cell's new docs in input order
    order = torch.argsort(assign, stable=True)
    cells = assign[order]
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(len(ids), device=dev) - first[cells]
    slot = torch.as_tensor(sizes, device=dev)[cells] + rank
    q, sc = _quantized(index, v[order])
    cell_ids[cells, slot] = torch.as_tensor(ids, device=dev)[order].to(
        cell_ids.dtype)
    cell_vecs[cells, slot] = q
    if cell_scale is not None:
        cell_scale[cells, slot] = sc
    index.cell_ids, index.cell_vecs = cell_ids, cell_vecs
    index.cell_scale = cell_scale
    index.cell_sizes = need
    index.n_docs = int(max(index.n_docs, int(ids.max()) + 1))
    return index


def ivf_add_plain(index: IVFIndex, cls_embs, doc_ids) -> IVFIndex:
    """``ivf_add``'s plain version, the reference's loop: one doc at a
    time, in input order, into numpy copies of the cells."""
    ids = np.asarray(doc_ids, np.int64)
    if len(ids) == 0:
        return index
    dev = index.device
    vecs = np.asarray(torch.as_tensor(cls_embs, dtype=torch.float32).cpu())
    assign = _assign_chunked(torch.as_tensor(vecs, device=dev),
                             index.centroids).cpu().numpy()
    sizes = index.cell_sizes.astype(np.int64)
    need = np.bincount(assign, minlength=index.ncells) + sizes
    cell_ids, cell_vecs, cell_scale = (
        t.cpu().numpy() if t is not None else None
        for t in _grown(index, need))
    for v, gid, c in zip(vecs, ids, assign):
        pos = int(sizes[c])
        cell_ids[c, pos] = gid
        if index.quant == "int8":
            sc = max(float(np.abs(v).max()) / 127.0, 1e-9)
            cell_vecs[c, pos] = np.round(v / np.float32(sc)).astype(np.int8)
            cell_scale[c, pos] = sc
        else:
            cell_vecs[c, pos] = v.astype(cell_vecs.dtype)
        sizes[c] = pos + 1
    index.cell_ids = torch.as_tensor(cell_ids, device=dev)
    index.cell_vecs = torch.as_tensor(cell_vecs, device=dev)
    if cell_scale is not None:
        index.cell_scale = torch.as_tensor(cell_scale, device=dev)
    index.cell_sizes = sizes
    index.n_docs = int(max(index.n_docs, int(ids.max()) + 1))
    return index


# ---------------------------------------------------------------------------
# cost model (Fig 5 / eq. 2): ANN time grows with candidates scanned
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ANNCostModel:
    """t(nprobe) = t0 + c_centroid*ncells + c_cand * nprobe * mean_cell.
    The simulation's clock parameters, kept equal to the reference's."""
    t0_s: float = 1.2e-3
    c_centroid_s: float = 6e-9
    c_cand_s: float = 11e-9

    def time(self, index: IVFIndex, nprobe: int) -> float:
        mean_cell = float(index.cell_sizes.mean())
        return (self.t0_s + self.c_centroid_s * index.ncells
                + self.c_cand_s * nprobe * mean_cell)

    def prefetch_budget(self, index: IVFIndex, nprobe: int, delta: int) -> float:
        return self.time(index, nprobe) - self.time(index, delta)
