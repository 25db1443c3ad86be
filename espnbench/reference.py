"""The plain reference and the comparison that decides ``correct``.

Plain PyTorch in float64, on whatever device it is given. It imports
nothing of the program and reads only the benchmark's own inputs (the
generated CLS and token vectors) and the configuration: it builds the IVF
index again by the configuration's rule (``kmeans_index``: the same
subsample and initial centroids, drawn by numpy's ``default_rng(seed)``,
then spherical k-means in float64) and holds the program's index to it.
Rounding moves a few documents near a cell border from one k-means step to
the next, so the two indexes are compared by the share of documents they
place in different cells, and the program's candidates are judged within
the program's own cells, which that share and ``assign_gap`` vouch for.

The numbers compared (the last three the worst over the queries judged, in
units of score: CLS cosine in [-1, 1]; MaxSim up to the query length):

``cell_mismatch``
    the share of documents the program's index places in another cell
    than the reference's (or holds in none, or in two, where the
    reference does otherwise).

``assign_gap``
    over every document: how far the centroid of the cell holding it lies
    below its best centroid (a document no cell holds is measured against
    the nearest full cell, since cells are truncated at ``max_cell``).
``miss_gap``
    how far a document of the probed cells that the answer left out lies
    above the answer's weakest candidate, taken no larger than its cell's
    margin over the first unprobed cell (a probe that swapped two cells
    within rounding leaves their documents out within rounding too). An
    answer with fewer candidates than it is due counts its floor as -2.
``score_gap``
    between each answered document's score and ``alpha * CLS + MaxSim`` over
    the document's stored tokens (at most ``t_max``), taken again here.
``rank_gap``
    how far the answer's r-th document's reference score lies below the
    r-th best reference score among the answer's documents.

``control_*`` and ``kmeans_index(..., control=True)`` compute the same
index and answers the way the program would, in TF32 (operands rounded to
10 mantissa bits, products and sums in float32): the control that has to
come out not correct.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NAMES = ("cell_mismatch", "assign_gap", "miss_gap", "score_gap", "rank_gap")
#: the floor an answer with missing candidates is measured from
SHORT_FLOOR = -2.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32 with its mantissa rounded to TF32's 10 bits
    (round to nearest, ties to even)."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


@dataclass
class Inputs:
    """What the benchmark hands both sides, as the reference reads it."""
    cls: torch.Tensor        # (N, d_cls) float32 on the reference's device
    tokens: torch.Tensor     # (T, d_bow) float16 stored token rows
    starts: torch.Tensor     # (N,) int64
    lens: torch.Tensor       # (N,) int64
    nprobe: int
    k: int
    alpha: float
    t_max: int


@dataclass
class IndexState:
    """The IVF index the reference follows: centroids and cell lists."""
    centroids: torch.Tensor  # (C, d_cls) float32
    cell_ids: np.ndarray     # (C, M) int, -1 padded

    def members(self) -> np.ndarray:
        """(N?,) cell of each doc id present; -1 absent, -2 in two cells."""
        ids = self.cell_ids
        valid = ids >= 0
        n = int(ids.max()) + 1 if valid.any() else 0
        cell_of = np.full(n, -1, np.int64)
        counts = np.bincount(ids[valid].ravel(), minlength=n)
        cells = np.broadcast_to(np.arange(ids.shape[0])[:, None], ids.shape)
        cell_of[ids[valid]] = cells[valid]
        cell_of[counts > 1] = -2
        return cell_of


@dataclass
class IndexRule:
    """How the configuration builds its IVF index: ``ncells`` cells by
    ``iters`` spherical k-means steps on ``train_sample`` documents (all
    when None) drawn, with the initial centroids, by
    ``np.random.default_rng(seed)``; cells cut at ``max_cell_factor`` times
    the mean size."""
    ncells: int
    iters: int
    train_sample: int | None
    seed: int
    max_cell_factor: float

    @classmethod
    def of(cls, config: dict) -> "IndexRule":
        idx, build = config["pipeline"]["index"], config["index_build"]
        return cls(ncells=idx["ncells"], iters=idx["iters"],
                   train_sample=idx.get("train_sample"), seed=build["seed"],
                   max_cell_factor=build["max_cell_factor"])


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)


def _nearest(x: torch.Tensor, cent: torch.Tensor, control: bool,
             chunk: int = 32768) -> torch.Tensor:
    """Best centroid of each row (first on ties), a chunk at a time."""
    if control:
        c = tf32(cent)
        return torch.cat([torch.argmax(tf32(x[i:i + chunk]) @ c.T, dim=1)
                          for i in range(0, len(x), chunk)])
    c = cent.double()
    return torch.cat([torch.argmax(x[i:i + chunk].double() @ c.T, dim=1)
                      for i in range(0, len(x), chunk)])


def kmeans_index(cls: torch.Tensor, rule: IndexRule, *,
                 control: bool = False) -> IndexState:
    """The IVF index ``rule`` makes of the (N, d) CLS vectors: in float64,
    or in TF32 with float32 sums for the control."""
    n = cls.shape[0]
    rng = np.random.default_rng(rule.seed)
    fit_n = min(n, rule.train_sample or n)
    fit_idx = (rng.choice(n, size=fit_n, replace=False) if fit_n < n
               else np.arange(n))
    init_idx = rng.choice(fit_n, size=rule.ncells,
                          replace=fit_n < rule.ncells)
    dtype = torch.float32 if control else torch.float64
    x = cls[torch.as_tensor(fit_idx, device=cls.device)].to(dtype)
    cent = _unit(x[torch.as_tensor(init_idx, device=cls.device)])
    for _ in range(rule.iters):
        assign = _nearest(x, cent, control)
        cnt = torch.bincount(assign, minlength=rule.ncells)
        sums = torch.zeros_like(cent).index_add_(0, assign, x)
        cent = _unit(torch.where(cnt[:, None] > 0,
                                 sums / cnt.clamp_min(1)[:, None].to(dtype),
                                 cent))
    assign = _nearest(cls, cent, control).cpu().numpy()
    sizes = np.bincount(assign, minlength=rule.ncells)
    max_cell = int(min(max(8, sizes.mean() * rule.max_cell_factor),
                       sizes.max()))
    return IndexState(centroids=cent.float(),
                      cell_ids=build_cells(assign, rule.ncells, max_cell))


def cell_mismatch(index: IndexState, ref: IndexState, n: int) -> float:
    """Share of the ``n`` documents whose cell differs between the two
    indexes (-1 for none, -2 for two)."""
    def cells(ix):
        c = ix.members()[:n]
        return np.concatenate([c, np.full(n - len(c), -1, np.int64)])
    return float(np.mean(cells(index) != cells(ref)))


def build_cells(assign: np.ndarray, ncells: int, max_cell: int) -> np.ndarray:
    """Cell lists from an assignment: ids ascending, cut at ``max_cell``."""
    order = np.argsort(assign, kind="stable")
    sizes = np.bincount(assign, minlength=ncells)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    out = np.full((ncells, max_cell), -1, np.int64)
    for c in range(ncells):
        docs = order[starts[c]:starts[c + 1]][:max_cell]
        out[c, :len(docs)] = docs
    return out


def assign_gap(inp: Inputs, index: IndexState, chunk: int = 32768) -> float:
    cent = index.centroids.double()
    cell_of = index.members()
    n = inp.cls.shape[0]
    cell_of = np.concatenate([cell_of, np.full(max(0, n - len(cell_of)), -1)])
    sizes = (index.cell_ids >= 0).sum(1)
    full = torch.as_tensor(sizes >= index.cell_ids.shape[1],
                           device=cent.device)
    member = torch.as_tensor(cell_of[:n], device=cent.device)
    worst = 0.0
    for i in range(0, n, chunk):
        s = inp.cls[i:i + chunk].double() @ cent.T
        best = s.max(dim=1).values
        m = member[i:i + chunk]
        held = s.gather(1, m.clamp_min(0)[:, None])[:, 0]
        gap = torch.where(m >= 0, best - held, torch.full_like(best, 2.0))
        absent = m == -1
        if bool(absent.any()):
            near = torch.where(full[None, :], s[absent],
                               torch.full_like(s[absent], -3.0))
            gap[absent] = torch.clamp(best[absent] - near.max(dim=1).values,
                                      max=2.0)
        worst = max(worst, float(gap.max()))
    return worst


def _tiles(inp: Inputs, ids: torch.Tensor):
    """(K, t_max, d_bow) stored tokens of ``ids`` and their (K,) counts."""
    n = torch.minimum(inp.lens[ids], torch.tensor(inp.t_max,
                                                  device=ids.device))
    steps = torch.arange(inp.t_max, device=ids.device)
    valid = steps[None, :] < n[:, None]
    rows = torch.where(valid, inp.starts[ids][:, None] + steps[None, :], 0)
    return inp.tokens[rows], valid


def maxsim64(inp: Inputs, q_bow: torch.Tensor, ids: torch.Tensor):
    tiles, valid = _tiles(inp, ids)
    s = torch.einsum("qd,ktd->kqt", q_bow.double(), tiles.double())
    s = torch.where(valid[:, None, :], s, -torch.inf)
    return s.max(dim=2).values.sum(dim=1)


def judge_query(inp: Inputs, index: IndexState, cell_of: torch.Tensor,
                cells_dev: torch.Tensor, q_cls: np.ndarray,
                q_bow: np.ndarray, q_len: int, ids: np.ndarray,
                scores: np.ndarray) -> dict:
    """The three per-query numbers of one answer (``ids`` ranked, with the
    program's ``scores``)."""
    dev = inp.cls.device
    q = torch.as_tensor(q_cls, device=dev).double()
    qb = torch.as_tensor(q_bow[:q_len], device=dev)
    sc = index.centroids.double() @ q
    ordered = torch.sort(sc, descending=True).values
    nprobe = min(inp.nprobe, len(sc))
    c_next = ordered[nprobe] if len(sc) > nprobe else ordered[-1] - 4.0
    probed = torch.topk(sc, nprobe).indices
    pool = cells_dev[probed].ravel()
    pool = pool[pool >= 0]
    n = inp.cls.shape[0]
    p = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
    ok = bool(((p >= 0) & (p < n)).all()) and len(torch.unique(p)) == len(p)
    if not ok:
        return dict(miss_gap=2.0, score_gap=2.0 * q_len,
                    rank_gap=2.0 * q_len)
    s_all = inp.cls.double() @ q if n <= 65536 else None

    def cls_score(x):
        return s_all[x] if s_all is not None else inp.cls[x].double() @ q
    pc = cell_of[p]
    sp = cls_score(p)
    due = min(inp.k, len(pool))
    floor = sp.min() if len(p) >= due and len(p) else \
        torch.tensor(SHORT_FLOOR, dtype=torch.float64, device=dev)
    left = pool[~torch.isin(pool, p)]
    miss_gap = 0.0
    if len(left):
        over = cls_score(left) - floor
        touched = torch.zeros(len(sc), dtype=torch.bool, device=dev)
        touched[pc[pc >= 0]] = True
        lc = cell_of[left].clamp_min(0)
        margin = torch.where(touched[lc], torch.full_like(over, torch.inf),
                             sc[lc] - c_next)
        miss_gap = float(torch.clamp(torch.minimum(over, margin),
                                     min=0).max())
    ref = inp.alpha * sp + maxsim64(inp, qb, p)
    got = torch.as_tensor(np.asarray(scores, np.float64), device=dev)
    score_gap = float((got - ref).abs().max()) if len(p) else 0.0
    rank_gap = float(torch.clamp(torch.sort(ref, descending=True).values
                                 - ref, min=0).max()) if len(p) else 0.0
    return dict(miss_gap=miss_gap, score_gap=score_gap, rank_gap=rank_gap)


def judge(inp: Inputs, index: IndexState, ref: IndexState, queries,
          answers: dict, picks) -> dict:
    """Worst of each number over the answers ``picks`` (query rows whose
    answers ``answers[row] = (ids, scores)`` are judged), with the index
    stage's ``cell_mismatch`` (against the reference's index ``ref``) and
    ``assign_gap``."""
    dev = inp.cls.device
    cell_of = torch.as_tensor(index.members(), device=dev)
    n = inp.cls.shape[0]
    if len(cell_of) < n:
        cell_of = torch.cat([cell_of, cell_of.new_full((n - len(cell_of),),
                                                       -1)])
    cells_dev = torch.as_tensor(index.cell_ids, device=dev)
    out = {name: 0.0 for name in NAMES}
    out["cell_mismatch"] = cell_mismatch(index, ref, n)
    out["assign_gap"] = assign_gap(inp, index)
    for row in picks:
        ids, scores = answers[row]
        got = judge_query(inp, index, cell_of, cells_dev, queries.cls[row],
                          queries.bow[row], int(queries.lens[row]), ids,
                          scores)
        for name, v in got.items():
            out[name] = max(out[name], v)
    return out


# ---------------------------------------------------------------------------
# the control: the reference in the program's place, computed in TF32
# ---------------------------------------------------------------------------

def control_answer(inp: Inputs, index: IndexState, cells_dev: torch.Tensor,
                   q_cls: np.ndarray, q_bow: np.ndarray, q_len: int):
    """One query answered by the program's algorithm in TF32."""
    dev = inp.cls.device
    q = tf32(torch.as_tensor(q_cls, device=dev))
    sc = tf32(index.centroids) @ q
    probed = torch.topk(sc, min(inp.nprobe, len(sc))).indices
    pool = cells_dev[probed].ravel()
    pool = pool[pool >= 0]
    s = tf32(inp.cls[pool]) @ q
    top = torch.topk(s, min(inp.k, len(pool)))
    ids = pool[top.indices]
    tiles, valid = _tiles(inp, ids)
    qb = tf32(torch.as_tensor(q_bow[:q_len], device=dev))
    m = torch.einsum("qd,ktd->kqt", qb, tf32(tiles.float()))
    m = torch.where(valid[:, None, :], m, -torch.inf).max(dim=2).values
    agg = inp.alpha * top.values + m.sum(dim=1)
    order = torch.argsort(agg, descending=True, stable=True)
    return ids[order].cpu().numpy(), agg[order].cpu().numpy()


def control_answers(inp: Inputs, index: IndexState, queries, picks):
    cells_dev = torch.as_tensor(index.cell_ids, device=inp.cls.device)
    return {row: control_answer(inp, index, cells_dev, queries.cls[row],
                                queries.bow[row], int(queries.lens[row]))
            for row in picks}
