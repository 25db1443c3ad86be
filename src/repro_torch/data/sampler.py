"""GraphSAGE-style fanout neighbor sampler (the real sampler behind the
``minibatch_lg`` shape: batch_nodes=1024, fanout 15-10).

Host-side numpy over a CSR adjacency, the reference's draws in its order (the
same blocks for the same graph, seeds and generator); emits fixed-shape
padded blocks (edge arrays padded to the declared sizes with out-of-range
dst = n_nodes, which ``models/gnn`` drops).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray            # (N+1,)
    indices: np.ndarray           # (E,)
    n_nodes: int

    @staticmethod
    def from_edges(src, dst, n_nodes: int) -> "CSRGraph":
        """The edges grouped by source, each group in edge order."""
        src, dst = np.asarray(src), np.asarray(dst)
        order = np.argsort(src, kind="stable")
        indptr = np.zeros(n_nodes + 1, np.int64)
        indptr[1:] = np.cumsum(np.bincount(src, minlength=n_nodes))
        return CSRGraph(indptr=indptr, indices=dst[order], n_nodes=n_nodes)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]


def sample_block(graph: CSRGraph, seeds: np.ndarray, fanouts: list[int],
                 rng: np.random.Generator, *, pad_edges_to: int | None = None):
    """Sample a multi-hop block. Returns dict with LOCAL node ids:
    node_ids (global ids of the block), edge_src/edge_dst (local),
    seed_local (positions of seeds). Deduplicates across hops.
    """
    nodes = list(seeds)
    local = {int(v): i for i, v in enumerate(seeds)}
    frontier = list(seeds)
    e_src, e_dst = [], []
    for fanout in fanouts:
        nxt = []
        for v in frontier:
            nbrs = graph.neighbors(int(v))
            if len(nbrs) == 0:
                continue
            take = rng.choice(nbrs, size=min(fanout, len(nbrs)),
                              replace=len(nbrs) < fanout)
            for u in take:
                u = int(u)
                if u not in local:
                    local[u] = len(nodes)
                    nodes.append(u)
                # message flows u -> v
                e_src.append(local[u])
                e_dst.append(local[int(v)])
                nxt.append(u)
        frontier = nxt
    node_ids = np.asarray(nodes, np.int64)
    e_src = np.asarray(e_src, np.int32)
    e_dst = np.asarray(e_dst, np.int32)
    if pad_edges_to is not None:
        pad = pad_edges_to - len(e_src)
        if pad < 0:
            e_src, e_dst = e_src[:pad_edges_to], e_dst[:pad_edges_to]
        else:
            # dst = len(nodes) (out of range) -> dropped by segment_sum
            e_src = np.concatenate([e_src, np.zeros(pad, np.int32)])
            e_dst = np.concatenate([e_dst,
                                    np.full(pad, len(nodes), np.int32)])
    return {
        "node_ids": node_ids,
        "edge_src": e_src,
        "edge_dst": e_dst,
        "seed_local": np.arange(len(seeds), dtype=np.int32),
    }


def random_graph(n_nodes: int, avg_degree: int, seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    e = n_nodes * avg_degree
    src = rng.integers(0, n_nodes, e)
    dst = rng.integers(0, n_nodes, e)
    return CSRGraph.from_edges(src, dst, n_nodes)
