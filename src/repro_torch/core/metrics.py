"""IR metrics: MRR@K and Recall@K (the paper's evaluation metrics)."""
from __future__ import annotations

import numpy as np


def mrr_at_k(ranked_ids: list[np.ndarray], relevant: list[set], k: int = 10) -> float:
    total = 0.0
    for ids, rel in zip(ranked_ids, relevant):
        for rank, i in enumerate(ids[:k], start=1):
            if int(i) in rel:
                total += 1.0 / rank
                break
    return total / max(1, len(ranked_ids))


def recall_at_k(ranked_ids: list[np.ndarray], relevant: list[set], k: int = 1000) -> float:
    total = 0.0
    for ids, rel in zip(ranked_ids, relevant):
        if not rel:
            continue
        found = len(rel.intersection(int(i) for i in ids[:k]))
        total += found / len(rel)
    return total / max(1, len(ranked_ids))
