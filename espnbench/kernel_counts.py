"""Frozen yardstick for the kernels: the H100's peaks and the bytes and
operations each kernel call needs at the shapes it is called with.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at the
full 700 W limit). The counts are the ones the port's kernel check
(``chip_smoke.py``) uses, frozen here: each input byte read once, each
output byte written once, operations as the call's shapes and valid tokens
need them.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
FP32_FLOPS_S = 67e12
TF32_TC_FLOPS_S = 495e12
FP16_TC_FLOPS_S = 989e12


def bound_s(n_bytes: float, n_ops: float, flops_s: float) -> float:
    """The least time the chip could take: bytes or operations at peak."""
    return max(n_bytes / HBM_BYTES_S, n_ops / flops_s)


def maxsim_work(k: int, lq: int, d: int, n_tok: float,
                doc_elt: int = 2) -> tuple[float, float]:
    """MaxSim of one query (``lq`` x ``d``, fp32, with its fp32 mask)
    against ``k`` docs holding ``n_tok`` valid tokens of ``doc_elt`` bytes
    a value: (bytes, operations). Bytes: the query, the mask, the lengths,
    the scores and each valid token row once; operations: the fp16 tensor
    cores' two passes (the query in two fp16 parts)."""
    n_bytes = 4 * (lq * d + lq + 2 * k) + doc_elt * d * n_tok
    return n_bytes, 2 * 2 * lq * d * n_tok


def maxsim_bound_s(k, lq, d, n_tok, doc_elt=2) -> float:
    return bound_s(*maxsim_work(k, lq, d, n_tok, doc_elt), FP16_TC_FLOPS_S)


def ivf_scan_work(b: int, n: int, d: int) -> tuple[float, float]:
    """Centroid scores of ``b`` queries against ``n`` centroids of width
    ``d``, all fp32: (bytes, operations). The TF32 tensor cores' three
    products (3xTF32) keep fp32 accuracy."""
    return 4 * (b * d + n * d + b * n), 3 * 2 * b * n * d


def ivf_scan_bound_s(b, n, d) -> float:
    return bound_s(*ivf_scan_work(b, n, d), TF32_TC_FLOPS_S)


def path_flops(ncells: int, d_cls: int, scanned: int, lq: int, d_bow: int,
               n_tok: float) -> float:
    """FLOPs one query needs on the retrieval path: its centroid scores,
    the products of its scanned cell vectors, and MaxSim over the valid
    tokens of its reranked docs."""
    return 2.0 * (ncells * d_cls + scanned * d_cls + lq * d_bow * n_tok)
