"""The arithmetic of ivf_scan's tensor-core kernel ("3xTF32"), emulated in
plain torch.

On the card the centroid scores are products on the TF32 tensor cores
(mma.sync m16n8k8, tf32 in, fp32 out). Each fp32 operand x is split into
big = tf32(x), rounded as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away
from zero, the low 13 bits zero), and small = tf32(x - big); the kernel sums
small_q.big_c and big_q.small_c and big_q.big_c in three fp32 accumulators
and adds them as (sb + bs) + bb. The kernel runs only on the card
(``chip_smoke.py``, ``tests/test_torch_card.py``); here the same steps are
held to the port's ``ivf_scan_ref`` and to the JAX package's
``ivf_scan_pallas`` (interpret mode) within the card check's ``REL_TOL``,
and ``probe_cells``' stable top-k over the emulated scores gives the
reference's probe order on the corpus ``tests/test_torch_ivf.py`` holds the
index to. One TF32 product alone misses the tolerance: that is why there
are three.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ivf as ref_ivf
from repro.data.synthetic import make_corpus
from repro.kernels.ivf_scan.ivf_scan import ivf_scan_pallas
from repro_torch.core.maxsim import topk_stable
from repro_torch.kernels.ivf_scan.ref import ivf_scan_ref

REL_TOL = 1e-5      # chip_smoke.py's: |err| <= 1e-5 * max(1, |ref|)


def tf32(x):
    """cvt.rna.tf32.f32: round the fp32 mantissa to 10 bits, to nearest,
    ties away from zero (the float's bits are sign and magnitude, so adding
    half an ulp of TF32 to them rounds the magnitude)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def split_scores(q, c):
    """The kernel's steps: q (B, D), c (N, D) fp32 -> (B, N) fp32. A
    product of two TF32 values is exact in fp32; the sums are fp32."""
    qb, qs = split(q)
    cb, cs = split(c)
    return (qs @ cb.T + qb @ cs.T) + qb @ cb.T


def unit(x):
    return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                           1e-9)).astype(np.float32)


def oracles(q, c):
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    ref = ivf_scan_ref(qt, ct)
    jax_ref = torch.from_numpy(np.array(
        ivf_scan_pallas(jnp.asarray(q), jnp.asarray(c))))
    return qt, ct, ref, jax_ref


def max_err(ours, ref):
    return float((ours.double() - ref.double()).abs().max())


def tol_of(ref):
    return REL_TOL * max(1.0, float(ref.abs().max()))


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0**-10                  # TF32's at 1.0
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      one + 3 * ulp / 2, 3.0e38, 0.0, -0.0],
                     dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp,
                         float(tf32(torch.tensor([3.0e38]))[0]), 0.0, -0.0])
    got = tf32(x)
    assert torch.equal(got, want)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    ties = x[[0, 1, 3]]              # x - big is one TF32 value here
    big, small = split(ties)
    assert torch.equal(big + small, ties)


@pytest.mark.parametrize("b,n,d,kind", [
    (64, 3703, 128, "unit"),        # the query path's shape
    (33, 130, 100, "gaussian"), (1, 37, 32, "gaussian"),
    (70, 515, 128, "wide range")])
def test_split_matches_both_oracles(b, n, d, kind):
    r = np.random.default_rng(b + n + d)
    q = r.standard_normal((b, d)).astype(np.float32)
    c = r.standard_normal((n, d)).astype(np.float32)
    if kind == "unit":
        q, c = unit(q), unit(c)
    elif kind == "wide range":
        q *= 10.0 ** r.uniform(-4, 4, (b, 1))
        c *= 10.0 ** r.uniform(-4, 4, (n, 1))
        q, c = q.astype(np.float32), c.astype(np.float32)
    qt, ct, ref, jax_ref = oracles(q, c)
    ours = split_scores(qt, ct)
    assert ours.shape == (b, n) and ours.dtype == torch.float32
    assert max_err(ours, ref) <= tol_of(ref)
    assert max_err(ours, jax_ref) <= tol_of(jax_ref)


def test_one_tf32_product_misses_the_tolerance():
    r = np.random.default_rng(0)
    q = unit(r.standard_normal((64, 128)))
    c = unit(r.standard_normal((3703, 128)))
    qt, ct, ref, _ = oracles(q, c)
    assert max_err(tf32(qt) @ tf32(ct).T, ref) > 3 * tol_of(ref)
    assert max_err(split_scores(qt, ct), ref) < tol_of(ref) / 10


@functools.lru_cache(maxsize=None)
def parity_index():
    corpus = make_corpus(n_docs=1500, n_queries=16, n_clusters=16,
                         with_bow=False, seed=3)
    return corpus, ref_ivf.build_ivf(corpus.cls, ncells=32, iters=4,
                                     quant="fp32")


@pytest.mark.parametrize("nprobe", [1, 12, 32])
def test_probe_order_on_emulated_scores_matches_reference(nprobe):
    corpus, index = parity_index()
    q = corpus.queries_cls.astype(np.float32)   # as probe_cells takes them
    scores = split_scores(torch.from_numpy(q),
                          torch.from_numpy(np.array(index.centroids)))
    _, ours = topk_stable(scores, nprobe)
    ref = ref_ivf.probe_cells(index.centroids, jnp.asarray(q), nprobe=nprobe)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
