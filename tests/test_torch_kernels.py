"""The port's kernel modules on the CPU, against the JAX package.

On a CPU tensor each op takes its plain PyTorch version (the CUDA kernels
run only on the card, where ``chip_smoke.py`` holds them against these same
plain versions). Here the plain versions are held against the reference's
oracles and its Pallas kernels in interpret mode, on the shapes of
``tests/test_kernels.py``, at its tolerance of 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import maxsim as ref_core
from repro.kernels.ivf_scan.ivf_scan import ivf_scan_pallas
from repro.kernels.maxsim.maxsim import maxsim_pallas
from repro.kernels.maxsim.ref import maxsim_ref as jax_maxsim_ref
from repro_torch.core import maxsim as core
from repro_torch.kernels.ivf_scan import ops as ivf_ops
from repro_torch.kernels.ivf_scan.ref import ivf_scan_ref
from repro_torch.kernels.maxsim import ops as maxsim_ops
from repro_torch.kernels.maxsim.ref import maxsim_ref

TOL = 1e-4

MAXSIM_SHAPES = [
    (24, 37, 64, 32, 16), (32, 128, 180, 32, 16), (5, 9, 17, 128, 8),
    (1, 1, 1, 32, 16), (8, 64, 96, 64, 32), (16, 50, 33, 48, 16),
]


def maxsim_inputs(lq, k, t, d, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((lq, d)).astype(np.float32)
    qm = (r.random(lq) > 0.2).astype(np.float32)
    docs = r.standard_normal((k, t, d)).astype(np.float32)
    lens = r.integers(0, t + 1, k).astype(np.int32)
    return q, qm, docs, lens


def torch_args(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("lq,k,t,d,bk", MAXSIM_SHAPES)
def test_maxsim_plain_matches_reference(lq, k, t, d, bk):
    q, qm, docs, lens = maxsim_inputs(lq, k, t, d, seed=lq * 1000 + k)
    lens[0] = 0                        # a zero-length doc: -1e30 * sum(qm)
    ours = maxsim_ref(*torch_args(q, qm, docs, lens)).numpy()
    oracle = np.asarray(jax_maxsim_ref(*map(jnp.asarray, (q, qm, docs,
                                                          lens))))
    kernel = np.asarray(maxsim_pallas(*map(jnp.asarray, (q, qm, docs, lens)),
                                      block_docs=bk))
    np.testing.assert_allclose(ours, oracle, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ours, kernel, rtol=TOL, atol=TOL)


def test_maxsim_plain_fp16_docs_match_reference():
    q, qm, docs, lens = maxsim_inputs(24, 40, 60, 32, seed=7)
    docs16 = docs.astype(np.float16)
    ours = maxsim_ref(*torch_args(q, qm, docs16, lens)).numpy()
    oracle = np.asarray(jax_maxsim_ref(*map(jnp.asarray,
                                            (q, qm, docs16, lens))))
    np.testing.assert_allclose(ours, oracle, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,n,d", [(4, 300, 128), (32, 1000, 64), (1, 37, 32),
                                   (8, 128, 16), (3, 513, 128),
                                   (64, 3703, 128)])
def test_ivf_scan_plain_matches_pallas(b, n, d):
    r = np.random.default_rng(b * 7 + n)
    q = r.standard_normal((b, d)).astype(np.float32)
    c = r.standard_normal((n, d)).astype(np.float32)
    ours = ivf_scan_ref(*torch_args(q, c)).numpy()
    kernel = np.asarray(ivf_scan_pallas(jnp.asarray(q), jnp.asarray(c)))
    assert ours.shape == kernel.shape == (b, n)
    np.testing.assert_allclose(ours, kernel, rtol=TOL, atol=TOL)


def test_ops_on_cpu_take_plain_version_and_launch_nothing():
    maxsim_ops.maxsim.launches = 0
    ivf_ops.centroid_scores.launches = 0
    q, qm, docs, lens = torch_args(*maxsim_inputs(8, 10, 20, 32, seed=1))
    torch.testing.assert_close(maxsim_ops.maxsim(q, qm, docs, lens),
                               maxsim_ref(q, qm, docs, lens), rtol=0, atol=0)
    c = torch.randn(50, 32, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(ivf_ops.centroid_scores(q, c),
                               ivf_scan_ref(q, c), rtol=0, atol=0)
    assert maxsim_ops.maxsim.launches == 0
    assert ivf_ops.centroid_scores.launches == 0


def test_ops_reject_other_devices():
    meta = torch.empty(4, 3, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        maxsim_ops.maxsim(torch.empty(2, 8), torch.empty(2), meta,
                          torch.empty(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        ivf_ops.centroid_scores(torch.empty(2, 8),
                                torch.empty(5, 8, device="meta"))


# -- core/maxsim.py against repro.core.maxsim ---------------------------------

def test_core_maxsim_scores_match_reference():
    r = np.random.default_rng(5)
    qb = r.standard_normal((3, 6, 16)).astype(np.float32)
    qm = r.random((3, 6)) > 0.3
    db = r.standard_normal((3, 7, 9, 16)).astype(np.float32)
    dm = r.random((3, 7, 9)) > 0.4
    dm[0, 0] = False                   # an empty doc hits the finite clamp
    ours = core.maxsim_scores(*torch_args(qb, qm, db, dm)).numpy()
    ref = np.asarray(ref_core.maxsim_scores(*map(jnp.asarray,
                                                 (qb, qm, db, dm))))
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)
    q1, d1 = qb[0], db[0, 1]
    np.testing.assert_allclose(
        float(core.maxsim_single(*torch_args(q1, d1), 5)),
        float(ref_core.maxsim_single(jnp.asarray(q1), jnp.asarray(d1), 5)),
        rtol=TOL, atol=TOL)
    cls_s, bow_s = r.standard_normal(7), r.standard_normal(7)
    np.testing.assert_allclose(
        core.aggregate_scores(*torch_args(cls_s, bow_s), 0.5).numpy(),
        np.asarray(ref_core.aggregate_scores(cls_s, bow_s, 0.5)))

