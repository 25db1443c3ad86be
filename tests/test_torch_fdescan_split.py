"""The arithmetic of fdescan's tensor-core kernel, emulated in plain torch.

On the card an fp16 FDE table is scanned with wgmma, whose products take
fp16 operands. q is fp32, so the kernel splits it in two fp16 parts: each
row is scaled by a power of two so that its largest |q| lies in [1, 2)
(exact), hi = fp16(q'), lo = fp16((q' - hi) * 2^11); the two products are
summed in fp32 and the row scaled back. The kernel runs only on the card
(``chip_smoke.py``, ``tests/test_torch_card.py``); here the same steps,
written out in torch, are held to the port's ``fdescan_ref`` and the JAX
package's oracle within the card check's ``REL_TOL``, on the slice's
distribution (q ~ N(0, 1), table 0.1 N(0, 1) in fp16, D = 256) and on rows
with a wide dynamic range, all-zero rows and rows near fp16's limits. One
rounding of q to fp16, on the same seed, misses that tolerance: that is
why the split exists.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fdescan.ref import fdescan_ref as jax_fdescan_ref
from repro_torch.kernels.fdescan.ref import fdescan_ref

REL_TOL = 1e-5      # chip_smoke.py's: |err| <= 1e-5 * max(1, |ref|)
LO_SCALE = 2.0**11


def row_exponents(q):
    """e with max|q_r| = f * 2^e, f in [0.5, 1) (frexp; 0 for a zero row)."""
    return torch.frexp(q.abs().amax(dim=1))[1]


def split_scores(q, docs):
    """The kernel's steps: q (B, D) fp32, docs (N, D) fp16 -> (B, N) fp32."""
    e = row_exponents(q).double()
    qs = (q.double() * torch.pow(2.0, 1 - e)[:, None]).float()   # exact
    hi = qs.half()
    lo = ((qs - hi.float()) * LO_SCALE).half()
    table = docs.float()                    # fp16 is exact in fp32 products
    acc_hi = hi.float() @ table.T
    acc_lo = lo.float() @ table.T
    unscale = torch.pow(2.0, e - 1).float()[:, None]
    return (acc_hi + acc_lo / LO_SCALE) * unscale


def one_rounding_scores(q, docs):
    """q rounded once to fp16 (after the same row scale), fp32 sums."""
    e = row_exponents(q).double()
    qs = (q.double() * torch.pow(2.0, 1 - e)[:, None]).float().half()
    return (qs.float() @ docs.float().T) * torch.pow(2.0, e - 1).float()[
        :, None]


def slice_inputs(seed, b=64, n=4096, d=256):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, d)).astype(np.float32)
    docs = (0.1 * r.standard_normal((n, d))).astype(np.float16)
    return q, docs


def max_err(ours, ref):
    return float((ours.double() - ref.double()).abs().max())


def tol_of(ref):
    return REL_TOL * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_matches_both_oracles_on_the_slice_distribution(seed):
    q, docs = slice_inputs(seed)
    qt, dt = torch.from_numpy(q), torch.from_numpy(docs)
    ours = split_scores(qt, dt)
    ref = fdescan_ref(qt, dt)
    jax_ref = torch.from_numpy(np.array(
        jax_fdescan_ref(jnp.asarray(q), jnp.asarray(docs))))
    assert ours.shape == ref.shape == (64, 4096) and ours.dtype == torch.float32
    assert max_err(ours, ref) <= tol_of(ref)
    assert max_err(ours, jax_ref) <= tol_of(jax_ref)


def test_one_rounding_misses_the_tolerance_on_the_same_seed():
    q, docs = slice_inputs(0)
    qt, dt = torch.from_numpy(q), torch.from_numpy(docs)
    ref = fdescan_ref(qt, dt)
    assert max_err(one_rounding_scores(qt, dt), ref) > 10 * tol_of(ref)
    assert max_err(split_scores(qt, dt), ref) < tol_of(ref) / 10


def hard_rows(seed, d=256):
    """Rows whose magnitudes no single fp16 scale would hold."""
    r = np.random.default_rng(seed)
    sign = np.where(r.random((6, d)) < 0.5, -1.0, 1.0)
    return {
        # |q| log-uniform over 1e-6 .. 1e3 within one row
        "wide dynamic range": sign[0] * 10.0 ** r.uniform(-6, 3, d),
        "all zero": np.zeros(d),
        # above fp16's largest finite value (65504)
        "above fp16 max": sign[1] * r.uniform(6e4, 9e4, d),
        # below fp16's smallest subnormal (6e-8)
        "below fp16 subnormals": sign[2] * r.uniform(1e-9, 5e-8, d),
        "fp32 extremes, large": sign[3] * r.uniform(1e30, 3e30, d),
        "one large entry among small": np.r_[5e3, sign[4, 1:] * 1e-3],
    }


@pytest.mark.parametrize("kind", list(hard_rows(0)))
def test_split_holds_rows_of_any_magnitude(kind):
    row = hard_rows(0)[kind].astype(np.float32)
    r = np.random.default_rng(1)
    q = np.stack([row, r.standard_normal(row.shape[0]).astype(np.float32)])
    docs = (0.1 * r.standard_normal((1000, row.shape[0]))).astype(np.float16)
    qt, dt = torch.from_numpy(q), torch.from_numpy(docs)
    ours = split_scores(qt, dt)
    ref = fdescan_ref(qt, dt)
    jax_ref = torch.from_numpy(np.array(
        jax_fdescan_ref(jnp.asarray(q), jnp.asarray(docs))))
    assert torch.isfinite(ours).all()
    for i in range(2):
        # each row within REL_TOL of its own largest score, tighter than
        # max(1, |ref|) for the rows far below 1 (a zero row: exactly 0)
        for oracle in (ref[i], jax_ref[i]):
            assert max_err(ours[i], oracle) <= REL_TOL * float(
                oracle.abs().max())
