"""The arithmetic of maxsim's tensor-core kernel, emulated in plain torch.

On the card fp16 doc tiles are scored with mma.sync (fp16 in, fp32 out).
q is fp32, so the kernel splits it in two fp16 parts: query token i is
scaled by the power of two that puts its largest |q| in [1, 2) (taken from
the float's exponent bits, clamped to the normal range: exact), hi =
fp16(q'), lo = fp16((q' - hi) * 2^11); the two products are summed in fp32
(v = acc_hi + 2^-11 acc_lo), rows at or past the doc's length are set to
-1e30, the max over 16-row tiles and then over a doc's tiles is unscaled
once per query token, weighed by the mask and summed. The kernel runs only
on the card (``chip_smoke.py``, ``tests/test_torch_card.py``); here the
same steps, written out in torch, are held to the port's ``maxsim_ref`` and
to the JAX package's ``maxsim_pallas`` (interpret mode) within the card
check's ``REL_TOL``, on the slice's distribution (unit q of 24 x 32, unit
fp16 docs, Pareto lengths as ``chip_smoke.py`` draws them) and on
zero-length docs, Lq = 1, a masked q and lengths above T. One rounding of q
to fp16, on the same seed, misses that tolerance: that is why the split
exists.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.maxsim.maxsim import maxsim_pallas
from repro_torch.kernels.maxsim.ref import NEG, maxsim_ref

REL_TOL = 1e-5      # chip_smoke.py's: |err| <= 1e-5 * max(1, |ref|)
LO_SCALE = 2.0**11
T, D = 180, 32      # the rerank's tiles


def scales(q):
    """Each query token's scale 2^(127 - be) and unscale 2^(be - 127), be
    the biased exponent of its largest |q| clamped to [1, 253]."""
    mx = q.abs().amax(dim=1)
    be = ((mx.view(torch.int32) >> 23) & 0xFF).clamp(1, 253).double()
    return torch.pow(2.0, 127 - be).float(), torch.pow(2.0, be - 127).float()


def split_maxsim(q, q_mask, docs, lens):
    """The kernel's steps: q (Lq, D) fp32, docs (K, T, D) fp16, lens (K,)
    int32 -> (K,) fp32."""
    scale, unscale = scales(q)
    qs = q * scale[:, None]                                   # exact
    hi = qs.half()
    lo = ((qs - hi.float()) * LO_SCALE).half()
    d = docs.float()                        # fp16 is exact in fp32 products
    acc_hi = torch.einsum("qd,ktd->kqt", hi.float(), d)
    acc_lo = torch.einsum("qd,ktd->kqt", lo.float(), d)
    # fmaf(acc_lo, 2^-11, acc_hi): one rounding
    v = (acc_lo.double() / LO_SCALE + acc_hi.double()).float()
    t = docs.shape[1]
    n = lens.clamp(0, t)
    live = torch.arange(t)[None, None, :] < n[:, None, None]
    v = torch.where(live, v, torch.tensor(NEG))
    # the max over each 16-row tile, then over the doc's tiles
    pad = -t % 16
    tiles = torch.nn.functional.pad(v, (0, pad), value=NEG)
    m = tiles.reshape(*v.shape[:2], -1, 16).amax(-1).amax(-1)   # (K, Lq)
    m = torch.where((n == 0)[:, None], torch.tensor(NEG),
                    m * unscale[None, :])
    return (m * q_mask[None, :]).sum(-1)


def one_rounding_maxsim(q, q_mask, docs, lens):
    """q rounded once to fp16 (after the same scale), fp32 sums."""
    scale, unscale = scales(q)
    q16 = (q * scale[:, None]).half().float() * unscale[:, None]
    return maxsim_ref(q16, q_mask, docs, lens)


def unit(x):
    return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                           1e-9)).astype(np.float32)


def slice_inputs(seed, k=500, lq=24):
    r = np.random.default_rng(seed)
    q = unit(r.standard_normal((lq, D)))
    docs = unit(r.standard_normal((k, T, D))).astype(np.float16)
    lens = np.clip((r.pareto(2.5, k) + 1) * 36, 8, T).astype(np.int32)
    return q, np.ones(lq, np.float32), docs, lens


def oracles(q, qm, docs, lens):
    qt, mt, dt, lt = map(torch.from_numpy, (q, qm, docs, lens))
    ref = maxsim_ref(qt, mt, dt, lt)
    # the JAX kernel takes one dtype: the fp16 docs widened (exactly)
    jax_ref = torch.from_numpy(np.array(maxsim_pallas(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(docs.astype(np.float32)),
        jnp.asarray(np.minimum(lens, docs.shape[1])))))
    return (qt, mt, dt, lt), ref, jax_ref


def check(ours, ref, lens):
    """Docs with a token within REL_TOL x max(1, |ref|); zero-length docs
    (-1e30 x the unmasked tokens) within 1e-6 relative."""
    live = torch.from_numpy(lens > 0)
    tol = REL_TOL * max(1.0, float(ref[live].abs().max())) \
        if live.any() else 0.0
    if live.any():
        assert float((ours[live] - ref[live]).abs().max()) <= tol
    if (~live).any():
        assert torch.allclose(ours[~live], ref[~live], rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_matches_both_oracles_on_the_slice_distribution(seed):
    q, qm, docs, lens = slice_inputs(seed)
    args, ref, jax_ref = oracles(q, qm, docs, lens)
    ours = split_maxsim(*args)
    assert ours.shape == (500,) and ours.dtype == torch.float32
    check(ours, ref, lens)
    check(ours, jax_ref, lens)


def test_one_rounding_misses_the_tolerance_on_the_same_seed():
    q, qm, docs, lens = slice_inputs(0)
    args, ref, _ = oracles(q, qm, docs, lens)
    tol = REL_TOL * max(1.0, float(ref.abs().max()))
    assert float((one_rounding_maxsim(*args) - ref).abs().max()) > 3 * tol
    assert float((split_maxsim(*args) - ref).abs().max()) < tol / 10


def edge_inputs(kind):
    r = np.random.default_rng(7)
    lq = 1 if kind == "Lq=1" else 24
    q, qm, docs, lens = slice_inputs(3, k=64, lq=lq)
    if kind == "zero-length docs":
        lens[::5] = 0
    elif kind == "masked q":
        qm = (r.random(lq) > 0.3).astype(np.float32)
    elif kind == "lengths 0, T and above T":
        lens[:6] = [0, T, T + 1, 10 * T, 1, 16]
    elif kind == "Lq=32, wide q":
        q = (r.standard_normal((32, D)) * 10.0 ** r.uniform(-3, 3, (32, 1))
             ).astype(np.float32)
        qm = np.ones(32, np.float32)
    return q, qm, docs, lens


@pytest.mark.parametrize("kind", ["zero-length docs", "Lq=1", "masked q",
                                  "lengths 0, T and above T",
                                  "Lq=32, wide q"])
def test_split_holds_the_edges(kind):
    q, qm, docs, lens = edge_inputs(kind)
    args, ref, jax_ref = oracles(q, qm, docs, lens)
    ours = split_maxsim(*args)
    assert torch.isfinite(ours).all()
    check(ours, ref, lens)
    check(ours, jax_ref, lens)


@pytest.mark.parametrize("row", [
    np.zeros(D), np.full(D, 1e-40), np.full(D, 3e38),
    np.r_[5e3, np.full(D - 1, 1e-3)], np.linspace(-1.0, 1.0, D)])
def test_scale_puts_the_largest_entry_in_one_to_two(row):
    q = torch.tensor(np.stack([row, np.ones(D)]), dtype=torch.float32)
    scale, unscale = scales(q)
    assert torch.isfinite(scale).all() and torch.isfinite(unscale).all()
    assert (scale * unscale == 1).all()       # powers of two, inverse
    top = (q.abs().amax(dim=1) * scale)
    normal = q.abs().amax(dim=1) >= 2.0**-126
    small = q.abs().amax(dim=1) < 2.0**127
    assert ((top >= 1) & (top < 2))[normal & small].all()
    assert (top < 2)[~normal].all()           # clamped: no overflow
