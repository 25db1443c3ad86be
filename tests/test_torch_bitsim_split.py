"""The arithmetic of bitsim's tensor-core kernel, emulated in plain torch.

On the card the doc tokens' sign bits become fp16 +-1 (exact) and are
scored with mma.sync (fp16 in, fp32 out). q is fp32, so the kernel splits
it in two fp16 parts: query token i is scaled by the power of two that
puts its largest |q| in [1, 2) (from the float's exponent bits, clamped to
the normal range: exact), hi = fp16(q'), lo = fp16((q' - hi) * 2^11); D is
padded to a multiple of 16 with zero q columns; the two products are
summed in fp32 (v = acc_hi + 2^-11 acc_lo), rows at or past the doc's
length are set to -1e30, the max over the doc's rows is unscaled once per
query token, weighed by the mask and summed in the kernel's fixed order.
The kernel runs only on the card (``chip_smoke.py``,
``tests/test_torch_card.py``); here the same steps, written out in torch,
are held to the port's ``bitsim_ref`` and to the JAX package's
``bitsim_pallas`` (interpret mode) within the card check's ``REL_TOL``, on
the bit filter's distribution (unit q of 24 x 32, the signs of normal doc
tokens, Pareto lengths as ``chip_smoke.py`` draws them) and on its edges:
zero-length docs, lengths above T, D = 40 in two lanes, uint8 lanes
re-viewed as 32-bit ones, Lq of 1 and 32. One rounding of q to fp16, on the
same seed, misses that tolerance: that is why the split exists.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitsim.bitsim import bitsim_pallas
from repro_torch.core.quantize import binary_pack, to_uint32_lanes
from repro_torch.kernels.bitsim.ref import NEG, bitsim_ref, unpack_bits

REL_TOL = 1e-5      # chip_smoke.py's: |err| <= 1e-5 * max(1, |ref|)
LO_SCALE = 2.0**11
T = 180             # the bit filter's t_max


def scales(q):
    """Each query token's scale 2^(127 - be) and unscale 2^(be - 127), be
    the biased exponent of its largest |q| clamped to [1, 253]."""
    mx = q.abs().amax(dim=1)
    be = ((mx.view(torch.int32) >> 23) & 0xFF).clamp(1, 253).double()
    return torch.pow(2.0, 127 - be).float(), torch.pow(2.0, be - 127).float()


def fixed_sum(vals):
    """The kernel's sum of (K, Lq) weighed maxima: lane i holds query token
    i (0 past Lq), and a butterfly of xor-shuffles (16, 8, 4, 2, 1) sums
    the 32 lanes; lane 0's value is the score."""
    v = torch.nn.functional.pad(vals, (0, 32 - vals.shape[1]))
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ off]
    return v[:, 0]


def split_bitsim(q, q_mask, docs_packed, lens):
    """The kernel's steps: q (Lq, D) fp32, docs_packed (K, T, W) 32-bit
    lanes, lens (K,) int32 -> (K,) fp32."""
    lq, d = q.shape
    d_pad = -(-d // 16) * 16
    scale, unscale = scales(q)
    qs = torch.nn.functional.pad(q * scale[:, None], (0, d_pad - d))
    hi = qs.half()
    lo = ((qs - hi.float()) * LO_SCALE).half()
    # pad bits past d multiply zero q columns (the kernel reads its own
    # choice of them; any choice gives the same zeros)
    sgn = unpack_bits(docs_packed, d_pad)             # exact +-1
    acc_hi = torch.einsum("qd,ktd->kqt", hi.float(), sgn)
    acc_lo = torch.einsum("qd,ktd->kqt", lo.float(), sgn)
    # fmaf(acc_lo, 2^-11, acc_hi): one rounding
    v = (acc_lo.double() / LO_SCALE + acc_hi.double()).float()
    t = docs_packed.shape[1]
    n = lens.clamp(0, t)
    live = torch.arange(t)[None, None, :] < n[:, None, None]
    m = torch.where(live, v, torch.tensor(NEG)).amax(-1)       # (K, Lq)
    m = torch.where((n == 0)[:, None], torch.tensor(NEG),
                    m * unscale[None, :])
    return fixed_sum(m * q_mask[None, :])


def one_rounding_bitsim(q, q_mask, docs_packed, lens):
    """q rounded once to fp16 (after the same scale), fp32 sums."""
    scale, unscale = scales(q)
    q16 = (q * scale[:, None]).half().float() * unscale[:, None]
    return bitsim_ref(q16, q_mask, docs_packed, lens)


def unit(x):
    return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                           1e-9)).astype(np.float32)


def pack(r, k, t, d, lanes="uint32"):
    """The signs of normal doc tokens in 32-bit lanes, with the pad bits
    past d set at random (they must not count)."""
    packed = to_uint32_lanes(binary_pack(
        r.standard_normal((k, t, d)).astype(np.float32), dtype=lanes))
    if d % 32:
        pad = r.integers(0, 2**32, packed.shape[:2], dtype=np.uint64)
        packed[..., -1] |= (pad.astype(np.uint32)
                            & np.uint32(~((1 << (d % 32)) - 1) & 0xFFFFFFFF))
    return packed


def slice_inputs(seed, k=500, lq=24, d=32, lanes="uint32"):
    r = np.random.default_rng(seed)
    q = unit(r.standard_normal((lq, d)))
    packed = pack(r, k, T, d, lanes)
    lens = np.clip((r.pareto(2.5, k) + 1) * 36, 8, T).astype(np.int32)
    return q, np.ones(lq, np.float32), packed, lens


def oracles(q, qm, packed, lens):
    args = tuple(map(torch.from_numpy, (q, qm, packed.view(np.int32), lens)))
    ref = bitsim_ref(*args)
    jax_ref = torch.from_numpy(np.array(bitsim_pallas(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(packed),
        jnp.asarray(lens), d=q.shape[1])))
    return args, ref, jax_ref


def check(ours, ref, lens):
    """Docs with a token within REL_TOL x max(1, |ref|); zero-length docs
    (-1e30 x the unmasked tokens) within 1e-6 relative."""
    live = torch.from_numpy(lens > 0)
    if live.any():
        tol = REL_TOL * max(1.0, float(ref[live].abs().max()))
        assert float((ours[live] - ref[live]).abs().max()) <= tol
    if (~live).any():
        assert torch.allclose(ours[~live], ref[~live], rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_matches_both_oracles_on_the_slice_distribution(seed):
    q, qm, packed, lens = slice_inputs(seed)
    args, ref, jax_ref = oracles(q, qm, packed, lens)
    ours = split_bitsim(*args)
    assert ours.shape == (500,) and ours.dtype == torch.float32
    check(ours, ref, lens)
    check(ours, jax_ref, lens)


def test_one_rounding_misses_the_tolerance_on_the_same_seed():
    q, qm, packed, lens = slice_inputs(0)
    args, ref, _ = oracles(q, qm, packed, lens)
    tol = REL_TOL * max(1.0, float(ref.abs().max()))
    assert float((one_rounding_bitsim(*args) - ref).abs().max()) > 3 * tol
    assert float((split_bitsim(*args) - ref).abs().max()) < tol / 10


def edge_inputs(kind):
    r = np.random.default_rng(7)
    lq = {"Lq=1": 1, "Lq=32, wide q": 32}.get(kind, 24)
    d = 40 if kind == "D=40 in two lanes" else 32
    lanes = "uint8" if kind == "uint8 lanes re-viewed" else "uint32"
    q, qm, packed, lens = slice_inputs(3, k=64, lq=lq, d=d, lanes=lanes)
    if kind == "zero-length docs":
        lens[::5] = 0
        qm = (r.random(lq) > 0.3).astype(np.float32)
    elif kind == "lengths 0, T and above T":
        lens[:6] = [0, T, T + 1, 10 * T, 1, 16]
    elif kind == "Lq=32, wide q":
        q = (r.standard_normal((32, d)) * 10.0 ** r.uniform(-3, 3, (32, 1))
             ).astype(np.float32)
    return q, qm, packed, lens


@pytest.mark.parametrize("kind", ["zero-length docs", "Lq=1",
                                  "lengths 0, T and above T",
                                  "D=40 in two lanes",
                                  "uint8 lanes re-viewed", "Lq=32, wide q"])
def test_split_holds_the_edges(kind):
    q, qm, packed, lens = edge_inputs(kind)
    if kind == "D=40 in two lanes":
        assert packed.shape[2] == 2
    args, ref, jax_ref = oracles(q, qm, packed, lens)
    ours = split_bitsim(*args)
    assert torch.isfinite(ours).all()
    check(ours, ref, lens)
    check(ours, jax_ref, lens)


def test_uint8_lanes_re_viewed_are_the_same_bits():
    """binary_pack's uint8 lanes, re-viewed as 32-bit ones, are the uint32
    packing's lanes bit for bit, so the kernel reads them as they are."""
    x = np.random.default_rng(5).standard_normal((9, 20, 40)).astype(
        np.float32)
    assert np.array_equal(to_uint32_lanes(binary_pack(x, dtype="uint8")),
                          binary_pack(x, dtype="uint32"))


def test_fixed_sum_is_the_plain_sum_within_rounding():
    vals = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (50, 24)).astype(np.float32))
    torch.testing.assert_close(fixed_sum(vals), vals.sum(-1), rtol=1e-6,
                               atol=1e-6)
