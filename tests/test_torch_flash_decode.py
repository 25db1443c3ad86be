"""The flash_decode op of the port against the JAX package.

On a CPU tensor the op takes its plain PyTorch version (``ref.py``); the
CUDA kernel runs only on the card, where ``chip_smoke.py`` and
``tests/test_torch_card.py`` hold it against that same plain version. Here
the plain version is held against the reference's oracle
``flash_decode_ref``, its Pallas kernel in interpret mode and the model's
``decode_attention``, on the shapes and at the tolerances of
``tests/test_flash_decode.py``. The Pallas kernel averages its zero pad
rows at a length of 0, the oracle does not, so lengths of 0 are held only
to the oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels.flash_decode.flash_decode import flash_decode_pallas
from repro.kernels.flash_decode.ref import flash_decode_ref as jax_ref
from repro.models.attention import decode_attention as jax_decode_attention
from repro_torch.kernels.flash_decode import ops
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.models import attention

SHAPES = [(2, 128, 2, 4, 64, 32), (1, 300, 4, 2, 32, 64),
          (3, 64, 1, 8, 128, 64), (2, 100, 3, 3, 16, 512)]
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2),
          "float16": (jnp.float16, torch.float16, 1e-2)}


def inputs(b, s, kv, g, dh, seed, lens=None):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, kv, g, dh)).astype(np.float32)
    kc = r.standard_normal((b, s, kv, dh)).astype(np.float32)
    vc = r.standard_normal((b, s, kv, dh)).astype(np.float32)
    lens = (r.integers(1, s + 1, b) if lens is None else np.asarray(lens))
    return q, kc, vc, lens.astype(np.int32)


def plain(*arrays):
    return flash_decode_ref(*map(torch.from_numpy, arrays)).numpy()


@pytest.mark.parametrize("b,s,kv,g,dh,chunk", SHAPES)
def test_plain_matches_oracle_and_pallas(b, s, kv, g, dh, chunk):
    args = inputs(b, s, kv, g, dh, seed=s * 10 + dh)
    ours = plain(*args)
    np.testing.assert_allclose(ours, np.asarray(jax_ref(*map(jnp.asarray,
                                                             args))),
                               atol=2e-5)
    kernel = flash_decode_pallas(*map(jnp.asarray, args), chunk=chunk)
    np.testing.assert_allclose(ours, np.asarray(kernel), atol=2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_dtypes_match_oracle_and_pallas(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, kc, vc, _ = inputs(2, 96, 2, 4, 32, seed=11)
    lens = np.array([96, 40], np.int32)
    jargs = [jnp.asarray(a, jdt) for a in (q, kc, vc)] + [jnp.asarray(lens)]
    # the same rounded values on both sides
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
             for a in jargs[:3]] + [torch.from_numpy(lens)]
    ours = flash_decode_ref(*targs)
    assert ours.dtype == tdt
    for want in (jax_ref(*jargs), flash_decode_pallas(*jargs, chunk=32)):
        err = np.abs(ours.float().numpy()
                     - np.asarray(want.astype(jnp.float32))).max()
        assert err < tol
    # all fp32 inside: only the output is rounded to the inputs' dtype
    wide = flash_decode_ref(*[t.float() for t in targs[:3]], targs[3])
    assert torch.equal(ours, wide.to(tdt))


def test_plain_matches_model_decode_attention():
    b, s, kv, g, dh, length = 2, 80, 2, 3, 16, 50
    q, kc, vc, lens = inputs(b, s, kv, g, dh, seed=5, lens=[length] * b)
    slot = np.where(np.arange(s) < length, np.arange(s),
                    np.iinfo(np.int32).max).astype(np.int32)
    slot = np.broadcast_to(slot, (b, s)).copy()
    q1 = q.reshape(b, 1, kv * g, dh)
    model_out = np.asarray(jax_decode_attention(
        *map(jnp.asarray, (q1, kc, vc, slot)))).reshape(b, kv, g, dh)
    np.testing.assert_allclose(plain(q, kc, vc, lens), model_out, atol=2e-5)
    ours = attention.decode_attention(*map(torch.from_numpy,
                                           (q1, kc, vc, slot)))
    np.testing.assert_allclose(ours.numpy().reshape(b, kv, g, dh),
                               model_out, atol=2e-5)


@settings(max_examples=15, deadline=None)
@given(b=st.integers(1, 3), s=st.integers(2, 120), kv=st.integers(1, 4),
       g=st.integers(1, 4), chunk=st.sampled_from([16, 64, 512]),
       seed=st.integers(0, 2**16))
def test_plain_hypothesis(b, s, kv, g, chunk, seed):
    args = inputs(b, s, kv, g, 16, seed)
    ours = plain(*args)
    np.testing.assert_allclose(ours, np.asarray(jax_ref(*map(jnp.asarray,
                                                             args))),
                               atol=2e-5)
    kernel = flash_decode_pallas(*map(jnp.asarray, args), chunk=chunk)
    np.testing.assert_allclose(ours, np.asarray(kernel), atol=2e-5)


@pytest.mark.parametrize("lens", [[0, 0], [0, 57], [101, 100], [1000, 3],
                                  [-4, 100]])
def test_lengths_zero_and_above_s_follow_the_oracle(lens):
    """A length of 0 (or less) weights all S slots equally, the mean of v;
    a length above S counts as S."""
    s = 100
    q, kc, vc, lens = inputs(2, s, 3, 2, 16, seed=3, lens=lens)
    ours = plain(q, kc, vc, lens)
    np.testing.assert_allclose(
        ours, np.asarray(jax_ref(*map(jnp.asarray, (q, kc, vc, lens)))),
        atol=2e-5)
    full = plain(q, kc, vc, np.full(2, s, np.int32))
    for b, n in enumerate(lens):
        if n <= 0:
            mean = vc[b].mean(axis=0)                        # (KV, Dh)
            np.testing.assert_allclose(
                ours[b], np.broadcast_to(mean[:, None], ours[b].shape),
                atol=1e-6)
        elif n >= s:
            np.testing.assert_array_equal(ours[b], full[b])


def test_op_on_cpu_takes_plain_version_and_launches_nothing():
    ops.flash_decode.launches = 0
    args = [torch.from_numpy(a) for a in inputs(2, 40, 3, 3, 64, seed=1)]
    torch.testing.assert_close(ops.flash_decode(*args),
                               flash_decode_ref(*args), rtol=0, atol=0)
    assert ops.flash_decode.launches == 0


def test_op_rejects_other_devices():
    meta = torch.empty(2, 10, 3, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_decode(torch.empty(2, 3, 3, 64, device="meta"), meta, meta,
                         torch.empty(2, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("s,groups,sms", [(4128, 8, 132), (32_768, 8, 132),
                                          (100, 2, 132), (1, 1, 132),
                                          (300, 600, 132), (4097, 8, 16),
                                          (4128, 24, 132), (32_768, 24, 132)])
def test_split_slots_cover_the_cache(s, groups, sms):
    """Every slot in exactly one split; one wave of two blocks an SM at
    most; the decode path's two contexts (B=8 sequences, one head tile
    each) put at least two blocks on each of the H100's 132 SMs."""
    split, n = ops.split_slots(s, groups, sms)
    assert split % 16 == 0 and n >= 1
    owner = np.zeros(s, np.int64)
    for sp in range(n):
        owner[sp * split:min((sp + 1) * split, s)] += 1
    assert (owner == 1).all() and (n - 1) * split < s
    assert groups * n <= max(groups, 2 * sms + groups)
    if (s, groups, sms) in ((4128, 8, 132), (32_768, 8, 132)):
        assert groups * n >= 2 * 132 and split >= 64