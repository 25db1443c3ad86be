"""The port's MoE layer (``repro_torch.models.moe``) on the CPU, against the
JAX package's ``repro.models.moe`` on the same numpy inputs and weights.

Routing is held exactly: the same expert ids in the same order (ties to
the lower index, the zero router included) and the same keep masks, the
latter also against a plain loop over the tokens. Outputs agree within
1e-5 x max(1, |ref|) in fp32 and 3e-2 in bf16 (XLA's bf16 ``logistic``
rounds otherwise than PyTorch's ``silu``); the aux loss within 1e-6 (the
reference sums 1/(T k) by scatter-add, the port scales a count); the
gradients of x and of every parameter within 1e-5 x max(1, |ref|) (fp32:
at k = 1 the router's gradient through the renormalised weights cancels
to rounding, so its error is set by terms of order 1, not by its size).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as RefMoEConfig
from repro.models import moe as ref_moe
from repro_torch.configs import MoEConfig
from repro_torch.models import moe

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
CASES = [(4, 1, False), (4, 2, False), (8, 2, True), (8, 8, False)]
D, F = 16, 32
# the reference's functions compiled whole (eager JAX compiles op by op)
ref_ffn = jax.jit(ref_moe.moe_ffn, static_argnums=(2, 3))
ref_route = jax.jit(ref_moe.route, static_argnums=2)
ref_dense_ffn = jax.jit(ref_moe.moe_ffn_dense_reference, static_argnums=2)


def cfgs(**kw):
    return RefMoEConfig(**kw), MoEConfig(**kw)


def numpy_params(seed, e, d=D, f=F, shared=False, scale=0.1):
    r = np.random.default_rng(seed)
    shapes = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
              "w_down": (e, f, d)}
    if shared:
        shapes |= {"w_gate_s": (d, f), "w_up_s": (d, f), "w_down_s": (f, d)}
    return {k: (scale * r.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


def both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in params.items()})


def to_np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def assert_rel(got, want, tol):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def keep_loop(experts, n_experts, cap):
    """The keep mask by a plain loop: token-major, then k, each expert
    taking its first ``cap`` choices of the group."""
    g, t, k = experts.shape
    keep = np.zeros((g, t * k), bool)
    for gi in range(g):
        used = np.zeros(n_experts, int)
        for i, ex in enumerate(experts[gi].reshape(-1)):
            keep[gi, i] = used[ex] < cap
            used[ex] += 1
    return keep


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("e,k,shared", CASES)
def test_scatter_matches_reference_and_dense_oracles(e, k, shared, dtype):
    """``tests/test_moe.py``'s four cases (no drops at capacity factor 16):
    the port's scatter path against the reference's, and (fp32) against
    the dense oracles, the port's held to the reference's; the aux loss
    within 1e-6."""
    jdt, tdt, tol = DTYPES[dtype]
    rc, tc = cfgs(n_experts=e, top_k=k, d_ff_expert=F, capacity_factor=16.0,
                  n_shared_experts=int(shared))
    x = np.random.default_rng(1).standard_normal((64, D)).astype(np.float32)
    jp, tp = both(numpy_params(0, e, shared=shared))
    want, want_aux = ref_ffn(jnp.asarray(x, jdt), jp, rc, jdt)
    got, aux = moe.moe_ffn(torch.from_numpy(x).to(tdt), tp, tc, tdt)
    assert got.shape == (64, D) and got.dtype == tdt
    assert_rel(got, want, tol)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    ref_dense, ref_dense_aux = ref_dense_ffn(jnp.asarray(x), jp, rc)
    dense, dense_aux = moe.moe_ffn_dense_reference(torch.from_numpy(x), tp,
                                                   tc)
    assert_rel(dense, ref_dense, 1e-5)
    assert abs(float(dense_aux) - float(ref_dense_aux)) <= 1e-6
    if dtype == "float32":   # bf16 inputs may route otherwise than fp32's
        assert_rel(got, dense, tol)


@pytest.mark.parametrize("cf", [16.0, 1.0, 0.5, 0.25])
@pytest.mark.parametrize("e,k,shared", CASES)
def test_routing_and_keep_masks_match_reference(e, k, shared, cf):
    """Three groups of 48 tokens: the same expert ids in the same order and
    the same weights as the reference's ``route``; the port's keep mask
    equal to the plain loop's over those ids; the output (drops and all)
    within fp32 rounding of the reference's."""
    rc, tc = cfgs(n_experts=e, top_k=k, d_ff_expert=F, capacity_factor=cf,
                  n_shared_experts=int(shared))
    x = np.random.default_rng(2).standard_normal((3, 48, D)).astype(
        np.float32)
    params = numpy_params(3, e, shared=shared)
    jp, tp = both(params)
    rw, rex, raux = ref_route(jnp.asarray(x), jp["router"], rc)
    w, ex, aux = moe.route(torch.from_numpy(x), tp["router"], tc)
    np.testing.assert_array_equal(ex.numpy(), np.asarray(rex))
    assert_rel(w, rw, 1e-6)
    assert abs(float(aux) - float(raux)) <= 1e-6
    cap = moe.capacity(48, tc)
    dest, keep = moe.dispatch(ex, e, cap)
    want_keep = keep_loop(ex.numpy(), e, cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert (dest.numpy()[~want_keep] == e * cap).all()
    kept = dest.numpy()[want_keep]
    for g in range(3):     # each kept choice has a slot of its own
        row = dest.numpy()[g][want_keep[g]]
        assert len(np.unique(row)) == len(row)
    assert kept.max(initial=0) < e * cap
    if cf == 16.0:
        assert want_keep.all()
    want, _ = ref_ffn(jnp.asarray(x), jp, rc, jnp.float32)
    got, _ = moe.moe_ffn(torch.from_numpy(x), tp, tc, torch.float32)
    assert_rel(got, want, 1e-5)


def test_capacity_drops_overflow_tokens():
    """``tests/test_moe.py``'s drop case: capacity 8 of 64 tokens on 2
    experts, top-1; the dropped tokens (the same as the reference's) give
    zero rows, and the port's output is the reference's."""
    rc, tc = cfgs(n_experts=2, top_k=1, d_ff_expert=8, capacity_factor=0.25)
    x = np.random.default_rng(4).standard_normal((64, 8)).astype(np.float32)
    jp, tp = both(numpy_params(5, 2, d=8, f=8))
    want, _ = ref_ffn(jnp.asarray(x), jp, rc, jnp.float32)
    got, _ = moe.moe_ffn(torch.from_numpy(x), tp, tc, torch.float32)
    assert moe.capacity(64, tc) == ref_moe.capacity(64, rc) == 8
    _, ex, _ = moe.route(torch.from_numpy(x)[None], tp["router"], tc)
    _, keep = moe.dispatch(ex, 2, 8)
    zero = np.abs(got.numpy()).max(-1) < 1e-9
    assert int((~keep).sum()) == 64 - 16 and (zero == ~keep[0].numpy()).all()
    np.testing.assert_array_equal(zero, np.abs(np.asarray(want)).max(-1)
                                  < 1e-9)
    assert_rel(got, want, 1e-5)


@pytest.mark.parametrize("e,k,cf", [(2, 1, 0.25), (4, 2, 1.25),
                                    (16, 1, 1.25), (32, 8, 1.25),
                                    (8, 8, 16.0), (64, 6, 1.0)])
def test_capacity_matches_reference(e, k, cf):
    rc, tc = cfgs(n_experts=e, top_k=k, d_ff_expert=8, capacity_factor=cf)
    for t in [0, 1, 2, 7, 8, 63, 64, 100, 1000, 1024, 4096, 32_768]:
        c = moe.capacity(t, tc)
        assert c == ref_moe.capacity(t, rc), t
        assert c % 8 == 0 and c >= 8


@pytest.mark.parametrize("k", [1, 2, 4])
def test_zero_router_ties_go_to_the_lower_index(k):
    """A zero router ties every probability: both packages pick experts
    0..k-1 for every token, and the Switch aux loss is 1.0 (uniform
    probabilities, as ``tests/test_moe.py`` pins to 0.9-1.3)."""
    rc, tc = cfgs(n_experts=4, top_k=k, d_ff_expert=8)
    x = np.random.default_rng(6).standard_normal((2, 512, 8)).astype(
        np.float32)
    params = numpy_params(7, 4, d=8, f=8)
    params["router"] = np.zeros((8, 4), np.float32)
    jp, tp = both(params)
    _, rex, raux = ref_route(jnp.asarray(x), jp["router"], rc)
    w, ex, aux = moe.route(torch.from_numpy(x), tp["router"], tc)
    np.testing.assert_array_equal(ex.numpy(), np.asarray(rex))
    assert (ex.numpy() == np.arange(k)).all()
    assert torch.equal(w, torch.full_like(w, 1 / k))
    assert abs(float(aux) - float(raux)) <= 1e-6
    assert abs(float(aux) - 1.0) <= 1e-6
    want, _ = ref_ffn(jnp.asarray(x), jp, rc, jnp.float32)
    got, _ = moe.moe_ffn(torch.from_numpy(x), tp, tc, torch.float32)
    assert_rel(got, want, 1e-5)


@pytest.mark.parametrize("cf", [16.0, 0.5])
@pytest.mark.parametrize("e,k,shared", CASES)
def test_grads_match_reference(e, k, shared, cf):
    """Gradients of sum(y * w) + aux with respect to x and every parameter,
    fp32, with and without drops, against ``jax.grad``."""
    rc, tc = cfgs(n_experts=e, top_k=k, d_ff_expert=F, capacity_factor=cf,
                  n_shared_experts=int(shared))
    r = np.random.default_rng(8)
    x = r.standard_normal((2, 40, D)).astype(np.float32)
    wy = r.standard_normal((2, 40, D)).astype(np.float32)
    params = numpy_params(9, e, shared=shared, scale=0.3)

    def ref_loss(xx, p):
        y, aux = ref_ffn(xx, p, rc, jnp.float32)
        return (y * wy).sum() + aux

    want_x, want_p = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
        jnp.asarray(x), {k_: jnp.asarray(v) for k_, v in params.items()})
    tx = torch.from_numpy(x).requires_grad_()
    tp = {k_: torch.from_numpy(v).requires_grad_() for k_, v in params.items()}
    y, aux = moe.moe_ffn(tx, tp, tc, torch.float32)
    loss = (y * torch.from_numpy(wy)).sum() + aux
    grads = torch.autograd.grad(loss, [tx, *tp.values()])
    want_p = dict(want_p, x=want_x)
    for name, g in zip(["x", *tp], grads):
        assert_rel(g, want_p[name], 1e-5)


def test_same_bits_twice_and_a_group_alone():
    """Two calls give the same bits; each group's output is its own: the
    same as that group run alone (capacity is per group)."""
    tc = MoEConfig(n_experts=8, top_k=2, d_ff_expert=F, capacity_factor=0.5)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (4, 32, D)).astype(np.float32))
    _, tp = both(numpy_params(11, 8))
    y, _ = moe.moe_ffn(x, tp, tc, torch.float32)
    again, _ = moe.moe_ffn(x, tp, tc, torch.float32)
    assert torch.equal(y, again)
    for g in range(4):
        alone, _ = moe.moe_ffn(x[g], tp, tc, torch.float32)
        torch.testing.assert_close(alone, y[g], rtol=0, atol=1e-6)


def test_config_is_the_reference_moe_config():
    for kw in (dict(n_experts=32, top_k=8, d_ff_expert=512),
               dict(n_experts=16, top_k=1, d_ff_expert=8192,
                    n_shared_experts=1)):
        rc, tc = cfgs(**kw)
        assert dataclasses.asdict(rc) == dataclasses.asdict(tc)
    assert [f.name for f in dataclasses.fields(RefMoEConfig)] == [
        f.name for f in dataclasses.fields(MoEConfig)]
