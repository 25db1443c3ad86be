"""The reference's perf-iteration knobs in the port (``remat``,
``causal_skip``, ``score_dtype``, ``onehot_cache_update``; ``unroll`` has no
effect on the port), against the JAX package on the CPU: each case of the
reference's ``tests/test_perf_flags.py`` port against reference, at its
tolerances, from the same numpy inputs and weights.

Then what the knobs must leave alone: ``remat`` on equals ``remat`` off
bit for bit (loss and every gradient) for a dense LM, an MoE LM and
ColBERTer; with ``remat`` the backward of a 4-layer loss keeps the layers'
inputs and no more than one layer's working set (saved tensors counted by
``torch.autograd.graph.saved_tensors_hooks``); and ``blockwise_attention``'s
per-chunk recompute gives the gradients of the same steps run without
checkpoints (1e-6) while keeping no (chunk x Sq) block of any chunk.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import colberter as ref_col
from repro.models import transformer as ref_tf
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention, colberter, transformer

# the reference's four cases: (port kwargs, reference kwargs, tolerance)
ATTN_FLAGS = [
    (dict(unroll=True), dict(unroll=True), 1e-4),
    (dict(causal_skip=True), dict(causal_skip=True), 1e-4),
    (dict(causal_skip=True, unroll=True), dict(causal_skip=True, unroll=True),
     1e-4),
    (dict(score_dtype=torch.bfloat16), dict(score_dtype=jnp.bfloat16), 0.05),
]


def lm_setup(arch, **overrides):
    """The reference's smoke config of ``arch`` in fp32 (and the port's),
    its ``init_params(PRNGKey(0))`` carried across as numpy."""
    ref = ref_tf.smoke_config(ref_get_config(arch)).scaled(dtype=jnp.float32,
                                                           **overrides)
    port = transformer.smoke_config(get_config(arch)).scaled(
        dtype=torch.float32, **overrides)
    params = jax.tree.map(np.asarray,
                          ref_tf.init_params(ref, jax.random.PRNGKey(0)))
    return ref, port, params


def lm_batch(cfg, seed=0, shape=(2, 64)):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)
    return {"tokens": toks, "targets": toks}


def tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("port_kw,ref_kw,tol", ATTN_FLAGS)
def test_attention_flag_equivalence(port_kw, ref_kw, tol):
    """The reference's shapes (B 2, S 48, H 6, KV 3, Dh 16, chunk 12): the
    port's flagged ``blockwise_attention`` within ``tol`` of the
    reference's ``reference_attention`` and of its flagged
    ``blockwise_attention``."""
    r = np.random.default_rng(0)
    q = r.standard_normal((2, 48, 6, 16)).astype(np.float32)
    k = r.standard_normal((2, 48, 3, 16)).astype(np.float32)
    v = r.standard_normal((2, 48, 3, 16)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out = attention.blockwise_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True, chunk=12,
        **port_kw).numpy()
    naive = np.asarray(ref_attn.reference_attention(jq, jk, jv, causal=True))
    flagged = np.asarray(ref_attn.blockwise_attention(
        jq, jk, jv, causal=True, chunk=12, **ref_kw))
    assert float(np.abs(out - naive).max()) < tol
    assert float(np.abs(out - flagged).max()) < tol


def test_transformer_causal_skip_loss_equal():
    """smollm-135m's smoke config in fp32, batch (2, 64): the port's loss
    with and without ``causal_skip`` within 1e-5 of the reference's (with
    and without)."""
    ref, port, params = lm_setup("smollm-135m")
    batch = lm_batch(ref)
    jp = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = [float(ref_tf.loss_fn(ref.scaled(causal_skip=s), jp, jb)[0])
            for s in (False, True)]
    model = convert.transformer_params_from_numpy(params, port, "cpu")
    with torch.no_grad():
        got = [float(transformer.loss_fn(port.scaled(causal_skip=s), model,
                                         tensors(batch))[0])
               for s in (False, True)]
    assert abs(want[0] - want[1]) < 1e-5
    for g in got:
        assert abs(g - want[0]) < 1e-5


def test_decode_onehot_update_equal(monkeypatch):
    """qwen2-0.5b's smoke config in fp32, 4 decode steps into an empty
    cache of 8 slots: with ``onehot_cache_update`` the port's logits and
    cache are the reference's (logits 1e-5 as the reference's own test,
    cache 1e-5 as ``tests/test_torch_transformer.py`` holds the packages'
    caches: k and v are projected in another order; slot positions
    exactly), and the port's ``write_slot`` path's bit for bit (the
    reference holds its two paths within 1e-6); the decode attention goes
    to ``flash_decode`` once a layer a step either way."""
    calls = []
    decode = transformer.flash_decode
    monkeypatch.setattr(transformer, "flash_decode",
                        lambda *a: calls.append(1) or decode(*a))
    ref, port, params = lm_setup("qwen2-0.5b")
    ref1 = ref.scaled(onehot_cache_update=True)
    model = convert.transformer_params_from_numpy(params, port, "cpu")
    jp = jax.tree.map(jnp.asarray, params)
    toks = np.random.default_rng(1).integers(0, ref.vocab_size,
                                             (2, 6)).astype(np.int32)
    c_ref = ref_tf.init_cache(ref1, 2, 8)
    c_hot = transformer.init_cache(port, 2, 8, device="cpu")
    c_slot = transformer.init_cache(port, 2, 8, device="cpu")
    for i in range(4):
        pos = np.full((2,), i, np.int32)
        lg_ref, c_ref = ref_tf.decode_step(ref1, jp, jnp.asarray(
            toks[:, i:i + 1]), jnp.asarray(pos), c_ref)
        lg_hot, c_hot = transformer.decode_step(
            port.scaled(onehot_cache_update=True), model,
            torch.from_numpy(toks[:, i:i + 1]), torch.from_numpy(pos), c_hot)
        lg_slot, c_slot = transformer.decode_step(
            port, model, torch.from_numpy(toks[:, i:i + 1]),
            torch.from_numpy(pos), c_slot)
        np.testing.assert_allclose(lg_hot.numpy(), np.asarray(lg_ref),
                                   atol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(c_hot[name].numpy(),
                                       np.asarray(c_ref[name]), atol=1e-5)
            assert torch.equal(c_hot[name], c_slot[name])
        np.testing.assert_array_equal(c_hot["slot_pos"].numpy(),
                                      np.asarray(c_ref["slot_pos"]))
        assert torch.equal(lg_hot, lg_slot)
        assert torch.equal(c_hot["slot_pos"], c_slot["slot_pos"])
    assert len(calls) == 2 * 4 * port.n_layers


# -- remat: the same bits, less kept ------------------------------------------

def _lm_loss_and_grads(cfg, model, batch):
    loss, _ = transformer.loss_fn(cfg, model, batch)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


def _colberter_loss_and_grads(cfg, model, batch):
    loss, _ = colberter.contrastive_loss(cfg, model, batch)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


def _colberter_setup():
    ref = ref_col.smoke_config(ref_get_config("colberter")).scaled(
        dtype=jnp.float32)
    cfg = colberter.smoke_config(get_config("colberter")).scaled(
        dtype=torch.float32)
    params = jax.tree.map(np.asarray,
                          ref_col.init_params(ref, jax.random.PRNGKey(0)))
    model = convert.colberter_params_from_numpy(params, cfg, "cpu")
    r = np.random.default_rng(2)
    q = r.integers(1, cfg.vocab_size, (4, cfg.max_query_len))
    d = r.integers(1, cfg.vocab_size, (4, cfg.max_doc_len))
    q[:, 0] = d[:, 0] = 0
    q[1, 5:] = d[2, 9:] = -1
    batch = {"query_tokens": torch.from_numpy(q.astype(np.int32)),
             "pos_doc_tokens": torch.from_numpy(d.astype(np.int32))}
    return cfg, model, batch


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m",
                                  "colberter"])
def test_remat_is_bit_for_bit(arch):
    """One model, one batch: the loss and every gradient with ``remat`` on
    and off are the same bits (fp32; the MoE layers route the same tokens
    when a layer is run again)."""
    if arch == "colberter":
        cfg, model, batch = _colberter_setup()
        run = _colberter_loss_and_grads
    else:
        _, cfg, params = lm_setup(arch, n_layers=3)
        model = convert.transformer_params_from_numpy(params, cfg, "cpu")
        batch = tensors(lm_batch(cfg, seed=3, shape=(2, 80)))
        run = _lm_loss_and_grads
    assert not cfg.remat           # the smoke configs' default, as the
    off = run(cfg, model, batch)   # reference's
    on = run(cfg.scaled(remat=True), model, batch)
    assert torch.equal(on[0], off[0])
    assert len(on[1]) == len(off[1]) > 0
    for g_on, g_off in zip(on[1], off[1]):
        assert torch.equal(g_on, g_off)


def saved_bytes(fn) -> tuple[int, list]:
    """The bytes of the distinct storages that autograd keeps for the
    backward while ``fn()`` runs its forward, and the packed tensors'
    shapes."""
    seen, shapes = {}, []

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values()), shapes


def test_remat_keeps_the_layer_inputs():
    """smollm-135m's smoke config at 4 layers, batch (2, 128) in fp32: with
    ``remat`` the forward keeps at most the 4 layers' inputs (B, S, D) and
    what a 1-layer model keeps without remat (one layer's working set, the
    embedding, the head and the loss), and under half of what 4 layers
    keep without it."""
    _, cfg, params = lm_setup("smollm-135m", n_layers=4)
    batch = tensors(lm_batch(cfg, seed=4, shape=(2, 128)))
    model = convert.transformer_params_from_numpy(params, cfg, "cpu")
    _, one_cfg, one_params = lm_setup("smollm-135m", n_layers=1)
    one = convert.transformer_params_from_numpy(one_params, one_cfg, "cpu")

    def kept(c, m):
        return saved_bytes(lambda: transformer.loss_fn(c, m, batch))[0]

    with_remat = kept(cfg.scaled(remat=True), model)
    without = kept(cfg, model)
    one_layer = kept(one_cfg, one)
    layer_inputs = cfg.n_layers * 2 * 128 * cfg.d_model * 4
    assert with_remat <= layer_inputs + one_layer
    assert with_remat < without / 2


def test_blockwise_attention_recomputes_each_chunk(monkeypatch):
    """GQA (H 6, KV 2), Sq 40 in chunks of 8, causal and not: the
    gradients with the per-chunk checkpoint equal those of the same steps
    run without it within 1e-6 x max(1, |g|), and the backward keeps no
    (B, Sq, KV, G, chunk) score or probability block of any chunk (it keeps
    them all without the checkpoint)."""
    r = np.random.default_rng(5)
    b, sq, h, kv, dh, chunk = 2, 40, 6, 2, 16, 8
    shapes = ((b, sq, h, dh), (b, sq, kv, dh), (b, sq, kv, dh))
    base = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
            for s in shapes]
    w = torch.from_numpy(r.standard_normal(shapes[0]).astype(np.float32))

    def blocks(kept):
        return sum(s == (b, sq, kv, h // kv, chunk) for s in kept)

    def run(causal):
        leaves = [t.clone().requires_grad_() for t in base]
        out = []
        kept = saved_bytes(lambda: out.append(attention.blockwise_attention(
            *leaves, causal=causal, chunk=chunk)))
        grads = torch.autograd.grad((out[0] * w).sum(), leaves)
        return grads, kept[1]

    for causal in (True, False):
        got, kept = run(causal)
        assert kept and blocks(kept) == 0
        with monkeypatch.context() as m:
            m.setattr(attention, "checkpoint",
                      lambda fn, *a, **_: fn(*a))
            want, kept_all = run(causal)
        assert blocks(kept_all) >= sq // chunk
        for g, wg in zip(got, want):
            scale = max(1.0, float(wg.abs().max()))
            assert float((g - wg).abs().max()) <= 1e-6 * scale
