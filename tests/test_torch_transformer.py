"""The port's dense transformer (``repro_torch.models``) on the CPU, against
the JAX package on the same numpy inputs and weights.

fp32 runs in both packages agree to rounding: layers and logits within
1e-5 x max(1, |ref|), caches within 1e-5. bf16 rounds at other places in the
two frameworks: XLA's bf16 ``logistic`` (inside ``jax.nn.silu``) rounds
otherwise than PyTorch's ``silu`` (a third of bf16 inputs differ). The
decode path's logits agree within 3e-2 x max(1, |ref|) (the measured gap
between the reference's own decode attention and flash_decode's oracle is
9.8e-3), and the port's greedy token is the reference's, or one whose
reference logit lies within one bf16 ulp of the reference's top logit (a
tie at the dtype's resolution, which either rounding may break).

Training: ``blockwise_attention`` with autograd recording gives the
``no_grad`` path's bits and ``reference_attention``'s gradients;
``cross_entropy_logits`` and ``loss_fn`` at the reference's
``smoke_config`` match in loss and in every parameter's gradient (fp32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as RefMoEConfig
from repro.configs.base import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro_torch import convert
from repro_torch.configs import MoEConfig, get_config
from repro_torch.models import attention, layers, transformer

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def to_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def assert_rel(got, want, tol):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def both(a, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rms_norm_matches_reference(dtype):
    r = np.random.default_rng(0)
    x = (r.standard_normal((3, 7, 64)) * 2).astype(np.float32)
    scale = (1 + 0.1 * r.standard_normal(64)).astype(np.float32)
    jx, tx = both(x, dtype)
    ref = ref_layers.rms_norm(jx, jnp.asarray(scale), 1e-6)
    ours = layers.rms_norm(tx, torch.from_numpy(scale), 1e-6)
    assert ours.dtype == tx.dtype
    # the same rounding points: equal up to one rounding of the dtype
    assert_rel(ours, ref, 1e-6 if dtype == "float32" else 2**-8)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_swiglu_mlp_matches_reference(dtype):
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 5, 64)).astype(np.float32)
    ws = [(r.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
          for s in ((64, 128), (64, 128), (128, 64))]
    jx, tx = both(x, dtype)
    ref = ref_layers.swiglu_mlp(jx, *(both(w, dtype)[0] for w in ws))
    ours = layers.swiglu_mlp(tx, *(both(w, dtype)[1] for w in ws))
    assert_rel(ours, ref, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_rope_matches_reference(dtype):
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    jx, tx = both(x, dtype)
    ref = ref_attn.apply_rope(jx, jnp.asarray(pos), 10_000.0)
    ours = attention.apply_rope(tx, torch.from_numpy(pos), 10_000.0)
    assert ours.dtype == tx.dtype
    assert_rel(ours, ref, 1e-5 if dtype == "float32" else 2**-7)


def test_dense_and_embed_init_scales():
    g = torch.Generator().manual_seed(0)
    w = layers.dense_init(g, (4, 400, 300))
    e = layers.embed_init(g, (500, 64))
    assert w.dtype == e.dtype == torch.float32
    assert abs(float(w.std()) - 1 / np.sqrt(400)) < 2e-3
    assert abs(float(e.std()) - 0.02) < 1e-3


# -- attention ---------------------------------------------------------------

ATTN_CASES = [  # b, sq, h, kv, dh, chunk, causal
    (2, 40, 4, 1, 16, 16, True),      # chunked, ragged last chunk, GQA 4:1
    (1, 37, 9, 3, 16, 8, True),       # G=3, ragged
    (2, 24, 4, 4, 32, 64, True),      # one chunk, MHA
    (2, 33, 6, 2, 16, 10, False),     # non-causal, padded last chunk
]


@pytest.mark.parametrize("b,sq,h,kv,dh,chunk,causal", ATTN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_blockwise_attention_matches_reference(b, sq, h, kv, dh, chunk,
                                               causal, dtype):
    r = np.random.default_rng(sq * 10 + h)
    q = r.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = r.standard_normal((b, sq, kv, dh)).astype(np.float32)
    v = r.standard_normal((b, sq, kv, dh)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (q, k, v))
    ref = ref_attn.blockwise_attention(jq, jk, jv, causal=causal, chunk=chunk)
    ours = attention.blockwise_attention(tq, tk, tv, causal=causal,
                                         chunk=chunk)
    assert ours.dtype == tq.dtype
    # fp32: sums in another order; bf16: both round the same fp32 result
    assert_rel(ours, ref, 1e-5 if dtype == "float32" else 2**-7)
    naive = ref_attn.reference_attention(jq, jk, jv, causal=causal)
    assert_rel(attention.reference_attention(tq, tk, tv, causal=causal),
               naive, 1e-5 if dtype == "float32" else 2**-7)
    assert_rel(ours, naive, DTYPES[dtype][2])


def test_decode_attention_matches_reference():
    r = np.random.default_rng(3)
    b, s, kv, g, dh, length = 2, 30, 3, 3, 16, 21
    q = r.standard_normal((b, 1, kv * g, dh)).astype(np.float32)
    kc = r.standard_normal((b, s, kv, dh)).astype(np.float32)
    vc = r.standard_normal((b, s, kv, dh)).astype(np.float32)
    slot = np.where(np.arange(s) < length, np.arange(s),
                    np.iinfo(np.int32).max).astype(np.int32)
    slot = np.broadcast_to(slot, (b, s)).copy()
    ref = ref_attn.decode_attention(*map(jnp.asarray, (q, kc, vc, slot)))
    ours = attention.decode_attention(*map(torch.from_numpy,
                                           (q, kc, vc, slot)))
    assert_rel(ours, ref, 1e-5)


# -- the model ---------------------------------------------------------------

def smoke_cfgs(dtype, variant):
    """The reference's smoke config of smollm-135m (or its KV 3 / H 9
    variant with qkv biases) and the port's config of the same fields."""
    ref = ref_tf.smoke_config(ref_get_config("smollm-135m"))
    if variant == "kv3-h9-bias":
        ref = ref.scaled(n_heads=9, n_kv_heads=3, qkv_bias=True)
    jdt, tdt, _ = DTYPES[dtype]
    ref = ref.scaled(dtype=jdt)
    port = get_config("smollm-135m").scaled(
        n_layers=ref.n_layers, d_model=ref.d_model, n_heads=ref.n_heads,
        n_kv_heads=ref.n_kv_heads, d_head=ref.d_head, d_ff=ref.d_ff,
        vocab_size=ref.vocab_size, attn_chunk=ref.attn_chunk,
        max_seq_len=ref.max_seq_len, qkv_bias=ref.qkv_bias, dtype=tdt)
    return ref, port


def numpy_params(ref_cfg, seed=0):
    """The reference's init at PRNGKey(seed) as numpy; qkv biases, which
    init to zero, are drawn at random so that they count."""
    params = jax.tree.map(np.asarray,
                          ref_tf.init_params(ref_cfg, jax.random.PRNGKey(seed)))
    r = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in params["layers"]:
            shape = params["layers"][name].shape
            params["layers"][name] = (0.3 * r.standard_normal(shape)
                                      ).astype(np.float32)
    return params


def test_smollm_config_matches_reference():
    ref, port = ref_get_config("smollm-135m"), get_config("smollm-135m")
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_head", "d_ff", "vocab_size", "qkv_bias",
              "rope_theta", "norm_eps", "tie_embeddings", "attn_chunk",
              "max_seq_len", "head_dim", "moe"):
        assert getattr(port, f) == getattr(ref, f), f
    assert (port.dtype, port.param_dtype) == (torch.bfloat16, torch.float32)
    assert transformer.padded_vocab(port.vocab_size) == 49_152
    assert transformer.padded_vocab(500) == 512


@pytest.mark.parametrize("variant", ["smoke", "kv3-h9-bias"])
def test_params_from_numpy_copy_reference_init(variant):
    ref_cfg, cfg = smoke_cfgs("float32", variant)
    params = numpy_params(ref_cfg)
    model = convert.transformer_params_from_numpy(params, cfg, "cpu")
    flat = {k: v for k, v in params.items() if k != "layers"}
    flat.update({f"layers.{k}": v for k, v in params["layers"].items()})
    got = dict(model.named_parameters())
    assert set(got) == set(flat)
    for name, a in flat.items():
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].detach().numpy(), a)
    bad = dict(params, embed=params["embed"][:, :3])
    with pytest.raises(ValueError, match="shape"):
        convert.transformer_params_from_numpy(bad, cfg, "cpu")
    with pytest.raises(ValueError, match="missing"):
        convert.transformer_params_from_numpy(
            {k: v for k, v in params.items() if k != "final_norm"}, cfg,
            "cpu")


def test_init_params_and_cache_shapes_match_reference():
    ref_cfg, cfg = smoke_cfgs("bfloat16", "kv3-h9-bias")
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    ref_shapes = jax.tree.map(lambda s: s.shape, ref_tf.param_shapes(ref_cfg))
    ours = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert ours["embed"] == ref_shapes["embed"]
    for k, s in ref_shapes["layers"].items():
        assert ours[f"layers.{k}"] == s
    assert float(model.layers["bq"].detach().abs().max()) == 0.0
    assert float(model.final_norm.detach().min()) == 1.0
    cache = transformer.init_cache(cfg, 3, 20, device="cpu")
    ref_cache = ref_tf.init_cache(ref_cfg, 3, 20)
    for k in ("k", "v", "slot_pos"):
        assert tuple(cache[k].shape) == ref_cache[k].shape
        np.testing.assert_array_equal(to_np(cache[k]), to_np(ref_cache[k]))
    assert cache["k"].dtype == torch.bfloat16 and cache["length"] == 0


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg = smoke_cfgs("float32", "smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.TransformerLM(cfg)


def test_moe_config_raises():
    cfg = get_config("smollm-135m").scaled(
        family="lm-moe", moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64))
    with pytest.raises(NotImplementedError, match="Queue A"):
        transformer.TransformerLM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A"):
        transformer.param_table(cfg)
    ref_moe = ref_tf.smoke_config(ref_get_config("smollm-135m")).scaled(
        moe=RefMoEConfig(n_experts=4, top_k=2, d_ff_expert=64))
    with pytest.raises(ValueError, match="parameter names"):
        convert.transformer_params_from_numpy(
            numpy_params(ref_moe), get_config("smollm-135m"), "cpu")


PROMPT, STEPS = 40, 6


@pytest.mark.parametrize("variant", ["smoke", "kv3-h9-bias"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_and_decode_match_reference(variant, dtype):
    """Prefill 40 tokens, then 6 greedy decode steps in both packages. The
    port's tokens are the reference's greedy choices fed back, so both
    decode the same sequence; the port's own argmax must pick them too, up
    to a tie within one ulp of the logits' dtype (module docstring)."""
    ref_cfg, cfg = smoke_cfgs(dtype, variant)
    tol = DTYPES[dtype][2]
    params = numpy_params(ref_cfg)
    model = convert.transformer_params_from_numpy(params, cfg, "cpu")
    b, max_len = 2, PROMPT + STEPS + 2
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (b, PROMPT)).astype(np.int32)

    ref_cache = ref_tf.init_cache(ref_cfg, b, max_len)
    ref_logits, ref_cache = ref_tf.prefill(ref_cfg, params,
                                           jnp.asarray(prompt), ref_cache)
    cache = transformer.init_cache(cfg, b, max_len, device="cpu")
    logits, same = transformer.prefill(cfg, model, torch.from_numpy(prompt),
                                       cache)
    assert same is cache and cache["length"] == PROMPT
    assert_rel(logits, ref_logits, tol)

    decode = jax.jit(lambda p, t, pos, c: ref_tf.decode_step(ref_cfg, p, t,
                                                             pos, c))
    for step in range(STEPS):
        ref_v = to_np(ref_logits[:, :cfg.vocab_size])
        want = ref_v.argmax(-1)
        got = logits[:, :cfg.vocab_size].float().argmax(-1).numpy()
        top = ref_v.max(-1)
        ulp = (np.spacing(np.abs(top).astype(np.float32)) * 2**16
               if dtype == "bfloat16" else 0.0)   # bf16 keeps 16 bits fewer
        assert (ref_v[np.arange(b), got] >= top - ulp).all(), (got, want)
        pos = np.full((b,), PROMPT + step, np.int32)
        ref_logits, ref_cache = decode(params, jnp.asarray(want[:, None]),
                                       jnp.asarray(pos), ref_cache)
        logits, cache = transformer.decode_step(
            cfg, model, torch.from_numpy(want[:, None].astype(np.int64)),
            torch.from_numpy(pos), cache)
        assert logits.dtype == cfg.dtype
        assert_rel(logits, ref_logits, tol)
    assert cache["length"] == int(ref_cache["length"]) == PROMPT + STEPS
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  np.asarray(ref_cache["slot_pos"]))
    if dtype == "float32":
        for k in ("k", "v"):
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(ref_cache[k]), rtol=0,
                                       atol=1e-5)


# -- training ----------------------------------------------------------------

@pytest.mark.parametrize("b,sq,h,kv,dh,chunk,causal", ATTN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_blockwise_attention_grad_path(b, sq, h, kv, dh, chunk, causal,
                                       dtype):
    """With autograd recording the forward runs out of place: the same
    bits as the in-place ``no_grad`` form. Its gradients (fp32) against
    autograd through the naive ``reference_attention``: within 1e-5 x
    max(1, |ref|) (the same softmax, summed in another order)."""
    r = np.random.default_rng(sq * 10 + h + 1)
    q, k, v = (torch.from_numpy(r.standard_normal(shape).astype(np.float32))
               .to(DTYPES[dtype][1]) for shape in
               ((b, sq, h, dh), (b, sq, kv, dh), (b, sq, kv, dh)))
    with torch.no_grad():
        serving = attention.blockwise_attention(q, k, v, causal=causal,
                                                chunk=chunk)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention.blockwise_attention(*leaves, causal=causal, chunk=chunk)
    assert out.requires_grad and torch.equal(out.detach(), serving)
    if dtype != "float32":
        return
    w = torch.from_numpy(r.standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad((out * w).sum(), leaves)
    naive = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        (attention.reference_attention(*naive, causal=causal) * w).sum(),
        naive)
    for g, wg in zip(got, want):
        assert_rel(g, wg, 1e-5)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cross_entropy_logits_matches_reference(dtype, z_loss):
    r = np.random.default_rng(4)
    logits = (3 * r.standard_normal((3, 5, 40))).astype(np.float32)
    tgt = r.integers(0, 40, (3, 5)).astype(np.int32)
    jl, tl = both(logits, dtype)
    want = ref_layers.cross_entropy_logits(jl, jnp.asarray(tgt), z_loss)
    got = layers.cross_entropy_logits(tl, torch.from_numpy(tgt), z_loss)
    assert got.dtype == torch.float32
    assert_rel(got, want, 1e-6)


def test_smoke_config_matches_reference():
    for name, kv in (("smollm-135m", 1), ("mha", 4)):
        ref, port = ref_get_config("smollm-135m"), get_config("smollm-135m")
        if name == "mha":
            ref, port = (c.scaled(n_heads=9, n_kv_heads=9) for c in (ref, port))
        ref, port = ref_tf.smoke_config(ref), transformer.smoke_config(port)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_head", "d_ff", "vocab_size", "qkv_bias",
                  "attn_chunk", "max_seq_len", "tie_embeddings", "moe"):
            assert getattr(port, f) == getattr(ref, f), f
        assert port.n_kv_heads == kv
    moe = get_config("smollm-135m").scaled(
        family="lm-moe", moe=MoEConfig(n_experts=16, top_k=4,
                                       d_ff_expert=512))
    assert transformer.smoke_config(moe).moe == MoEConfig(
        n_experts=4, top_k=2, d_ff_expert=64)


@pytest.mark.parametrize("variant", ["smoke", "kv3-h9-bias"])
def test_loss_fn_and_grads_match_reference(variant):
    """The LM loss (targets < 0 masked) within 2e-5 and every parameter's
    gradient within 1e-4 of the leaf's largest |gradient| (fp32), from the
    same numpy weights; aux is 0 for the dense model."""
    ref_cfg, cfg = smoke_cfgs("float32", variant)
    params = numpy_params(ref_cfg)
    r = np.random.default_rng(6)
    toks = r.integers(0, cfg.vocab_size, (3, 41)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    batch["targets"][0, 30:] = -1
    batch["targets"][2, :5] = -1
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, want_aux), want_g = jax.value_and_grad(
        lambda p: ref_tf.loss_fn(ref_cfg, p, jb), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    model = convert.transformer_params_from_numpy(params, cfg, "cpu")
    loss, aux = transformer.loss_fn(cfg, model, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss.detach()) - float(want)) <= 2e-5
    assert float(aux["aux"]) == float(want_aux["aux"]) == 0.0
    assert abs(float(aux["ce"].detach()) - float(want_aux["ce"])) <= 2e-5
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    want_g = jax.tree.map(np.asarray, want_g)
    flat = {k: v for k, v in want_g.items() if k != "layers"}
    flat.update({f"layers.{k}": v for k, v in want_g["layers"].items()})
    assert set(flat) == set(grads)
    for name, g in grads.items():
        err = float(np.abs(g.numpy() - flat[name]).max())
        assert err <= 1e-4 * float(np.abs(flat[name]).max()), name
