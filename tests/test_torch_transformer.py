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

The model tests run the smoke config of each of the five LM archs (the
dense smollm-135m and qwen2 configs, the MoE granite and llama4 configs):
the MoE layers route as the reference's (``tests/test_torch_moe.py``).
``param_shapes`` and ``cache_shapes`` are held at full size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as RefMoEConfig
from repro.configs.base import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro_torch import convert
from repro_torch.configs import MoEConfig, get_config
from repro_torch.models import attention, layers, moe, transformer
from repro_torch.train.checkpoint import flatten

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
#: the largest gap between the reference's k-th and (k+1)-th router
#: probabilities at which the packages' expert choices may differ: in bf16
#: the router's input is rounded differently (the one flip seen, granite's,
#: sat at a gap of 1.72e-3), in fp32 only the sums' order differs
ROUTE_TIES = {"float32": 1e-5, "bfloat16": 5e-3}


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

LM_ARCHS = ["smollm-135m", "qwen2-0.5b", "qwen2-72b", "granite-moe-1b-a400m",
            "llama4-scout-17b-a16e"]
#: the model tests' variants: smollm-135m's smoke config ("smoke"), its KV 3 /
#: H 9 variant with qkv biases, and the smoke config of every other LM arch
VARIANTS = ["smoke", "kv3-h9-bias"] + LM_ARCHS[1:]


def smoke_cfgs(dtype, variant):
    """The reference's smoke config of smollm-135m (or its KV 3 / H 9
    variant with qkv biases, or another arch's smoke config) and the
    port's config of the same fields."""
    jdt, tdt, _ = DTYPES[dtype]
    if variant in LM_ARCHS:
        return (ref_tf.smoke_config(ref_get_config(variant)).scaled(dtype=jdt),
                transformer.smoke_config(get_config(variant)).scaled(
                    dtype=tdt))
    ref = ref_tf.smoke_config(ref_get_config("smollm-135m"))
    if variant == "kv3-h9-bias":
        ref = ref.scaled(n_heads=9, n_kv_heads=3, qkv_bias=True)
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


CONFIG_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads",
                 "n_kv_heads", "d_head", "d_ff", "vocab_size", "qkv_bias",
                 "rope_theta", "norm_eps", "tie_embeddings", "attn_chunk",
                 "max_seq_len", "head_dim")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_config_matches_reference(arch):
    """Every ported LM config field for field (dtypes mapped, the MoE
    config as a dict) and its padded vocab, and its smoke config's too."""
    ref, port = ref_get_config(arch), get_config(arch)
    for r, p in ((ref, port),
                 (ref_tf.smoke_config(ref), transformer.smoke_config(port))):
        for f in CONFIG_FIELDS:
            assert getattr(p, f) == getattr(r, f), f
        assert (r.moe is None) == (p.moe is None)
        if r.moe is not None:
            assert dataclasses.asdict(p.moe) == dataclasses.asdict(r.moe)
        assert (p.dtype, p.param_dtype) == (torch.bfloat16, torch.float32)
        assert (r.dtype, r.param_dtype) == (jnp.bfloat16, jnp.float32)
        assert (transformer.padded_vocab(p.vocab_size)
                == ref_tf.padded_vocab(r.vocab_size))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_config_is_the_reference_field_for_field(arch):
    """Every field of the reference's ``TransformerConfig``, in its order,
    with its value (dtypes mapped; the MoE config as a dict), for the
    registered config and its smoke config: the knobs (``remat``,
    ``causal_skip``, ``score_dtype``, ...) included."""
    ref, port = ref_get_config(arch), get_config(arch)
    for r, p in ((ref, port),
                 (ref_tf.smoke_config(ref), transformer.smoke_config(port))):
        names = [f.name for f in dataclasses.fields(r)]
        assert [f.name for f in dataclasses.fields(p)] == names
        for name in names:
            want, got = getattr(r, name), getattr(p, name)
            if name in ("dtype", "param_dtype", "score_dtype"):
                assert str(got).split(".")[-1] == jnp.dtype(want).name, name
            elif name == "moe":
                assert (got is None) == (want is None)
                if want is not None:
                    assert (dataclasses.asdict(got)
                            == dataclasses.asdict(want))
            else:
                assert got == want, name


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_and_cache_shapes_match_reference(arch):
    """At full size (qwen2-72b and llama4-scout too: ``meta`` tensors cost
    no memory): every parameter's shape and dtype, and the cache's."""
    ref, port = ref_get_config(arch), get_config(arch)
    want = jax.tree_util.tree_flatten_with_path(ref_tf.param_shapes(ref))[0]
    got = flatten(transformer.param_shapes(port))
    assert len(got) == len(want)
    for path, s in want:
        name = "/".join(k.key for k in path)
        t = got[name]
        assert t.device.type == "meta"
        assert (tuple(t.shape), str(t.dtype)) == (s.shape, "torch.float32"), \
            name
        assert s.dtype == jnp.float32
    n = sum(t.numel() for t in got.values())
    assert n == sum(int(np.prod(s.shape)) for _, s in want)
    ref_cache = ref_tf.cache_shapes(ref, 8, 4128)
    cache = transformer.cache_shapes(port, 8, 4128)
    assert set(cache) == set(ref_cache)
    dt = {"k": (torch.bfloat16, jnp.bfloat16), "v": (torch.bfloat16,
                                                     jnp.bfloat16),
          "slot_pos": (torch.int32, jnp.int32),
          "length": (torch.int32, jnp.int32)}
    for k, (tdt, jdt) in dt.items():
        assert tuple(cache[k].shape) == ref_cache[k].shape, k
        assert cache[k].dtype == tdt and ref_cache[k].dtype == jdt, k
        assert cache[k].device.type == "meta"
    small = transformer.smoke_config(port)
    real = transformer.init_cache(small, 2, 8, device="cpu")
    for k, t in transformer.cache_shapes(small, 2, 8).items():
        if k != "length":
            assert (real[k].shape, real[k].dtype) == (t.shape, t.dtype), k


def test_smollm_config_matches_reference():
    """The fields are held for every arch by
    ``test_lm_config_matches_reference``; here the vocab padding's numbers."""
    port = get_config("smollm-135m")
    assert transformer.padded_vocab(port.vocab_size) == 49_152
    assert transformer.padded_vocab(500) == 512


@pytest.mark.parametrize("variant", VARIANTS)
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
    # an MoE model's weights into a dense config, or a dense one's into an
    # MoE config: the names differ
    other = ref_cfg.scaled(moe=None if ref_cfg.moe else RefMoEConfig(
        n_experts=4, top_k=2, d_ff_expert=64, n_shared_experts=1))
    with pytest.raises(ValueError, match="parameter names"):
        convert.transformer_params_from_numpy(numpy_params(other), cfg,
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


PROMPT, STEPS = 40, 6


@pytest.fixture
def routes(monkeypatch):
    """Both packages' MoE routing, call by call: (router probabilities
    (G, T, E), experts (G, T, k)) of every MoE layer each package ran (the
    reference's read out of its traced scan by a callback)."""
    rec = {"ref": [], "port": []}
    ref_route, port_route = ref_moe.route, moe.route

    def ref_recorded(x, w, cfg):
        out = ref_route(x, w, cfg)
        probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", x.astype(jnp.float32),
                                          w.astype(jnp.float32)), axis=-1)
        jax.debug.callback(lambda p, e: rec["ref"].append(
            (np.asarray(p), np.asarray(e))), probs, out[1], ordered=True)
        return out

    def port_recorded(x, w, cfg):
        out = port_route(x, w, cfg)
        probs = torch.softmax(x.float() @ w.float(), dim=-1)
        rec["port"].append((probs.detach().numpy(), out[1].numpy()))
        return out

    monkeypatch.setattr(ref_moe, "route", ref_recorded)
    monkeypatch.setattr(moe, "route", port_recorded)
    return rec


def routing_flips(routes, k, tie) -> set:
    """The requests (groups) whose experts differ between the packages in
    any MoE call recorded since the last read, each difference checked to
    be a near tie: the reference's k-th and (k+1)-th probabilities within
    ``tie``. Reads and clears the records."""
    jax.effects_barrier()
    assert len(routes["ref"]) == len(routes["port"])
    flips = set()
    for (probs, want), (_, got) in zip(routes["ref"], routes["port"]):
        differ = (np.sort(want, -1) != np.sort(got, -1)).any(-1)
        for g, t in zip(*np.nonzero(differ)):
            p = np.sort(probs[g, t])[::-1]
            assert p[k - 1] - p[k] <= tie, (g, t, want[g, t], got[g, t], p)
            flips.add(int(g))
    routes["ref"].clear()
    routes["port"].clear()
    return flips


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_and_decode_match_reference(variant, dtype, routes):
    """Prefill 40 tokens, then 6 greedy decode steps in both packages. The
    port's tokens are the reference's greedy choices fed back, so both
    decode the same sequence; the port's own argmax must pick them too, up
    to a tie within one ulp of the logits' dtype (module docstring).

    MoE archs: an expert choice may differ between the packages only at a
    near tie of the reference's router probabilities (within the dtype's
    ``ROUTE_TIES``); a request whose routing differed is compared no
    further, and at least one request is compared at every step."""
    ref_cfg, cfg = smoke_cfgs(dtype, variant)
    tol = DTYPES[dtype][2]
    k = cfg.moe.top_k if cfg.moe else 0
    params = numpy_params(ref_cfg)
    model = convert.transformer_params_from_numpy(params, cfg, "cpu")
    b, max_len = 2, PROMPT + STEPS + 2
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (b, PROMPT)).astype(np.int32)
    flipped: set = set()

    def compared():
        flipped.update(routing_flips(routes, k, ROUTE_TIES[dtype]))
        rows = [i for i in range(b) if i not in flipped]
        assert rows
        return rows

    ref_cache = ref_tf.init_cache(ref_cfg, b, max_len)
    ref_logits, ref_cache = ref_tf.prefill(ref_cfg, params,
                                           jnp.asarray(prompt), ref_cache)
    cache = transformer.init_cache(cfg, b, max_len, device="cpu")
    logits, same = transformer.prefill(cfg, model, torch.from_numpy(prompt),
                                       cache)
    assert same is cache and cache["length"] == PROMPT
    rows = compared()
    assert_rel(logits[rows], ref_logits[np.array(rows)], tol)

    decode = jax.jit(lambda p, t, pos, c: ref_tf.decode_step(ref_cfg, p, t,
                                                             pos, c))
    for step in range(STEPS):
        ref_v = to_np(ref_logits[:, :cfg.vocab_size])
        want = ref_v.argmax(-1)
        got = logits[:, :cfg.vocab_size].float().argmax(-1).numpy()
        top = ref_v.max(-1)
        ulp = (np.spacing(np.abs(top).astype(np.float32)) * 2**16
               if dtype == "bfloat16" else 0.0)   # bf16 keeps 16 bits fewer
        assert (ref_v[rows, got[rows]] >= top[rows] - ulp).all(), (got, want)
        pos = np.full((b,), PROMPT + step, np.int32)
        ref_logits, ref_cache = decode(params, jnp.asarray(want[:, None]),
                                       jnp.asarray(pos), ref_cache)
        logits, cache = transformer.decode_step(
            cfg, model, torch.from_numpy(want[:, None].astype(np.int64)),
            torch.from_numpy(pos), cache)
        assert logits.dtype == cfg.dtype
        rows = compared()
        assert_rel(logits[rows], ref_logits[np.array(rows)], tol)
    assert cache["length"] == int(ref_cache["length"]) == PROMPT + STEPS
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  np.asarray(ref_cache["slot_pos"]))
    if dtype == "float32":
        for name in ("k", "v"):
            np.testing.assert_allclose(
                cache[name][:, rows].numpy(),
                np.asarray(ref_cache[name])[:, np.array(rows)], rtol=0,
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


@pytest.mark.parametrize("variant", VARIANTS)
def test_loss_fn_and_grads_match_reference(variant):
    """The LM loss (targets < 0 masked) within 2e-5 and every parameter's
    gradient within 1e-4 of the leaf's largest |gradient| (fp32), from the
    same numpy weights; the aux loss summed over the MoE layers within
    1e-6 (0 for a dense model)."""
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
    got_aux = float(aux["aux"].detach())
    assert abs(got_aux - float(want_aux["aux"])) <= 1e-6
    if cfg.moe is None:
        assert got_aux == float(want_aux["aux"]) == 0.0
    else:
        assert got_aux > 0.0
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
