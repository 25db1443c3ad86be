"""The port's RecSys models and embedding tables (``repro_torch.models.
{recsys,embedding}``) against the JAX package's, on the CPU.

The same weights, drawn from a numpy seed in the reference's structure and
by its init kinds (biases random, so that they count), go into both
packages, the port's through ``convert.recsys_params_from_numpy``, with the
same numpy batches. The MLP helpers (``mlp_shapes``, ``mlp_params``,
``mlp_apply``) and ``split_rngs`` are held alone. Held at each arch's
``smoke_config``: the forward within 2e-5 x max(1, |ref|) in fp32 and 3e-2
in bf16 (one bf16 rounding of the lookups and MLPs); ``loss_fn`` and every
gradient in fp32 against ``jax.grad`` within 1e-5 x max(1, |ref|); one
AdamW step's metrics and weights; ``retrieval_topk``'s ids equal, ties to
the lower index. ``lookup`` and ``embedding_bag`` (sum and mean, empty bags
included) against the reference and ``embedding_bag_ref``. Every field of
the four configs, and ``param_shapes`` at full size (``meta`` tensors,
stored pad rows included).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import embedding as ref_emb
from repro.models import layers as ref_layers
from repro.models import recsys as ref_rec
from repro.train.optimizer import AdamW as RefAdamW
from repro_torch import convert
from repro_torch.configs import base, get_config, list_archs
from repro_torch.models import embedding as emb
from repro_torch.models import layers
from repro_torch.models import recsys
from repro_torch.train.checkpoint import flatten, unflatten
from repro_torch.train.optimizer import AdamW, named_params
from repro_torch.train.trainer import make_train_step

ARCHS = ["fm", "dlrm-mlperf", "autoint", "two-tower-retrieval"]
DTYPES = {"fp32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
B = 8


def to_np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def assert_rel(got, want, tol, what=""):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale, what


def cfgs(arch, dtype="fp32"):
    jdt, tdt, _ = DTYPES[dtype]
    return (ref_rec.smoke_config(ref_base.get_config(arch)).scaled(dtype=jdt),
            recsys.smoke_config(get_config(arch)).scaled(dtype=tdt))


def ref_init(arch):
    """Weights of ``arch``'s smoke config in the reference's structure
    (its ``param_shapes``), drawn from numpy seed 0 by its init kinds:
    tables N(0, 1) x rows^-0.25 x 0.1, other matrices LeCun-normal fan-in,
    and the vectors (the reference's zero biases, FM's bias) N(0, 0.1), so
    that they count."""
    ref_cfg, _ = cfgs(arch)
    r = np.random.default_rng(0)
    flat = {}
    for name, s in sorted(flatten(ref_rec.param_shapes(ref_cfg)).items()):
        if name.startswith("tables/"):
            std = s.shape[0] ** -0.25 * 0.1
        else:
            std = 0.1 if len(s.shape) <= 1 else s.shape[0] ** -0.5
        flat[name] = (std * r.standard_normal(s.shape)).astype(np.float32)
    return unflatten(flat)


@functools.cache
def ref_value_and_grad(arch):
    """The reference's fp32 loss and gradients, compiled once an arch."""
    ref_cfg, _ = cfgs(arch)
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_rec.loss_fn(ref_cfg, p, b), has_aux=True))


def make_batch(cfg, seed=1, b=B, n_cand=0):
    r = np.random.default_rng(seed)
    if cfg.variant == "two-tower":
        nq = cfg.n_query_fields
        out = {"query_ids": r.integers(0, cfg.table_sizes[:nq], (b, nq)),
               "item_ids": r.integers(0, cfg.table_sizes[nq:],
                                      (b, cfg.n_item_fields))}
        if n_cand:
            out["candidate_ids"] = r.integers(0, cfg.table_sizes[nq:],
                                              (n_cand, cfg.n_item_fields))
        return {k: v.astype(np.int32) for k, v in out.items()}
    out = {"sparse_ids": r.integers(0, cfg.table_sizes,
                                    (b, cfg.n_sparse)).astype(np.int32),
           "labels": r.integers(0, 2, b).astype(np.float32)}
    if cfg.n_dense:
        out["dense"] = r.standard_normal((b, cfg.n_dense)).astype(np.float32)
    return out


def jnp_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def serving(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


# -- configs and shapes ------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    """Every field (dtypes mapped) of the config and of its smoke config."""
    ref, port = ref_base.get_config(arch), get_config(arch)
    for r, p in ((ref, port), (ref_rec.smoke_config(ref),
                               recsys.smoke_config(port))):
        fields = {f.name for f in dataclasses.fields(r)}
        assert fields == {f.name for f in dataclasses.fields(p)}
        for f in fields - {"dtype", "param_dtype"}:
            assert getattr(p, f) == getattr(r, f), f
        assert (p.dtype, p.param_dtype) == (torch.bfloat16, torch.float32)
        assert (r.dtype, r.param_dtype) == (jnp.bfloat16, jnp.float32)
        assert p.n_sparse == r.n_sparse


def test_registry_and_shape_tables_match_reference():
    assert list_archs() == ref_base.list_archs()
    assert set(base.FAMILY_SHAPES) == set(ref_base.FAMILY_SHAPES)
    for fam, shapes in ref_base.FAMILY_SHAPES.items():
        assert set(base.FAMILY_SHAPES[fam]) == set(shapes), fam
        for name, s in shapes.items():
            p = base.FAMILY_SHAPES[fam][name]
            assert (p.name, p.kind, p.dims) == (s.name, s.kind, s.dims)
    for arch in list_archs():
        assert set(base.shapes_for(get_config(arch))) == set(
            ref_base.shapes_for(ref_base.get_config(arch))), arch
    for n in (0, 1, 511, 512, 513, 10_556, 1_000_000):
        assert base.pad512(n) == ref_base.pad512(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_reference(arch):
    """At full size (``meta`` tensors cost nothing): every parameter's
    name, shape and dtype, the tables' stored pad rows included."""
    want = flatten(ref_rec.param_shapes(ref_base.get_config(arch)))
    got = flatten(recsys.param_shapes(get_config(arch)))
    assert set(got) == set(want)
    for name, s in want.items():
        t = got[name]
        assert t.device.type == "meta" and t.dtype == torch.float32, name
        assert tuple(t.shape) == s.shape and s.dtype == jnp.float32, name
    for r in (3, 65_535, 65_536, 65_537, 39_884_406):
        assert emb.padded_rows(r) == ref_emb.padded_rows(r)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_fills_param_shapes(arch):
    _, cfg = cfgs(arch)
    params = recsys.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = flatten(recsys.param_shapes(cfg))
    got = flatten(params)
    assert set(got) == set(want)
    for name, t in got.items():
        assert (t.shape, t.dtype) == (want[name].shape, torch.float32), name
        assert t.device.type == "cpu" and bool(torch.isfinite(t).all())
    rows = cfg.table_sizes[0]
    assert abs(float(got["tables/table_0"].std()) - rows ** -0.25 * 0.1) \
        < 0.01


def test_params_from_numpy_checks_names_and_shapes():
    _, cfg = cfgs("dlrm-mlperf")
    params = ref_init("dlrm-mlperf")
    got = flatten(convert.recsys_params_from_numpy(params, cfg, "cpu"))
    for name, a in flatten(params).items():
        np.testing.assert_array_equal(got[name].numpy(), a)
    bad = dict(params, bot=dict(params["bot"], w0=params["bot"]["w0"][:3]))
    with pytest.raises(ValueError, match="shape"):
        convert.recsys_params_from_numpy(bad, cfg, "cpu")
    with pytest.raises(ValueError, match="missing"):
        convert.recsys_params_from_numpy(
            {k: v for k, v in params.items() if k != "top"}, cfg, "cpu")


# -- the MLP helpers ---------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act_last", [False, True])
def test_mlp_matches_reference(dtype, act_last):
    """``mlp_shapes`` (``meta``) against the reference's, ``mlp_params``
    filling them, and ``mlp_apply`` (``mlp_stack``) on the same weights."""
    jdt, tdt, tol = DTYPES[dtype]
    dims = (13, 32, 16, 1)
    want = ref_layers.mlp_shapes(dims)
    got = layers.mlp_shapes(dims)
    assert {k: tuple(t.shape) for k, t in got.items()} == {
        k: s.shape for k, s in want.items()}
    assert all(t.device.type == "meta" for t in got.values())
    drawn = layers.mlp_params(torch.Generator().manual_seed(0), dims)
    assert {k: t.shape for k, t in drawn.items()} == {
        k: t.shape for k, t in got.items()}
    assert not any(drawn[f"b{i}"].any() for i in range(3))
    r = np.random.default_rng(5)
    w = {k: (0.3 * r.standard_normal(s.shape)).astype(np.float32)
         for k, s in want.items()}
    x = r.standard_normal((6, 13)).astype(np.float32)
    ref = ref_layers.mlp_apply({k: jnp.asarray(v) for k, v in w.items()},
                               jnp.asarray(x, jdt), act_last=act_last)
    out = layers.mlp_apply({k: torch.from_numpy(v) for k, v in w.items()},
                           torch.from_numpy(x).to(tdt), act_last=act_last)
    assert out.dtype == tdt
    assert_rel(out, ref, tol)


def test_split_rngs_gives_one_generator_a_name():
    gens = layers.split_rngs(torch.Generator().manual_seed(0), ["a", "b"])
    again = layers.split_rngs(torch.Generator().manual_seed(0), ["a", "b"])
    assert set(gens) == {"a", "b"}
    draws = {k: torch.randn(4, generator=g) for k, g in gens.items()}
    assert not torch.equal(draws["a"], draws["b"])
    assert torch.equal(draws["a"], torch.randn(4, generator=again["a"]))


# -- embeddings --------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lookup_matches_reference(dtype):
    """The same bits: a gather, then one cast."""
    jdt, tdt, _ = DTYPES[dtype]
    r = np.random.default_rng(3)
    sizes = (5, 70_000, 17)
    tables = {f"table_{i}": r.standard_normal(
        (emb.padded_rows(n), 6)).astype(np.float32)
        for i, n in enumerate(sizes)}
    ids = r.integers(0, sizes, (32, 3)).astype(np.int32)
    want = ref_emb.lookup({k: jnp.asarray(v) for k, v in tables.items()},
                          jnp.asarray(ids), jdt)
    got = emb.lookup({k: torch.from_numpy(v) for k, v in tables.items()},
                     torch.from_numpy(ids), tdt)
    assert got.dtype == tdt and tuple(got.shape) == (32, 3, 6)
    np.testing.assert_array_equal(to_np(got), to_np(want))


def bags(seed):
    """A table and ragged CSR bags, empty ones included (the first, one in
    the middle, the last), repeated ids within and across bags."""
    r = np.random.default_rng(seed)
    table = r.standard_normal((40, 8)).astype(np.float32)
    counts = np.array([0, 3, 1, 0, 7, 2, 5, 0])
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    ids = r.integers(0, 12, offsets[-1]).astype(np.int32)
    return table, ids, offsets


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_matches_reference(combiner):
    table, ids, offsets = bags(4)
    want = ref_emb.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                 jnp.asarray(offsets), combiner=combiner,
                                 compute_dtype=jnp.float32)
    oracle = ref_emb.embedding_bag_ref(table, ids, offsets,
                                       combiner=combiner)
    got = emb.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.from_numpy(offsets), combiner=combiner,
                            compute_dtype=torch.float32)
    assert_rel(got, want, 1e-6)
    assert_rel(got, oracle, 1e-6)
    np.testing.assert_array_equal(
        emb.embedding_bag_ref(table, ids, offsets, combiner=combiner), oracle)
    assert not to_np(got)[[0, 3, 7]].any()          # empty bags give zeros
    bf16 = emb.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                             torch.from_numpy(offsets), combiner=combiner)
    assert bf16.dtype == torch.bfloat16
    assert_rel(bf16, want, 1e-2)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_grad_matches_jax(combiner):
    """The table's gradient (repeated ids summed in row order) against
    ``jax.grad`` of the reference."""
    table, ids, offsets = bags(5)
    w = np.random.default_rng(6).standard_normal(
        (len(offsets) - 1, 8)).astype(np.float32)
    want = jax.grad(lambda t: (ref_emb.embedding_bag(
        t, jnp.asarray(ids), jnp.asarray(offsets), combiner=combiner,
        compute_dtype=jnp.float32) * w).sum())(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    out = emb.embedding_bag(t, torch.from_numpy(ids),
                            torch.from_numpy(offsets), combiner=combiner,
                            compute_dtype=torch.float32)
    (g,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [t])
    assert_rel(g, want, 1e-6)


# -- the models --------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    ref_cfg, cfg = cfgs(arch, dtype)
    params = ref_init(arch)
    batch = serving(make_batch(cfg))
    want = jax.jit(lambda p, b: ref_rec.forward(ref_cfg, p, b))(
        jax.tree.map(jnp.asarray, params), jnp_batch(batch))
    got = recsys.forward(cfg, convert.recsys_params_from_numpy(
        params, cfg, "cpu"), torch_batch(batch))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B,)
    assert_rel(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """fp32: the loss and every leaf's gradient within 1e-5 x max(1,
    |ref|)."""
    ref_cfg, cfg = cfgs(arch)
    params = ref_init(arch)
    batch = make_batch(cfg, b=16)
    (ref_loss, ref_aux), ref_g = ref_value_and_grad(arch)(
        jax.tree.map(jnp.asarray, params), jnp_batch(batch))
    tp = convert.recsys_params_from_numpy(params, cfg, "cpu")
    named = named_params(tp)
    for t in named.values():
        t.requires_grad_(True)
    loss, aux = recsys.loss_fn(cfg, tp, torch_batch(batch))
    assert set(aux) == set(ref_aux)
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * max(
        1.0, abs(float(ref_loss)))
    grads = torch.autograd.grad(loss, list(named.values()))
    want = flatten(jax.tree.map(np.asarray, ref_g))
    assert set(want) == set(named)
    for name, g in zip(named, grads):
        assert_rel(g, want[name], 1e-5, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_step_matches_reference(arch):
    """One AdamW step (warm-up 2, clip 1), the reference's ``update`` on its
    ``jax.grad`` (its ``make_train_step``'s body) against the port's
    ``make_train_step``: loss and grad norm within 1e-5 x max(1, |ref|),
    every weight within 1e-5. Adam's first step moves a weight by lr_1 x g
    / (|g| + 1e-8), whatever |g|: the two packages' gradients agree to
    ~1e-8 absolute (sums in other orders through the towers' norms and the
    x20 softmax), so where |g| < 1e-6 (the first moment 0.1 g below 1e-7)
    or the signs differ, that ratio may differ by a percent or more, and
    the weight by up to 2 x lr_1."""
    ref_cfg, cfg = cfgs(arch)
    params = ref_init(arch)
    batch = make_batch(cfg, seed=2, b=16)
    ref_opt, opt = RefAdamW(lr=1e-3, warmup_steps=2), AdamW(lr=1e-3,
                                                            warmup_steps=2)
    rp = jax.tree.map(jnp.asarray, params)
    (loss, _), g = ref_value_and_grad(arch)(rp, jnp_batch(batch))
    rp, ro, gnorm = jax.jit(ref_opt.update)(g, ref_opt.init(rp), rp)
    want = {"loss": loss, "gnorm": gnorm}
    tp = convert.recsys_params_from_numpy(params, cfg, "cpu")
    for t in named_params(tp).values():
        t.requires_grad_(True)
    step = make_train_step(lambda p, b: recsys.loss_fn(cfg, p, b), opt)
    tp, state, got = step(tp, opt.init(tp), torch_batch(batch))
    for k in ("loss", "gnorm"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * max(
            1.0, abs(float(want[k]))), k
    lr_1 = 1e-3
    m_ref = flatten(jax.tree.map(np.asarray, ro["m"]))
    for name, a in flatten(jax.tree.map(np.asarray, rp)).items():
        dw = np.abs(named_params(tp)[name].detach().numpy() - a)
        flip = (np.sign(state["m"][name].numpy()) != np.sign(m_ref[name])) | (
            np.abs(m_ref[name]) < 1e-7)
        assert float(dw.max()) <= 2 * lr_1 + 1e-6, name
        assert not ((dw > 1e-5) & ~flip).any(), name


def test_retrieval_topk_matches_reference():
    ref_cfg, cfg = cfgs("two-tower-retrieval")
    params = ref_init("two-tower-retrieval")
    batch = serving(make_batch(cfg, b=2, n_cand=300))
    del batch["item_ids"]
    wv, wi = ref_rec.retrieval_topk(ref_cfg, jax.tree.map(jnp.asarray,
                                                          params),
                                    jnp_batch(batch), k=50)
    gv, gi = recsys.retrieval_topk(cfg, convert.recsys_params_from_numpy(
        params, cfg, "cpu"), torch_batch(batch), k=50)
    assert gi.shape == (2, 50)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert_rel(gv, wv, 2e-5)


def test_retrieval_topk_ties_go_to_the_lower_index():
    """The query tower's last layer zeroed: every candidate scores 0, and
    the top k are candidates 0..k-1 in order in both packages (the order
    of ``jax.lax.top_k``; ``torch.topk`` does not promise it)."""
    ref_cfg, cfg = cfgs("two-tower-retrieval")
    params = ref_init("two-tower-retrieval")
    last = len(params["q_tower"]) // 2 - 1
    for n in (f"w{last}", f"b{last}"):
        params["q_tower"][n] = np.zeros_like(params["q_tower"][n])
    batch = serving(make_batch(cfg, b=2, n_cand=64))
    del batch["item_ids"]
    gv, gi = recsys.retrieval_topk(cfg, convert.recsys_params_from_numpy(
        params, cfg, "cpu"), torch_batch(batch), k=40)
    _, wi = ref_rec.retrieval_topk(ref_cfg, jax.tree.map(jnp.asarray, params),
                                   jnp_batch(batch), k=40)
    assert not gv.any()
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert gi.tolist() == [list(range(40))] * 2


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_query_embed_is_the_query_tower(dtype):
    """``query_embed`` on the query ids alone gives ``two_tower_embed``'s
    query embeddings bit for bit, and the reference's within the forward's
    tolerance."""
    ref_cfg, cfg = cfgs("two-tower-retrieval", dtype)
    params = ref_init("two-tower-retrieval")
    batch = serving(make_batch(cfg))
    want, _ = ref_rec.two_tower_embed(ref_cfg, jax.tree.map(jnp.asarray,
                                                            params),
                                      jnp_batch(batch))
    tp = convert.recsys_params_from_numpy(params, cfg, "cpu")
    got = recsys.query_embed(cfg, tp, torch.from_numpy(batch["query_ids"]))
    q, _ = recsys.two_tower_embed(cfg, tp, torch_batch(batch))
    assert got.dtype == torch.float32 and torch.equal(got, q)
    assert_rel(got, want, DTYPES[dtype][2])
