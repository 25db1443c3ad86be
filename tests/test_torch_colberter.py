"""The port's ColBERTer encoder (``repro_torch.models.colberter``) against
the JAX package's, on the CPU.

The same numpy weights, drawn from a seed, go into both packages (the port
through ``convert.colberter_params_from_numpy``), and the same token batch,
pads included, through both ``encode``s at ``smoke_config``. Tolerances:
fp32 2e-5 (sums taken in another order), bf16 3e-2 (a bf16 rounding of the
residual stream at each layer). ``layer_norm`` and ``gelu_mlp`` are held
alone; the parameter table to the reference's ``param_shapes``; and the
serving example runs end to end at a tiny size with ``--device cpu``.

Training: ``contrastive_loss`` from the reference's own ``init_params``
carried across, on a batch with pads in queries and docs: the loss in fp32
within 2e-5 and in bf16 within 3e-2; every parameter's gradient in fp32
against ``jax.grad`` (tolerance in ``test_contrastive_grads_match_jax``);
the loss history and the weights over 5 AdamW steps; resume replaying the
history bit for bit on the CPU.
"""
import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.models import colberter as ref_col
from repro.models.layers import gelu_mlp as ref_gelu_mlp
from repro.models.layers import layer_norm as ref_layer_norm
from repro.train.optimizer import AdamW as RefAdamW
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.configs import ColberterConfig, get_config
from repro_torch.models import colberter
from repro_torch.models.layers import gelu_mlp, layer_norm
from repro_torch.train.checkpoint import flatten
from repro_torch.train.optimizer import AdamW, named_params
from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"fp32": 2e-5, "bf16": 3e-2}
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# ColberterConfig fields the port drops: none (``remat`` and
# ``score_dtype`` act as the reference's; ``scan_layers`` and
# ``attn_unroll`` are kept and have no effect on the port's loops)
DROPPED: set = set()


def flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def numpy_params(ref_cfg, seed=0):
    """Random weights of the reference's names and shapes: norm scales
    near 1, biases and embeddings small, matrices at fan-in scale."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, shape in sorted(flat_shapes(ref_col.param_shapes(ref_cfg))
                              .items()):
        x = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("scale"):
            x = 1.0 + 0.1 * x
        elif "embed" in name or name.split("/")[-1].startswith("b"):
            x = 0.05 * x
        elif len(shape) >= 2:
            x = x / np.sqrt(shape[-2])
        flat[name] = x
    tree: dict = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        d = tree
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = v
    return tree


def configs(dtype="bf16"):
    jd, td = DTYPES[dtype]
    ref = ref_col.smoke_config(ref_get_config("colberter")).scaled(dtype=jd)
    port = colberter.smoke_config(get_config("colberter")).scaled(dtype=td)
    return ref, port


def tokens(cfg, seed=1):
    """A batch of 4 with pads (-1) at the tails of three rows, a short row,
    the full length in one, token 0 leading each ([CLS])."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (4, cfg.max_doc_len))
    toks[:, 0] = 0
    for row, n in enumerate((cfg.max_doc_len, 5, 13, 1)):
        toks[row, n:] = -1
    return toks.astype(np.int32)


# -- config, table, init --------------------------------------------------

def test_config_is_the_reference_without_the_lowering_knobs():
    ref = {f.name: getattr(ref_get_config("colberter"), f.name)
           for f in dataclasses.fields(ref_get_config("colberter"))}
    port = {f.name: getattr(get_config("colberter"), f.name)
            for f in dataclasses.fields(ColberterConfig)}
    assert set(ref) - set(port) == DROPPED and set(port) <= set(ref)
    assert list(port) == [k for k in ref if k not in DROPPED]   # same order
    for k, v in port.items():
        if k in ("dtype", "param_dtype", "score_dtype"):
            assert str(v).split(".")[-1] == jnp.dtype(ref[k]).name
        else:
            assert v == ref[k], k
    assert (port["n_layers"], port["d_model"], port["n_heads"],
            port["d_ff"], port["vocab_size"], port["d_cls"], port["d_bow"],
            port["max_doc_len"]) == (6, 768, 12, 3072, 30_522, 128, 32, 180)


@pytest.mark.parametrize("smoke", [True, False])
def test_param_table_equals_reference_param_shapes(smoke):
    ref_cfg, port_cfg = ref_get_config("colberter"), get_config("colberter")
    if smoke:
        ref_cfg, port_cfg = (ref_col.smoke_config(ref_cfg),
                             colberter.smoke_config(port_cfg))
    want = flat_shapes(ref_col.param_shapes(ref_cfg))
    assert flat_shapes(colberter.param_shapes(port_cfg)) == want
    assert {k: tuple(s) for k, (s, _) in
            colberter.param_table(port_cfg).items()} == want
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in _leaves(colberter.param_shapes(port_cfg)))
    assert want["pos_embed"][0] == port_cfg.max_doc_len + 8
    if smoke:
        model = colberter.Colberter(port_cfg, device="cpu")
        got = {n.replace(".", "/"): tuple(p.shape)
               for n, p in model.named_parameters()}
        assert got == want


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_init_params_kinds_and_determinism():
    _, cfg = configs("fp32")
    a = colberter.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = colberter.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert torch.equal(a.param("layers/ln1/scale"),
                       torch.ones(cfg.n_layers, cfg.d_model))
    assert not a.param("layers/bq").any()
    assert float(a.param("score_scale").detach()) == 1.0
    std = float(a.param("layers/wq").detach().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_convert_rejects_missing_and_misshapen_arrays():
    ref_cfg, cfg = configs("fp32")
    params = numpy_params(ref_cfg)
    del params["layers"]["ln2"]["bias"]
    with pytest.raises(ValueError, match="layers/ln2/bias"):
        convert.colberter_params_from_numpy(params, cfg, "cpu")
    params = numpy_params(ref_cfg)
    params["cls_head"] = params["cls_head"][:, :3]
    with pytest.raises(ValueError, match="cls_head"):
        convert.colberter_params_from_numpy(params, cfg, "cpu")


# -- layers ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layer_norm_matches_reference(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = (3.0 + 2.0 * rng.standard_normal((3, 5, 64))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = np.asarray(ref_layer_norm(jnp.asarray(x, jd), jnp.asarray(scale),
                                     jnp.asarray(bias), 1e-12)
                      .astype(jnp.float32))
    got = layer_norm(torch.tensor(x).to(td), torch.tensor(scale),
                     torch.tensor(bias), 1e-12)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL[dtype] if dtype == "bf16" else 1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gelu_mlp_matches_reference(dtype):
    """The tanh form: torch's default (erf) GELU misses the fp32
    tolerance."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    w1 = (rng.standard_normal((64, 128)) / 8).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(128)).astype(np.float32)
    w2 = (rng.standard_normal((128, 64)) / 11).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = np.asarray(ref_gelu_mlp(*(jnp.asarray(a, jd) for a in
                                     (x, w1, b1, w2, b2)))
                      .astype(jnp.float32))
    got = gelu_mlp(*(torch.tensor(a).to(td) for a in (x, w1, b1, w2, b2)))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL[dtype])
    if dtype == "fp32":
        erf = torch.nn.functional.gelu(torch.tensor(x) @ torch.tensor(w1)
                                       + torch.tensor(b1)) \
            @ torch.tensor(w2) + torch.tensor(b2)
        assert np.abs(erf.numpy() - want).max() > TOL["fp32"]


# -- encode ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_encode_matches_reference(dtype):
    ref_cfg, cfg = configs(dtype)
    params = numpy_params(ref_cfg)
    model = convert.colberter_params_from_numpy(params, cfg, "cpu")
    toks = tokens(cfg)
    r_cls, r_bow, r_mask = ref_col.encode(ref_cfg, _to_jnp(params),
                                          jnp.asarray(toks))
    cls, bow, mask = colberter.encode(cfg, model, toks)
    assert cls.dtype == torch.float32 and bow.dtype == cfg.dtype
    assert cls.shape == (4, cfg.d_cls) and bow.shape == (4, toks.shape[1],
                                                         cfg.d_bow)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(r_mask))
    np.testing.assert_allclose(cls.numpy(), np.asarray(r_cls), rtol=0,
                               atol=TOL[dtype])
    np.testing.assert_allclose(bow.float().numpy(),
                               np.asarray(r_bow.astype(jnp.float32)),
                               rtol=0, atol=TOL[dtype])
    # pads are zero; valid tokens unit length
    assert not bow[~mask].any()
    norms = bow[mask].float().norm(dim=-1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=TOL[dtype])
    # an explicit mask gives the same as the pads' own; module call too
    again = model(np.where(toks < 0, 0, toks), mask=toks >= 0)
    assert torch.equal(again[0], cls) and torch.equal(again[1], bow)


def _to_jnp(tree):
    return {k: _to_jnp(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def test_queries_do_not_depend_on_their_batch():
    """A query encoded alone equals its row of a batch (pads change
    nothing of a row's valid tokens, up to the fp32 tolerance)."""
    _, cfg = configs("fp32")
    model = colberter.init_params(cfg, torch.Generator().manual_seed(1),
                                  "cpu")
    toks = tokens(cfg, seed=4)
    cls, bow, _ = colberter.encode(cfg, model, toks)
    for row in range(toks.shape[0]):
        c1, b1, _ = colberter.encode(cfg, model, toks[row:row + 1])
        np.testing.assert_allclose(c1[0].numpy(), cls[row].numpy(),
                                   atol=TOL["fp32"])
        np.testing.assert_allclose(b1[0].numpy(), bow[row].numpy(),
                                   atol=TOL["fp32"])


def test_example_runs_on_the_cpu():
    """``examples/espn_serving_torch.py`` at a tiny size: the encoder in
    the loop, then mmap, gds and espn through ``with_mode``."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "espn_serving_torch.py"),
         "--device", "cpu", "--docs", "600", "--queries", "8"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("encoder:")
    for mode in ("mmap", "gds", "espn"):
        assert any(ln.startswith(mode) and "MRR@10=" in ln for ln in lines)


# -- training ---------------------------------------------------------------

def pair_batch(cfg, seed=5, n=6):
    """``n`` query/doc pairs, [CLS] first, with pads (-1) at the tails of
    most rows (one query of a single token, one full doc)."""
    r = np.random.default_rng(seed)
    q = r.integers(1, cfg.vocab_size, (n, cfg.max_query_len))
    d = r.integers(1, cfg.vocab_size, (n, cfg.max_doc_len))
    q[:, 0] = d[:, 0] = 0
    for row in range(n):
        q[row, r.integers(1, cfg.max_query_len + 1):] = -1
        d[row, (cfg.max_doc_len, 2)[row] if row < 2 else
          r.integers(1, cfg.max_doc_len):] = -1
    return {"query_tokens": q.astype(np.int32),
            "pos_doc_tokens": d.astype(np.int32)}


def ref_init(ref_cfg, seed=0):
    """The reference's own ``init_params`` at PRNGKey(seed), as numpy."""
    return jax.tree.map(np.asarray,
                        ref_col.init_params(ref_cfg, jax.random.PRNGKey(seed)))


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_contrastive_loss_matches_reference(dtype):
    ref_cfg, cfg = configs(dtype)
    params = ref_init(ref_cfg)
    batch = pair_batch(cfg)
    want, aux = ref_col.contrastive_loss(ref_cfg, _to_jnp(params),
                                         _to_jnp(batch))
    model = convert.colberter_params_from_numpy(params, cfg, "cpu")
    loss, got_aux = colberter.contrastive_loss(cfg, model,
                                               torch_batch(batch))
    assert set(got_aux) == set(aux) == {"ce", "alpha"}
    assert loss.dtype == torch.float32 and loss.requires_grad
    assert abs(float(loss.detach()) - float(want)) <= TOL[dtype]
    assert float(got_aux["alpha"].detach()) == float(aux["alpha"]) == 1.0
    assert torch.equal(got_aux["ce"], loss)


def test_contrastive_grads_match_jax():
    """Every leaf's gradient within 1e-4 of the leaf's largest |gradient|
    (fp32 sums in other orders through 2 layers, LayerNorm and the softmax),
    plus 1e-7: ``layers/bk``'s gradient is zero in exact arithmetic (a key
    bias adds the same to every score of a query, which the softmax
    cancels), so both packages give rounding noise of ~1e-8 there."""
    ref_cfg, cfg = configs("fp32")
    params = ref_init(ref_cfg)
    batch = pair_batch(cfg)
    want = flatten(jax.tree.map(np.asarray, jax.grad(
        lambda p: ref_col.contrastive_loss(ref_cfg, p, _to_jnp(batch))[0])(
        _to_jnp(params))))
    model = convert.colberter_params_from_numpy(params, cfg, "cpu")
    loss, _ = colberter.contrastive_loss(cfg, model, torch_batch(batch))
    named = named_params(model)
    grads = torch.autograd.grad(loss, list(named.values()))
    assert set(named) == set(want)
    for name, g in zip(named, grads):
        assert g.dtype == torch.float32 and g.shape == want[name].shape
        err = float(np.abs(g.numpy() - want[name]).max())
        assert err <= 1e-4 * float(np.abs(want[name]).max()) + 1e-7, name
    assert float(np.abs(want["layers/bk"]).max()) < 1e-6


def test_adamw_steps_match_reference():
    """5 AdamW steps (lr 1e-3, warm-up 30, clip 5: the example's) from the
    reference's init in both packages: each step's loss and grad norm
    within 1e-5 x max(1, |ref|), and the weights after. A weight whose
    gradient is near zero moves by about +-lr_t at each step whatever the
    gradient's size (Adam divides by its own scale), so where the two
    packages' rounding gives that gradient the other sign the weight
    differs by up to 2 x sum(lr_t) = 1.33e-3: ``layers/bk``, whose exact
    gradient is 0, is all such weights, and is held to that bound; every
    other weight within 1e-5."""
    ref_cfg, cfg = configs("fp32")
    params = ref_init(ref_cfg)
    ref_opt, opt = (RefAdamW(lr=1e-3, grad_clip=5.0, warmup_steps=30),
                    AdamW(lr=1e-3, grad_clip=5.0, warmup_steps=30))
    ref_step = jax.jit(ref_make_train_step(
        lambda p, b: ref_col.contrastive_loss(ref_cfg, p, b), ref_opt))
    step = make_train_step(lambda p, b: colberter.contrastive_loss(cfg, p, b),
                           opt)
    ref_p, ref_o = _to_jnp(params), ref_opt.init(_to_jnp(params))
    model = convert.colberter_params_from_numpy(params, cfg, "cpu")
    state = opt.init(model)
    for i in range(5):
        batch = pair_batch(cfg, seed=10 + i)
        ref_p, ref_o, want = ref_step(ref_p, ref_o, _to_jnp(batch))
        model, state, got = step(model, state, torch_batch(batch))
        assert set(got) == set(want) == {"loss", "gnorm", "ce", "alpha"}
        for k in ("loss", "gnorm", "alpha"):
            assert abs(float(got[k]) - float(want[k])) <= 1e-5 * max(
                1.0, abs(float(want[k]))), (i, k)
    assert int(state["step"]) == int(ref_o["step"]) == 5
    lr_sum = sum(ref_opt.lr * min(1.0, (t + 1) / 30) for t in range(1, 6))
    for name, a in flatten(jax.tree.map(np.asarray, ref_p)).items():
        err = np.abs(named_params(model)[name].detach().numpy() - a).max()
        assert err <= (2 * lr_sum + 1e-6 if name == "layers/bk" else 1e-5), \
            name


def test_resume_replays_the_history_bit_for_bit(tmp_path):
    """A Trainer resumed from its step-4 checkpoint gives steps 4-7's
    losses and grad norms bit for bit, and the same final weights (the CPU
    is deterministic; on the card the embedding backward's atomics are
    not, see ``train/trainer.py``)."""
    _, cfg = configs("fp32")

    def trainer(directory):
        model = colberter.init_params(cfg, torch.Generator().manual_seed(3),
                                      "cpu")
        return Trainer(TrainerConfig(total_steps=8, ckpt_every=4,
                                     ckpt_dir=str(directory)),
                       lambda p, b: colberter.contrastive_loss(cfg, p, b),
                       AdamW(lr=1e-3, warmup_steps=2),
                       lambda i: torch_batch(pair_batch(cfg, seed=i)), model)

    full = trainer(tmp_path / "a")
    h1 = full.run(verbose=False)
    assert full.ckpt.all_steps() == [4, 8]
    shutil.copytree(tmp_path / "a" / "step_4", tmp_path / "b" / "step_4")
    again = trainer(tmp_path / "b")
    assert again.maybe_resume() == 4
    h2 = again.run(verbose=False)
    assert [m["step"] for m in h2] == [4, 5, 6, 7]
    for a, b in zip(h1[4:], h2):
        assert (a["loss"], a["gnorm"]) == (b["loss"], b["gnorm"])
    for (name, p), q in zip(full.params.named_parameters(),
                            again.params.parameters()):
        assert torch.equal(p, q), name
