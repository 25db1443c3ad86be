"""The port's GatedGCN (``repro_torch.models.gnn``), its segment ops and the
fanout sampler (``repro_torch.data.sampler``) against the JAX package's, on
the CPU.

The same weights, drawn from a numpy seed in the reference's structure and
by its init kinds (scales and biases moved, so that they count), go into
both packages, the port's through ``convert.gnn_params_from_numpy``, with
the same numpy graphs. Held at
``smoke_config``: the forward within 2e-5 x max(1, |ref|) in fp32 and 3e-2
in bf16; the three ``loss_fn`` modes (full graph, a sampled block's
``label_nodes``, a molecule batch's ``graph_ids``) and every gradient in
fp32 against ``jax.grad`` within 1e-5 x max(1, |ref|).

Padded edges (``dst = n_nodes``): the port's padded forward equals the
reference's padded forward, and the port's padded gradients are finite and
equal the reference's gradients of the unpadded batch. (The reference's
``jnp.take`` fills a pad's row with NaN; its segment sums drop the pads in
the forward, but not in the backward.)

The sampler: ``CSRGraph``, ``random_graph`` and ``sample_block`` give the
reference's arrays exactly, for the same graph, seeds and generator.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.data import sampler as ref_sampler
from repro.models import gnn as ref_gnn
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import sampler
from repro_torch.models import gnn
from repro_torch.models.segment_ops import Segments
from repro_torch.train.checkpoint import flatten, unflatten
from repro_torch.train.optimizer import named_params

DTYPES = {"fp32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
D_IN = 12


def to_np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def assert_rel(got, want, tol, what=""):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale, what


def cfgs(dtype="fp32"):
    jdt, tdt, _ = DTYPES[dtype]
    return (ref_gnn.smoke_config(ref_base.get_config("gatedgcn")).scaled(
        dtype=jdt),
        gnn.smoke_config(get_config("gatedgcn")).scaled(dtype=tdt))


def ref_init(ref_cfg, d_in=D_IN, seed=0):
    """Weights in the reference's structure (its ``param_shapes``), drawn
    from a numpy seed by its init kinds: LeCun-normal fan-in matrices, the
    norm scales 1 + N(0, 0.1) and the biases N(0, 0.1) (the reference's
    ones and zeros, moved so that they count)."""
    r = np.random.default_rng(seed)
    flat = {}
    for name, s in sorted(flatten(ref_gnn.param_shapes(ref_cfg,
                                                       d_in)).items()):
        a = r.standard_normal(s.shape)
        if name.endswith("scale"):
            a = 1 + 0.1 * a
        elif name.endswith(("b", "bias")):
            a = 0.1 * a
        else:
            a = a * s.shape[-2] ** -0.5
        flat[name] = a.astype(np.float32)
    return unflatten(flat)


def graph(seed=1, n=40, e=120, pads=0, n_classes=5):
    """A random graph (edges in [0, n)), ``pads`` pad edges (src 0,
    dst n) appended, labels for every node."""
    r = np.random.default_rng(seed)
    src = r.integers(0, n, e)
    dst = r.integers(0, n, e)
    return {"node_feats": r.standard_normal((n, D_IN)).astype(np.float32),
            "edge_src": np.concatenate([src, np.zeros(pads)]).astype(np.int32),
            "edge_dst": np.concatenate([dst, np.full(pads, n)]
                                       ).astype(np.int32),
            "labels": r.integers(0, n_classes, n).astype(np.int32)}


def block(seed=2):
    """A sampled block from ``sample_block`` (padded to 512 edges) with its
    seed nodes' labels: the ``minibatch_lg`` mode at a tiny size."""
    g = sampler.random_graph(300, avg_degree=6, seed=seed)
    r = np.random.default_rng(seed)
    blk = sampler.sample_block(g, np.arange(16), [4, 3], r, pad_edges_to=512)
    n = len(blk["node_ids"])
    return {"node_feats": r.standard_normal((n, D_IN)).astype(np.float32),
            "edge_src": blk["edge_src"], "edge_dst": blk["edge_dst"],
            "label_nodes": blk["seed_local"],
            "labels": r.integers(0, 5, 16).astype(np.int32)}


def molecules(seed=3, graphs=6, nodes=7, edges=10):
    """``graphs`` graphs of ``nodes`` nodes and ``edges`` edges each, one
    label a graph (the ``molecule`` mode's ``graph_ids`` readout)."""
    r = np.random.default_rng(seed)
    base = np.repeat(np.arange(graphs) * nodes, edges)
    n = graphs * nodes
    return {"node_feats": r.standard_normal((n, D_IN)).astype(np.float32),
            "edge_src": (base + r.integers(0, nodes, base.size)
                         ).astype(np.int32),
            "edge_dst": (base + r.integers(0, nodes, base.size)
                         ).astype(np.int32),
            "graph_ids": np.repeat(np.arange(graphs), nodes).astype(np.int32),
            "labels": r.integers(0, 5, graphs).astype(np.int32)}


def unpad(batch):
    """``batch`` without its pad edges (dst = n_nodes)."""
    real = batch["edge_dst"] < batch["node_feats"].shape[0]
    return dict(batch, edge_src=batch["edge_src"][real],
                edge_dst=batch["edge_dst"][real])


#: the three loss modes' batches, without pads (the reference's gradients
#: of a padded batch are NaN)
BATCHES = {"full_graph": graph, "label_nodes": lambda: unpad(block()),
           "graph_ids": molecules}


def ref_loss_and_grads(ref_cfg, params, batch):
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p, b: ref_gnn.loss_fn(ref_cfg, p, b), has_aux=True))(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), flatten(jax.tree.map(np.asarray, g))


def port_loss_and_grads(cfg, params, batch):
    tp = convert.gnn_params_from_numpy(params, cfg, D_IN, "cpu")
    named = named_params(tp)
    for t in named.values():
        t.requires_grad_(True)
    loss, aux = gnn.loss_fn(cfg, tp, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    assert set(aux) == {"ce"}
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.item(), dict(zip(named, grads))


# -- config, shapes, params ----------------------------------------------------

def test_config_matches_reference():
    """Every field (dtypes mapped) of the config and its smoke config."""
    ref, port = ref_base.get_config("gatedgcn"), get_config("gatedgcn")
    for r, p in ((ref, port), (ref_gnn.smoke_config(ref),
                               gnn.smoke_config(port))):
        fields = {f.name for f in dataclasses.fields(p)}
        assert {f.name for f in dataclasses.fields(r)} == fields
        for f in fields - {"dtype", "param_dtype"}:
            assert getattr(p, f) == getattr(r, f), f
        assert (p.dtype, p.param_dtype) == (torch.bfloat16, torch.float32)


@pytest.mark.parametrize("d_in", [1433, 602, 100, 16])
def test_param_shapes_match_reference(d_in):
    """The published width at each GNN shape's feature width."""
    want = flatten(ref_gnn.param_shapes(ref_base.get_config("gatedgcn"),
                                        d_in))
    got = flatten(gnn.param_shapes(get_config("gatedgcn"), d_in))
    assert set(got) == set(want)
    for name, s in want.items():
        assert got[name].device.type == "meta"
        assert (tuple(got[name].shape), got[name].dtype) == (
            s.shape, torch.float32), name


def test_init_params_and_from_numpy():
    ref_cfg, cfg = cfgs()
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), D_IN,
                             "cpu")
    want = flatten(gnn.param_shapes(cfg, D_IN))
    got = flatten(params)
    assert {k: tuple(t.shape) for k, t in got.items()} == {
        k: tuple(t.shape) for k, t in want.items()}
    assert bool((got["layers/h_scale"] == 1).all())
    assert not got["out/b"].any()
    ref = ref_init(ref_cfg)
    tp = flatten(convert.gnn_params_from_numpy(ref, cfg, D_IN, "cpu"))
    for name, a in flatten(ref).items():
        np.testing.assert_array_equal(tp[name].numpy(), a)
    with pytest.raises(ValueError, match="shape"):
        convert.gnn_params_from_numpy(ref, cfg, D_IN + 1, "cpu")


# -- segment ops ---------------------------------------------------------------

def test_segments_sum_and_gather_with_pads():
    """Sums in index order (pads, index n, dropped), counts, a ``padded``
    index's gather with zero rows at the pads, and its backward: the
    gradient rows summed by index, nothing from the pads. An index without
    pads gathers and sums its gradient alike."""
    r = np.random.default_rng(7)
    idx = np.array([3, 0, 3, 5, 1, 3, 5, 5, 0, 6, 6])   # 6 = n: pads
    x = r.standard_normal((len(idx), 4)).astype(np.float32)
    seg = Segments(torch.from_numpy(idx), 6, padded=True)
    want = np.zeros((6, 4), np.float32)
    for i, row in zip(idx, x):
        if i < 6:
            want[i] += row
    np.testing.assert_allclose(seg.sum(torch.from_numpy(x)).numpy(), want,
                               rtol=1e-6)
    assert seg.counts().tolist() == [2, 1, 0, 3, 0, 3]
    h = torch.from_numpy(r.standard_normal((6, 4)).astype(np.float32))
    h.requires_grad_(True)
    out = seg.gather(h)
    np.testing.assert_array_equal(out.detach().numpy()[:9],
                                  h.detach().numpy()[idx[:9]])
    assert not out[9:].any()
    (g,) = torch.autograd.grad((out * torch.from_numpy(x)).sum(), [h])
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-6)
    plain = Segments(torch.from_numpy(idx[:9]), 6).gather(h)
    assert torch.equal(plain, out[:9])
    (g_plain,) = torch.autograd.grad((plain * torch.from_numpy(x[:9])).sum(),
                                     [h])
    assert torch.equal(g_plain, g)
    empty = Segments(torch.tensor([2, 2]), 2)
    assert not empty.sum(torch.ones(2, 3)).any()


# -- the model -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_matches_reference(dtype):
    ref_cfg, cfg = cfgs(dtype)
    params = ref_init(ref_cfg)
    b = graph()
    want = jax.jit(lambda p, f, s, d: ref_gnn.forward(ref_cfg, p, f, s, d))(
        jax.tree.map(jnp.asarray, params), b["node_feats"], b["edge_src"],
        b["edge_dst"])
    got = gnn.forward(cfg, convert.gnn_params_from_numpy(
        params, cfg, D_IN, "cpu"), *(torch.from_numpy(b[k]) for k in (
            "node_feats", "edge_src", "edge_dst")))
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (40, 5)
    assert_rel(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("mode", list(BATCHES))
def test_loss_and_grads_match_jax(mode):
    ref_cfg, cfg = cfgs()
    params = ref_init(ref_cfg)
    batch = BATCHES[mode]()
    want_loss, want = ref_loss_and_grads(ref_cfg, params, batch)
    loss, grads = port_loss_and_grads(cfg, params, batch)
    assert abs(loss - want_loss) <= 1e-5 * max(1.0, abs(want_loss))
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert_rel(g, want[name], 1e-5, name)


def test_remat_gives_the_same_bits():
    """``remat`` recomputes each layer in the backward: the same loss and
    gradients, bit for bit."""
    ref_cfg, cfg = cfgs()
    params, batch = ref_init(ref_cfg), graph()
    loss, grads = port_loss_and_grads(cfg, params, batch)
    loss_r, grads_r = port_loss_and_grads(cfg.scaled(remat=True), params,
                                          batch)
    assert loss == loss_r
    for name, g in grads.items():
        assert torch.equal(g, grads_r[name]), name


def test_padded_forward_matches_reference():
    """The reference's own padded case (20 nodes, 50 edges, 14 pads): the
    port's padded forward equals the reference's padded forward, and the
    port's unpadded one."""
    ref_cfg, cfg = cfgs()
    params = ref_init(ref_cfg)
    tp = convert.gnn_params_from_numpy(params, cfg, D_IN, "cpu")
    out = {}
    for pads in (0, 14):
        b = graph(seed=4, n=20, e=50, pads=pads)
        want = ref_gnn.forward(ref_cfg, jax.tree.map(jnp.asarray, params),
                               b["node_feats"], b["edge_src"], b["edge_dst"])
        out[pads] = gnn.forward(cfg, tp, *(torch.from_numpy(b[k]) for k in (
            "node_feats", "edge_src", "edge_dst")))
        assert_rel(out[pads], want, 2e-5)
    assert_rel(out[14], out[0], 1e-6)


@pytest.mark.parametrize("mode", ["full_graph", "label_nodes"])
def test_padded_grads_are_finite_and_equal_the_unpadded_reference(mode):
    """Pads appended to a batch: the port's loss and every gradient are
    finite and equal the reference's on the batch without its pads (the
    sampled block's own pads taken out for the reference)."""
    ref_cfg, cfg = cfgs()
    params = ref_init(ref_cfg)
    padded = (graph(seed=5, pads=72) if mode == "full_graph" else block(6))
    unpadded = unpad(padded)
    assert len(unpadded["edge_dst"]) < len(padded["edge_dst"])
    want_loss, want = ref_loss_and_grads(ref_cfg, params, unpadded)
    loss, grads = port_loss_and_grads(cfg, params, padded)
    assert np.isfinite(loss)
    assert abs(loss - want_loss) <= 1e-5 * max(1.0, abs(want_loss))
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all()), name
        assert_rel(g, want[name], 1e-5, name)


# -- the sampler ---------------------------------------------------------------

def test_csr_graph_matches_reference():
    r = np.random.default_rng(8)
    src, dst = r.integers(0, 50, 400), r.integers(0, 50, 400)
    for a, b in ((sampler.CSRGraph.from_edges(src, dst, 50),
                  ref_sampler.CSRGraph.from_edges(src, dst, 50)),
                 (sampler.random_graph(500, avg_degree=8, seed=1),
                  ref_sampler.random_graph(500, avg_degree=8, seed=1))):
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        assert a.n_nodes == b.n_nodes
        for v in (0, 3, 49):
            np.testing.assert_array_equal(a.neighbors(v), b.neighbors(v))
    g = sampler.CSRGraph.from_edges(np.array([0, 0, 1, 2, 2, 2]),
                                    np.array([1, 2, 0, 0, 1, 3]), 4)
    assert sorted(g.neighbors(2).tolist()) == [0, 1, 3]
    assert g.neighbors(3).tolist() == []


@pytest.mark.parametrize("case", [
    # (n, degree, graph seed, n_seeds, fanouts, rng seed, pad_edges_to)
    (500, 8, 1, 16, [5, 3], 0, None),        # the reference's fanout test
    (200, 4, 2, 8, [3, 2], 1, 512),          # its padding test
    (300, 2, 3, 32, [15, 10], 4, 64),        # more edges than the pad: cut
    (1000, 20, 5, 24, [15, 10], 9, 4096)])   # fanout 15-10, padded
def test_sample_block_matches_reference(case):
    n, deg, gseed, n_seeds, fanouts, seed, pad = case
    blocks = []
    for lib in (sampler, ref_sampler):
        g = lib.random_graph(n, avg_degree=deg, seed=gseed)
        rng = np.random.default_rng(seed)
        seeds = rng.choice(n, n_seeds, replace=False)
        blocks.append(lib.sample_block(g, seeds, fanouts, rng,
                                       pad_edges_to=pad))
    got, want = blocks
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if pad:
        assert len(got["edge_src"]) == pad
