"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device each test skips with its reason
(the kernels have no CPU mode; the CPU tests hold the plain versions to the
JAX package). This file imports neither ``jax`` nor ``repro``, so it runs on
a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quantize import binary_pack, to_uint32_lanes
from repro_torch.kernels.bitsim import ops as bitsim_ops
from repro_torch.kernels.bitsim.ref import bitsim_ref
from repro_torch.kernels.fdescan import ops as fdescan_ops
from repro_torch.kernels.fdescan.ref import fdescan_ref
from repro_torch.kernels.flash_decode import ops
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.ivf_scan import ops as ivf_ops
from repro_torch.kernels.ivf_scan.ref import ivf_scan_ref
from repro_torch.kernels.maxsim import ops as maxsim_ops
from repro_torch.kernels.maxsim.ref import maxsim_ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_matches_plain_version_on_the_card(card, dtype):
    """Every Dh, G of 1, 3 and 8, ragged lengths with 1, S and 0, and an S
    that is no multiple of the split. fp32 within 1e-5 x max(1, |ref|);
    bf16/fp16 within one ulp of the output dtype. One call is one launch,
    and a second call gives the same bits (the splits are combined in a
    fixed order)."""
    ulp = {torch.float32: 1e-5, torch.bfloat16: 2**-7,
           torch.float16: 2**-10}[dtype]
    s = 300
    for dh in (16, 32, 64, 128):
        for g in (1, 3, 8):
            r = np.random.default_rng(dh + g)
            args = [torch.from_numpy(r.standard_normal(shape).astype(
                np.float32)).to(card, dtype)
                for shape in ((4, 3, g, dh), (4, s, 3, dh), (4, s, 3, dh))]
            args.append(torch.tensor([1, s, 0, 123], dtype=torch.int32,
                                     device=card))
            before = ops.flash_decode.launches
            out = ops.flash_decode(*args)
            again = ops.flash_decode(*args)
            ref = flash_decode_ref(*args)
            torch.cuda.synchronize()
            assert ops.flash_decode.launches == before + 2
            assert torch.equal(out, again)
            assert out.dtype == dtype and out.shape == ref.shape
            err = float((out.float() - ref.float()).abs().max())
            assert err <= ulp * max(1.0, float(ref.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("kv,g,dh", [(8, 2, 64), (2, 7, 64), (8, 5, 128)])
def test_kernel_at_the_other_lms_decode_shapes(card, kv, g, dh, dtype):
    """granite's G 2 over KV 8 (a part-filled G tile of 3), qwen2's G 7
    over KV 2 and llama4's G 5 over KV 8 at Dh 128 (part-filled tiles of
    8), ragged lengths: as above."""
    ulp = {torch.float32: 1e-5, torch.bfloat16: 2**-7,
           torch.float16: 2**-10}[dtype]
    s = 300
    r = np.random.default_rng(kv * 100 + g * 10 + dh)
    args = [torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(
        card, dtype) for shape in ((4, kv, g, dh), (4, s, kv, dh),
                                   (4, s, kv, dh))]
    args.append(torch.tensor([1, s, 0, 123], dtype=torch.int32, device=card))
    before = ops.flash_decode.launches
    out = ops.flash_decode(*args)
    again = ops.flash_decode(*args)
    ref = flash_decode_ref(*args)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 2
    assert torch.equal(out, again)
    assert out.dtype == dtype and out.shape == ref.shape
    err = float((out.float() - ref.float()).abs().max())
    assert err <= ulp * max(1.0, float(ref.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("s,kv,g,dh", [(4128, 3, 3, 64), (4128, 8, 2, 64),
                                       (4128, 2, 7, 64), (1032, 8, 5, 128)])
def test_kernel_at_the_decode_paths_first_step(card, s, kv, g, dh):
    """The first decode step of SmolLM's, granite's and qwen2's 8 x 4,096
    prompts and llama4's 8 x 1,024 (cache of prompt + steps slots, every
    length prompt + 1), bf16: within one ulp, one launch a call."""
    r = np.random.default_rng(s + kv * 100 + g * 10 + dh)
    args = [torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(
        card, torch.bfloat16) for shape in ((8, kv, g, dh), (8, s, kv, dh),
                                            (8, s, kv, dh))]
    steps = 32 if s == 4128 else 8
    args.append(torch.full((8,), s - steps + 1, dtype=torch.int32,
                           device=card))
    before = ops.flash_decode.launches
    out = ops.flash_decode(*args)
    ref = flash_decode_ref(*args)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    err = float((out.float() - ref.float()).abs().max())
    assert err <= 2**-7 * max(1.0, float(ref.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,fp16,kernel", [
    (1, 1000, 256, True, "wgmma"), (33, 1037, 128, True, "wgmma"),
    (64, 4099, 256, True, "wgmma"), (70, 3001, 256, True, "wgmma"),
    (8, 300, 100, False, "simt"), (8, 300, 100, True, "simt"),
    (8, 300, 256, False, "simt")])
def test_fdescan_matches_plain_version_on_the_card(card, b, n, d, fp16,
                                                   kernel):
    """Both kernels: the tensor-core one (fp16 table, D a multiple of 8;
    B of 1, 33, 64 and 70, ragged N, D 128 and 256) and the SIMT one (an
    fp32 table, D=100), each within 1e-5 x max(1, |ref|) of the plain
    version on the slice's distribution, exactly (B, N)."""
    r = np.random.default_rng(b * 7 + n)
    q = torch.from_numpy(r.standard_normal((b, d)).astype(np.float32)).to(
        card)
    docs = torch.from_numpy(
        (0.1 * r.standard_normal((n, d))).astype(np.float32)).to(card)
    if fp16:
        docs = docs.half()
    assert fdescan_ops.kernel_for(q, docs) == kernel
    before = fdescan_ops.fdescan.launches
    out = fdescan_ops.fdescan(q, docs)
    ref = fdescan_ref(q, docs)
    torch.cuda.synchronize()
    assert fdescan_ops.fdescan.launches == before + 1
    assert out.shape == (b, n) and out.dtype == torch.float32
    err = float((out - ref).abs().max())
    assert err <= 1e-5 * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("fp16", [True, False])
@pytest.mark.parametrize("d", [32, 16, 100])
@pytest.mark.parametrize("lq", [1, 24, 32, 33])
def test_maxsim_matches_plain_version_on_the_card(card, lq, d, fp16):
    """Both kernels at ragged shapes: K of 1 and 37, two K taken from the
    card's SM count and 1,000, so that the ``mma`` kernel's four instances
    (a block of 1, 2, 4 or 8 docs) all run; lengths with 0, T and above T,
    Lq up to 33, D of 16, 32 and 100, fp16 and fp32 docs; each case names
    the kernel it takes (``mma``: fp16 docs, D of 16/32/64, Lq <= 32). Docs
    with a token within 1e-5 x max(1, |ref|), zero-length docs within 1e-6
    relative; a second call gives the same bits."""
    t = 180
    want = "mma" if fp16 and d in (16, 32, 64) and lq <= 32 else "simt"
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    ks = (1, 37, 2 * sms - 7, 4 * sms - 9, 1000)
    assert {maxsim_ops.mma_docs_per_block(k) for k in ks} == {1, 2, 4, 8}
    for k in ks:
        r = np.random.default_rng(k * 131 + lq * 7 + d)
        q = r.standard_normal((lq, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        qm = (r.random(lq) > 0.2).astype(np.float32)
        docs = r.standard_normal((k, t, d)).astype(np.float32)
        docs /= np.linalg.norm(docs, axis=2, keepdims=True)
        lens = np.clip((r.pareto(2.5, k) + 1) * 36, 8, t).astype(np.int32)
        lens[:min(k, 4)] = [0, t, t + 1, 1][:min(k, 4)]
        args = [torch.from_numpy(a).to(card) for a in (q, qm, docs, lens)]
        if fp16:
            args[2] = args[2].half()
        assert maxsim_ops.kernel_for(args[0], args[2]) == want
        before = maxsim_ops.maxsim.launches
        out = maxsim_ops.maxsim(*args)
        again = maxsim_ops.maxsim(*args)
        ref = maxsim_ref(*args)
        torch.cuda.synchronize()
        assert maxsim_ops.maxsim.launches == before + 2
        assert out.shape == (k,) and out.dtype == torch.float32
        assert torch.equal(out, again)
        live = args[3] > 0
        if live.any():
            err = float((out[live] - ref[live]).abs().max())
            assert err <= 1e-5 * max(1.0, float(ref[live].abs().max()))
        assert torch.allclose(out[~live], ref[~live], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [
    (b, n, d) for b in (1, 33, 64, 70) for n in (37, 130, 3703)
    for d in (32, 100, 128)] + [(5, 77, 37)] + [
    (b, n, d) for b in (1, 70) for n in (130, 3703)
    for d in (130, 160, 256, 258, 300, 520)])
def test_ivf_scan_matches_plain_version_on_the_card(card, b, n, d):
    """B of 1, 33, 64 and 70 (row groups of 32, ragged), N of 37, 130 and
    3,703 (column tiles of 32, ragged), D of 32, 100 and 128 (chunks of
    32, a ragged one), and D = 37 (4-byte copies). D past 128 goes in
    rounds of four chunks through two buffers: 2 rounds (D 130, 160, 256),
    3 (D 258, 300: the first buffer's barriers on their second phase) and
    5 (D 520), on 16-byte copies and on 4-byte ones (D 130, 258). Each
    within 1e-5 x max(1, |ref|) of the plain version, exactly (B, N), the
    same bits twice."""
    r = np.random.default_rng(b * 1000 + n + d)
    q = torch.from_numpy(r.standard_normal((b, d)).astype(np.float32)).to(
        card)
    c = torch.from_numpy(r.standard_normal((n, d)).astype(np.float32)).to(
        card)
    before = ivf_ops.centroid_scores.launches
    out = ivf_ops.centroid_scores(q, c)
    again = ivf_ops.centroid_scores(q, c)
    ref = ivf_scan_ref(q, c)
    torch.cuda.synchronize()
    assert ivf_ops.centroid_scores.launches == before + 2
    assert out.shape == (b, n) and out.dtype == torch.float32
    assert torch.equal(out, again)
    err = float((out - ref).abs().max())
    assert err <= 1e-5 * max(1.0, float(ref.abs().max()))


def bitsim_case(card, k, t, d, lq, seed, lanes="uint32"):
    """Unit q, a query mask, the signs of normal doc tokens (in uint8 lanes
    re-viewed as 32-bit ones, or uint32), Pareto lengths with 0, T, above
    T and 1 first."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((lq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qm = (r.random(lq) > 0.2).astype(np.float32)
    packed = to_uint32_lanes(binary_pack(
        r.standard_normal((k, t, d)).astype(np.float32), dtype=lanes))
    lens = np.clip((r.pareto(2.5, k) + 1) * 36, 8, t).astype(np.int32)
    lens[:min(k, 4)] = [0, t, t + 1, 1][:min(k, 4)]
    return [torch.from_numpy(a).to(card)
            for a in (q, qm, packed.view(np.int32), lens)]


def check_bitsim(args, want):
    """The kernel ``kernel_for`` names, one launch a call, the same bits
    twice; docs with a token within 1e-5 x max(1, |ref|), zero-length docs
    within 1e-6 relative."""
    k = args[2].shape[0]
    assert bitsim_ops.kernel_for(args[0], args[2]) == want
    before = bitsim_ops.bitsim.launches
    out = bitsim_ops.bitsim(*args)
    again = bitsim_ops.bitsim(*args)
    ref = bitsim_ref(*args)
    torch.cuda.synchronize()
    assert bitsim_ops.bitsim.launches == before + 2
    assert out.shape == (k,) and out.dtype == torch.float32
    assert torch.equal(out, again)
    live = args[3] > 0
    if live.any():
        err = float((out[live] - ref[live]).abs().max())
        assert err <= 1e-5 * max(1.0, float(ref[live].abs().max()))
    assert torch.allclose(out[~live], ref[~live], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 16, 32, 40, 64])
@pytest.mark.parametrize("lq", [1, 7, 24, 32, 33])
def test_bitsim_matches_plain_version_on_the_card(card, lq, d):
    """Both kernels at ragged shapes: K of 1 and 37, two K taken from the
    card's SM count and 1,000, so that the ``mma`` kernel's four docs-a-
    block choices (1, 2, 4 and 8 warps) all run; lengths with 0, T and
    above T; D of 1, 8, 16, 32 (one lane: 2 steps of 16), 40 and 64 (two
    lanes: 3 and 4 steps), Lq of 1, 7, 24, 32 (``mma``) and 33
    (``simt``)."""
    t = 180
    want = "mma" if lq <= 32 else "simt"
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    ks = (1, 37, 2 * sms - 7, 4 * sms - 9, 1000)
    assert {bitsim_ops.mma_docs_per_block(k) for k in ks} == {1, 2, 4, 8}
    for k in ks:
        check_bitsim(bitsim_case(card, k, t, d, lq, k * 131 + lq * 7 + d),
                     want)


@pytest.mark.cuda
@pytest.mark.parametrize("k,t,d,lq,lanes,want", [
    (1000, 180, 32, 24, "uint8", "mma"), (333, 180, 40, 7, "uint8", "mma"),
    (1000, 1024, 32, 24, "uint32", "mma"),
    (50, 1100, 32, 24, "uint32", "simt"), (50, 1100, 64, 7, "uint8", "simt"),
    (60, 180, 96, 24, "uint32", "simt")])
def test_bitsim_lanes_and_long_docs_on_the_card(card, k, t, d, lq, lanes,
                                                 want):
    """uint8 lanes re-viewed as 32-bit ones on the ``mma`` kernel; T of
    1,024 (its longest: four rounds of loads) and, past it, 1,100 on the
    ``simt`` kernel, as is D = 96."""
    check_bitsim(bitsim_case(card, k, t, d, lq, k + t + d + lq, lanes), want)


@pytest.fixture(scope="module")
def card_ivf():
    """A 20,000-doc IVF index built on the card and 64 of its queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from repro_torch.core.ivf import build_ivf
    from repro_torch.data.synthetic import make_corpus
    c = make_corpus(n_docs=20_000, n_queries=64, n_clusters=64,
                    with_bow=False, seed=5)
    return build_ivf(c.cls, ncells=256, iters=4, device="cuda"), \
        c.queries_cls


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [7, 32, 64])
def test_search_two_phase_is_independent_of_the_batch(card_ivf, batch):
    """Each query's candidates, approximate and final, are the same bits
    whether it is searched alone or inside a batch of 7, 32 or 64: the
    cell scan takes one product per query, whose shape does not depend on
    the batch (nprobe 128 = two probe chunks, k 1,000, as on the main
    path)."""
    from repro_torch.core.ivf import search_two_phase
    index, queries = card_ivf
    got = search_two_phase(index, queries[:batch], 128, 1000, 13)
    for b in range(batch):
        alone = search_two_phase(index, queries[b:b + 1], 128, 1000, 13)
        for phase in (0, 1):
            scores, ids = alone[phase]
            assert torch.equal(got[phase][0][b], scores[0])
            assert torch.equal(got[phase][1][b], ids[0])
        assert torch.equal(got[2][b], alone[2][0])


# -- live mutation on the card -------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["fp32", "fp16", "int8"])
def test_ivf_add_on_the_card_equals_the_cpu(card, quant):
    """``ivf_add`` on the card (one stable sort, one scatter) puts every new
    doc in the cell and slot the CPU and the sequential plain loop put it,
    with the same stored vectors and scales, the pad grown once."""
    from repro_torch.core.ivf import build_ivf, ivf_add, ivf_add_plain
    from repro_torch.data.synthetic import make_corpus
    c = make_corpus(n_docs=4_000, n_queries=1, n_clusters=32,
                    with_bow=False, seed=7)
    cpu = build_ivf(c.cls, ncells=64, iters=4, quant=quant, device="cpu")
    on_card, plain = cpu.to(card), cpu.to("cpu")
    w0 = cpu.max_cell
    rng = np.random.default_rng(8)
    start = c.n_docs
    crowd = cpu.centroids[5].numpy() + 0.02 * rng.standard_normal(
        (2 * w0, c.cls.shape[1]))
    for vecs in (crowd.astype(np.float32),
                 rng.standard_normal((500, c.cls.shape[1])).astype(
                     np.float32)):
        ids = np.arange(start, start + len(vecs))
        start += len(vecs)
        ivf_add(cpu, vecs, ids)
        ivf_add(on_card, vecs, ids)
        ivf_add_plain(plain, vecs, ids)
    assert on_card.max_cell > w0 and on_card.cell_ids.device.type == "cuda"
    for idx in (on_card, plain):
        assert torch.equal(idx.cell_ids.cpu(), cpu.cell_ids)
        assert torch.equal(idx.cell_vecs.cpu(), cpu.cell_vecs)
        if quant == "int8":
            assert torch.equal(idx.cell_scale.cpu(), cpu.cell_scale)
        np.testing.assert_array_equal(idx.cell_sizes, cpu.cell_sizes)


@pytest.mark.cuda
def test_fde_append_on_the_card_equals_a_rebuild(card):
    """The FDEs of docs ingested in batches of 1, 37 and 2,500, appended to
    a table built on the card, equal ``fde_from_layout`` of the grown
    layout on the card bit for bit (each doc's encoding is independent of
    the docs encoded with it)."""
    from repro_torch.core.fde import FDEConfig, FDEEncoder, fde_from_layout
    from repro_torch.data.synthetic import make_corpus
    from repro_torch.storage.layout import pack, unpack_doc
    from repro_torch.storage.segments import concat_layouts
    c = make_corpus(n_docs=6_000, n_queries=1, d_bow=32, seed=9)
    cfg = FDEConfig(d_bow=32)
    layout = pack(c.cls[:3_462], c.bow[:3_462])
    table = fde_from_layout(layout, cfg, device=card)
    enc = FDEEncoder(cfg, card)
    start = 3_462
    for n in (1, 37, 2_500):
        seg = pack(c.cls[start:start + n], c.bow[start:start + n])
        start += n
        layout = concat_layouts([layout, seg])
        table.append(enc.encode_docs([unpack_doc(seg, i)[1]
                                      for i in range(n)]))
    rebuilt = fde_from_layout(layout, cfg, device=card)
    assert table.vecs.device.type == "cuda"
    assert torch.equal(table.vecs, rebuilt.vecs)


@pytest.mark.cuda
def test_churned_pipeline_equals_its_rebuild_on_the_card(card):
    """An espn pipeline on the card through ingests, deletes and a
    compaction (2 shards x 2 replicas) ranks exactly like a stack rebuilt
    from scratch over the surviving docs: ids and scores bit for bit."""
    from repro_torch.core.ivf import build_ivf, ivf_add
    from repro_torch.data.synthetic import make_corpus
    from repro_torch.pipeline import (MutationConfig, Pipeline,
                                      PipelineConfig)
    from repro_torch.pipeline.pipeline import _pack_layout
    c = make_corpus(n_docs=3_000, n_queries=16, n_clusters=16, seed=11)
    cfg = PipelineConfig()
    cfg.index.ncells = 32
    cfg.retrieval.nprobe, cfg.retrieval.k_candidates = 16, 100
    cfg.mutation = MutationConfig(enabled=True)
    cfg.cluster.n_shards, cfg.cluster.replication = 2, 2
    rng = np.random.default_rng(12)
    batches = []
    with Pipeline.build(cfg, corpus=c, device=card) as pipe:
        for step in range(3):
            n = int(rng.integers(20, 60))
            cls = rng.standard_normal((n, c.cls.shape[1])).astype(np.float32)
            cls /= np.linalg.norm(cls, axis=1, keepdims=True)
            bows = [rng.standard_normal((int(rng.integers(3, 40)),
                                         c.bow[0].shape[1])).astype(
                                             np.float32) for _ in range(n)]
            batches.append((cls, bows))
            gids = pipe.ingest(cls, bows)
            dead = set(gids[rng.random(n) < 0.3].tolist()) | set(
                rng.choice(c.n_docs, 50, replace=False).tolist())
            pipe.delete(sorted(d for d in dead if pipe.tier.alive[d]))
            if step == 1:
                pipe.compact()
        q = (c.queries_cls, c.queries_bow, c.query_lens)
        got = pipe.search(*q)
        alive = pipe.tier.alive.copy()
    index = build_ivf(c.cls, ncells=32, iters=cfg.index.iters, device=card)
    start = c.n_docs
    for cls, _ in batches:
        ivf_add(index, cls, np.arange(start, start + len(cls)))
        start += len(cls)
    ocfg = PipelineConfig.from_dict(cfg.to_dict())
    ocfg.mutation, ocfg.cluster = MutationConfig(), type(cfg.cluster)()
    all_cls = np.concatenate([c.cls] + [b[0] for b in batches])
    all_bows = list(c.bow) + [bw for b in batches for bw in b[1]]
    with Pipeline.from_artifacts(ocfg, index=index,
                                 layout=_pack_layout(ocfg, all_cls, all_bows),
                                 device=card) as oracle:
        oracle.tier.alive = alive
        want = oracle.search(*q)
    for w, g in zip(want.ranked, got.ranked):
        assert np.array_equal(w.doc_ids, g.doc_ids)
        assert np.array_equal(w.scores, g.scores)
        assert alive[g.doc_ids].all()


@pytest.mark.cuda
def test_mutable_save_and_load_round_trip_on_the_card(card, tmp_path):
    """A mutable 2 x 2 cascade pipeline on the card, saved mid-churn (one
    shard compacted, the other holding its segment, tombstones in both),
    loads back onto the card with the same tombstones and segments; its
    cascade and espn answers and bills equal the unsaved pipeline's bit
    for bit, and an ingest and a delete on each give the same ids and the
    same answers after."""
    import os

    from repro_torch.data.synthetic import make_corpus
    from repro_torch.pipeline import (MutationConfig, Pipeline,
                                      PipelineConfig)
    c = make_corpus(n_docs=3_000, n_queries=16, n_clusters=16, seed=13)
    cfg = PipelineConfig()
    cfg.index.ncells = 32
    cfg.retrieval.mode = "cascade"
    cfg.retrieval.nprobe, cfg.retrieval.k_candidates = 16, 100
    cfg.mutation = MutationConfig(enabled=True)
    cfg.cluster.n_shards, cfg.cluster.replication = 2, 2
    rng = np.random.default_rng(14)

    def docs(n):
        cls = rng.standard_normal((n, c.cls.shape[1])).astype(np.float32)
        cls /= np.linalg.norm(cls, axis=1, keepdims=True)
        return cls, [rng.standard_normal((int(rng.integers(3, 40)),
                                          c.bow[0].shape[1])).astype(
                                              np.float32) for _ in range(n)]

    def same(a, b):
        assert a.breakdown.as_dict() == b.breakdown.as_dict()
        for w, g in zip(a.ranked, b.ranked):
            assert np.array_equal(w.doc_ids, g.doc_ids)
            assert np.array_equal(w.scores, g.scores)

    q = (c.queries_cls, c.queries_bow, c.query_lens)
    with Pipeline.build(cfg, corpus=c, device=card) as pipe:
        gids = np.concatenate([pipe.ingest(*docs(40)) for _ in (0, 1)])
        pipe.delete(np.concatenate([gids[::3], [0, 7, 11]]))
        pipe.compact(shard=0)
        assert [len(s) for s in pipe.tier.segments] == [0, 1]
        out = pipe.save(str(tmp_path / "art"))
        assert os.path.isdir(os.path.join(out, "mutation"))
        with Pipeline.load(out, device=card) as back:
            assert back.device.type == back.tier.fde.vecs.device.type \
                == torch.device(card).type
            np.testing.assert_array_equal(back.tier.alive, pipe.tier.alive)
            assert [len(s) for s in back.tier.segments] == [0, 1]
            same(pipe.search(*q), back.search(*q))
            with pipe.with_mode("espn") as a, back.with_mode("espn") as b:
                same(a.search(*q), b.search(*q))
            new = docs(5)
            more = pipe.ingest(*new)
            np.testing.assert_array_equal(back.ingest(*new), more)
            assert more[0] == gids[-1] + 1
            for p in (pipe, back):
                p.delete(more[:2])
            got = back.search(*q)
            same(pipe.search(*q), got)
            for r in got.ranked:
                assert back.tier.alive[r.doc_ids].all()


def assert_near_ties(want_ids, want_s, got_ids, got_s, tol=1e-5):
    """ids equal up to neighbours whose scores lie within ``tol`` trading
    places; scores within ``tol``."""
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=tol)
    for j in np.nonzero(want_ids != got_ids)[0]:
        assert any(0 <= n < len(want_ids) and want_ids[n] == got_ids[j]
                   and abs(want_s[n] - want_s[j]) <= tol
                   for n in (j - 1, j + 1)), j


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_disk_search_on_the_card_equals_the_cpu(card, quant):
    """The disk IVF over the same index: the image built from the card's
    copy is the CPU's byte for byte; ``search_disk`` (probes by the
    ``ivf_scan`` kernel, scores one product a query on the card) bills and
    counts exactly as on the CPU, cold and warm, with the CPU's ids up to
    near ties and its scores within 1e-5."""
    from repro_torch.core.disk_ivf import build_disk_ivf, search_disk
    from repro_torch.core.ivf import build_ivf
    from repro_torch.data.synthetic import make_corpus
    from repro_torch.kernels.ivf_scan.ops import centroid_scores
    c = make_corpus(n_docs=8_000, n_queries=24, n_clusters=32,
                    with_bow=False, seed=15)
    cpu_index = build_ivf(c.cls, ncells=64, iters=4, quant=quant,
                          device="cpu")
    on_cpu = build_disk_ivf(cpu_index, cache_cells=8)
    on_card = build_disk_ivf(cpu_index.to(card), cache_cells=8)
    assert on_card.centroids.device.type == torch.device(card).type
    assert on_card.blob.tobytes() == on_cpu.blob.tobytes()
    assert on_card.memory_bytes() == on_cpu.memory_bytes()
    before = centroid_scores.launches
    for _ in range(2):
        ws, wi, wio = search_disk(on_cpu, c.queries_cls, nprobe=16, k=200)
        gs, gi, gio = search_disk(on_card, c.queries_cls, nprobe=16, k=200)
        assert gio == wio and on_card.stats == on_cpu.stats
        for b in range(len(wi)):
            assert_near_ties(wi[b], ws[b], gi[b], gs[b])
    assert centroid_scores.launches == before + 2


@pytest.mark.cuda
def test_encoder_on_the_card_equals_the_cpu(card):
    """The ColBERTer encoder (2 layers at the published widths) from the
    same weights: fp32 on the card within 1e-4 of fp32 on the CPU, pads
    and all; bf16 on the card at cosine >= 0.99 a vector to fp32."""
    from repro_torch.configs import get_config
    from repro_torch.models import colberter
    cfg = get_config("colberter").scaled(n_layers=2, dtype=torch.float32)
    cpu = colberter.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = colberter.Colberter(cfg, card)
    on_card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(16)
    toks = rng.integers(1, cfg.vocab_size, (8, cfg.max_doc_len))
    toks[:, 0] = 0
    for row, n in enumerate(rng.integers(1, cfg.max_doc_len, 8)):
        toks[row, n:] = -1
    want = colberter.encode(cfg, cpu, toks)
    got = colberter.encode(cfg, on_card, toks)
    for w, g in zip(want[:2], got[:2]):
        assert g.device.type == torch.device(card).type
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                   atol=1e-4)
    assert torch.equal(got[2].cpu(), want[2])
    half = colberter.encode(cfg.scaled(dtype=torch.bfloat16), on_card, toks)
    mask = got[2]
    for f, h in ((got[0], half[0]), (got[1][mask], half[1][mask])):
        cos = torch.nn.functional.cosine_similarity(f.float(), h.float(),
                                                    dim=-1)
        assert float(cos.min()) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("e,k,shared", [(32, 8, 0), (16, 1, 1)])
def test_moe_ffn_on_the_card_equals_the_cpu(card, e, k, shared):
    """The MoE layer in fp32 (granite's 32 experts top-8, llama4's 16 top-1
    + a shared expert; d_model 1,024, 4 groups of 64 tokens, capacity
    factor 1.25: drops happen) on the card and on the CPU from the same
    weights: an expert choice may differ only at a near tie (the CPU's
    k-th and (k+1)-th probabilities within 1e-6); in every group whose
    routing agrees, keep masks equal and outputs within 1e-5 x max(1,
    |cpu|); aux within 1e-6; the card's output the same bits twice. TF32
    stays off (PyTorch's default)."""
    from repro_torch.configs import MoEConfig
    from repro_torch.models import moe
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = MoEConfig(n_experts=e, top_k=k, d_ff_expert=512,
                    n_shared_experts=shared)
    d = 1024
    r = np.random.default_rng(e + k)
    shapes = {"router": (d, e), "w_gate": (e, d, 512), "w_up": (e, d, 512),
              "w_down": (e, 512, d)}
    if shared:
        shapes |= {"w_gate_s": (d, 512), "w_up_s": (d, 512),
                   "w_down_s": (512, d)}
    params = {n: torch.from_numpy((r.standard_normal(sh) / np.sqrt(sh[-2]))
                                  .astype(np.float32))
              for n, sh in shapes.items()}
    x = torch.from_numpy(r.standard_normal((4, 64, d)).astype(np.float32))
    got = {}
    for dev in (torch.device("cpu"), card):
        p = {n: t.to(dev) for n, t in params.items()}
        xd = x.to(dev)
        y, aux = moe.moe_ffn(xd, p, cfg, torch.float32)
        probs = torch.softmax(xd @ p["router"], dim=-1)
        _, experts, _ = moe.route(xd, p["router"], cfg)
        _, keep = moe.dispatch(experts, e, moe.capacity(64, cfg))
        got[dev.type] = [t.cpu() for t in (y, aux, probs, experts, keep)]
        if dev.type == "cuda":
            again, _ = moe.moe_ffn(xd, p, cfg, torch.float32)
            assert torch.equal(y, again)
    (y0, a0, p0, e0, k0), (y1, a1, _, e1, k1) = got["cpu"], got[card.type]
    assert abs(float(a1) - float(a0)) <= 1e-6
    assert int((~k0).sum()) > 0
    differ = (e0.sort(-1).values != e1.sort(-1).values).any(-1)
    for g, t in differ.nonzero().tolist():
        pv = p0[g, t].sort(descending=True).values
        assert float(pv[k - 1] - pv[k]) <= 1e-6, (g, t)
    agreed = [g for g in range(4) if not differ[g].any()]
    assert agreed
    for g in agreed:
        assert torch.equal(k0[g], k1[g])
        err = float((y1[g] - y0[g]).abs().max())
        assert err <= 1e-5 * max(1.0, float(y0[g].abs().max()))


def _pairs(cfg, n, seed):
    """``n`` query/doc pairs of the published lengths, [CLS] first, docs
    with ragged pads."""
    rng = np.random.default_rng(seed)
    q = rng.integers(1, cfg.vocab_size, (n, cfg.max_query_len))
    d = rng.integers(1, cfg.vocab_size, (n, cfg.max_doc_len))
    q[:, 0] = d[:, 0] = 0
    for row, k in enumerate(rng.integers(8, cfg.max_doc_len, n)):
        d[row, k:] = -1
    return {"query_tokens": q.astype(np.int32),
            "pos_doc_tokens": d.astype(np.int32)}


@pytest.mark.cuda
def test_train_step_on_the_card_equals_the_cpu(card):
    """One AdamW step of the contrastive loss (2 layers at the published
    widths, fp32, 4 pairs) on the card and on the CPU from the same
    weights: loss and grad norm within 1e-5 x max(1, |cpu|); the updated
    weights within 1e-5, except where Adam's first step, lr_1 x g /
    (|g| + 1e-8), can tell the two apart: where the two gradients (the
    first moment m = 0.1 g) have opposite signs or |g| < 1e-7 (near
    Adam's eps); there within the sign-flip bound 2 x lr_1. (``layers/bk``'s
    exact gradient is 0: a key bias cancels in the softmax, so its
    weights are all such.)"""
    from repro_torch.configs import get_config
    from repro_torch.models import colberter
    from repro_torch.train.optimizer import AdamW, named_params
    from repro_torch.train.trainer import make_train_step
    cfg = get_config("colberter").scaled(n_layers=2, dtype=torch.float32)
    opt = AdamW(lr=1e-3, grad_clip=5.0, warmup_steps=30)
    step = make_train_step(lambda p, b: colberter.contrastive_loss(cfg, p, b),
                           opt)
    batch = _pairs(cfg, 4, 17)
    out = {}
    for dev in (torch.device("cpu"), card):
        model = colberter.init_params(cfg, torch.Generator().manual_seed(0),
                                      dev)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        model, state, m = step(model, opt.init(model), b)
        out[dev.type] = (m, {k: p.detach().cpu()
                             for k, p in named_params(model).items()},
                         {k: t.cpu() for k, t in state["m"].items()})
    (m_cpu, w_cpu, g_cpu), (m_card, w_card, g_card) = (out["cpu"],
                                                       out[card.type])
    for k in ("loss", "gnorm"):
        assert abs(float(m_card[k]) - float(m_cpu[k])) <= 1e-5 * max(
            1.0, abs(float(m_cpu[k]))), k
    lr_1 = opt.lr * 2 / 30
    for name, w in w_cpu.items():
        dw = (w_card[name] - w).abs()
        loose = (torch.sign(g_card[name]) != torch.sign(g_cpu[name])) | (
            g_cpu[name].abs() < 1e-8)
        assert float(dw.max()) <= 2 * lr_1 + 1e-6, name
        assert not ((dw > 1e-5) & ~loose).any(), name


@pytest.mark.cuda
def test_checkpoint_saved_on_the_card_restores_on_the_cpu(card, tmp_path):
    """Two steps on the card with a checkpoint after the second; a Trainer
    on the CPU resumes from it with the card's weights and optimizer state
    bit for bit, and its next step's loss is the card's within 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.models import colberter
    from repro_torch.train.optimizer import AdamW, named_params
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("colberter").scaled(n_layers=2, dtype=torch.float32)

    def trainer(dev, total):
        model = colberter.init_params(cfg, torch.Generator().manual_seed(1),
                                      dev)
        return Trainer(
            TrainerConfig(total_steps=total, ckpt_every=2,
                          ckpt_dir=str(tmp_path)),
            lambda p, b: colberter.contrastive_loss(cfg, p, b),
            AdamW(lr=1e-3, warmup_steps=2),
            lambda i: {k: torch.as_tensor(v, device=dev)
                       for k, v in _pairs(cfg, 4, i).items()}, model)

    on_card = trainer(card, 3)
    hist = on_card.run(verbose=False)
    assert on_card.ckpt.all_steps() == [2]
    cpu = trainer(torch.device("cpu"), 3)
    # the card's state before its third step: the checkpoint's
    _, saved = on_card.ckpt.restore(2, device=card)
    assert cpu.maybe_resume() == 2
    for name, p in named_params(cpu.params).items():
        assert p.device.type == "cpu"
        assert torch.equal(p.detach(), _leaf(saved["params"], name).cpu())
    for k in ("m", "v"):
        for name, t in cpu.opt_state[k].items():
            assert torch.equal(t, _leaf(saved["opt_state"][k], name).cpu())
    assert int(cpu.opt_state["step"]) == 2
    h = cpu.run(verbose=False)
    assert [m["step"] for m in h] == [2]
    assert abs(h[0]["loss"] - hist[2]["loss"]) <= 1e-5 * max(
        1.0, abs(hist[2]["loss"]))


def _leaf(tree, name):
    for part in name.split("/"):
        tree = tree[part]
    return tree


# -- RecSys, embeddings and GatedGCN (plain PyTorch: no kernel) ----------------

RECSYS_ARCHS = ["fm", "dlrm-mlperf", "autoint", "two-tower-retrieval"]


def _recsys_case(arch, b=64, seed=0):
    """``arch``'s smoke config in fp32, its weights (drawn on the CPU) and
    a numpy batch with labels."""
    from repro_torch.configs import get_config
    from repro_torch.models import recsys
    cfg = recsys.smoke_config(get_config(arch)).scaled(dtype=torch.float32)
    params = recsys.init_params(cfg, torch.Generator().manual_seed(seed),
                                "cpu")
    r = np.random.default_rng(seed + 1)
    if cfg.variant == "two-tower":
        nq = cfg.n_query_fields
        batch = {"query_ids": r.integers(0, cfg.table_sizes[:nq], (b, nq)),
                 "item_ids": r.integers(0, cfg.table_sizes[nq:],
                                        (b, cfg.n_item_fields))}
    else:
        batch = {"sparse_ids": r.integers(0, cfg.table_sizes,
                                          (b, cfg.n_sparse)),
                 "labels": r.integers(0, 2, b).astype(np.float32)}
        if cfg.n_dense:
            batch["dense"] = r.standard_normal((b, cfg.n_dense)).astype(
                np.float32)
    return cfg, params, batch


def _on(tree, dev):
    """A nested dict of tensors (or numpy arrays) copied to ``dev``, each
    leaf requiring grad if it is floating."""
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    t = torch.as_tensor(tree).detach().to(dev, copy=True)
    return t.requires_grad_(True) if t.is_floating_point() else t


def _loss_and_grads(loss_fn, params, batch, dev):
    from repro_torch.train.optimizer import named_params
    p = _on(params, dev)
    named = named_params(p)
    loss, _ = loss_fn(p, {k: _on(v, dev).detach() for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach().cpu(), {k: g.cpu() for k, g in zip(named, grads)}


def _assert_rel(got, want, tol, what=""):
    assert got.shape == want.shape and bool(torch.isfinite(got).all()), what
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol * scale, what


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_on_the_card_equals_the_cpu(card, arch):
    """fp32 smoke config: the forward within 1e-5 x max(1, |cpu|), the
    loss and every gradient within 1e-5; on the card the same bits twice."""
    from repro_torch.models import recsys
    cfg, params, batch = _recsys_case(arch)
    serve = {k: v for k, v in batch.items() if k != "labels"}
    fwd = {}
    for dev in (torch.device("cpu"), card):
        with torch.no_grad():
            fwd[dev.type] = [recsys.forward(cfg, _on(params, dev),
                                            _on(serve, dev)).cpu()
                             for _ in range(2)]
    assert torch.equal(*fwd[card.type])
    _assert_rel(fwd[card.type][0], fwd["cpu"][0], 1e-5)

    def loss_fn(p, b):
        return recsys.loss_fn(cfg, p, b)

    cpu_loss, cpu_g = _loss_and_grads(loss_fn, params, batch, "cpu")
    runs = [_loss_and_grads(loss_fn, params, batch, card) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    _assert_rel(runs[0][0], cpu_loss, 1e-5)
    for name, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][name]), name
        _assert_rel(g, cpu_g[name], 1e-5, name)


@pytest.mark.cuda
def test_retrieval_topk_on_the_card_equals_the_cpu(card):
    """1 query against 4,096 candidates, top 100: the ids equal the CPU's
    up to neighbours whose CPU scores lie within 1e-6."""
    from repro_torch.models import recsys
    cfg, params, batch = _recsys_case("two-tower-retrieval", b=1)
    r = np.random.default_rng(9)
    batch = {"query_ids": batch["query_ids"],
             "candidate_ids": r.integers(0, cfg.table_sizes[4:], (4096, 4))}
    out = {}
    for dev in (torch.device("cpu"), card):
        with torch.no_grad():
            v, i = recsys.retrieval_topk(cfg, _on(params, dev),
                                         _on(batch, dev), k=100)
        out[dev.type] = (v.cpu(), i.cpu())
    (cv, ci), (gv, gi) = out["cpu"], out[card.type]
    _assert_rel(gv, cv, 1e-5)
    for pos in (ci != gi).nonzero()[:, 1].tolist():
        assert abs(float(cv[0, pos]) - float(gv[0, pos])) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_on_the_card(card, combiner):
    """Ragged bags (empty ones and repeated ids included) over a 70,000-row
    table: the card within 1e-6 x max(1, |cpu|) of the CPU, the plain
    oracle's values; the output and the table's gradient the same bits
    twice."""
    from repro_torch.models import embedding as emb
    r = np.random.default_rng(2)
    table = torch.from_numpy(r.standard_normal((70_000, 64)).astype(
        np.float32))
    counts = r.integers(0, 40, 1024)
    counts[::97] = 0
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]))
    ids = torch.from_numpy(r.integers(0, 300, int(offsets[-1])))
    w = torch.from_numpy(r.standard_normal((1024, 64)).astype(np.float32))
    got = []
    for dev in (torch.device("cpu"), card, card):
        t = table.to(dev, copy=True).requires_grad_(True)
        out = emb.embedding_bag(t, ids.to(dev), offsets.to(dev),
                                combiner=combiner,
                                compute_dtype=torch.float32)
        (g,) = torch.autograd.grad((out * w.to(dev)).sum(), [t])
        got.append((out.detach().cpu(), g.cpu()))
    (out_cpu, g_cpu), a, b = got
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    _assert_rel(a[0], out_cpu, 1e-6)
    _assert_rel(a[1], g_cpu, 1e-6)
    want = emb.embedding_bag_ref(table.numpy(), ids.numpy(), offsets.numpy(),
                                 combiner=combiner)
    _assert_rel(a[0], torch.from_numpy(want), 1e-5)


def _gnn_case(pads=0, seed=0, n=300, e=1500):
    from repro_torch.configs import get_config
    from repro_torch.models import gnn
    cfg = gnn.smoke_config(get_config("gatedgcn")).scaled(dtype=torch.float32)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(seed), 24,
                             "cpu")
    r = np.random.default_rng(seed + 1)
    batch = {"node_feats": r.standard_normal((n, 24)).astype(np.float32),
             "edge_src": np.concatenate([r.integers(0, n, e),
                                         np.zeros(pads, int)]),
             "edge_dst": np.concatenate([r.integers(0, n, e),
                                         np.full(pads, n)]),
             "labels": r.integers(0, cfg.n_classes, n)}
    return cfg, params, batch


@pytest.mark.cuda
def test_gnn_on_the_card_equals_the_cpu(card):
    """fp32 smoke config, 300 nodes, 1,500 edges: the logits, the loss and
    every gradient within 1e-5 x max(1, |cpu|) of the CPU's."""
    from repro_torch.models import gnn
    cfg, params, batch = _gnn_case()

    def loss_fn(p, b):
        return gnn.loss_fn(cfg, p, b)

    logits = {}
    for dev in (torch.device("cpu"), card):
        with torch.no_grad():
            b = _on(batch, dev)
            logits[dev.type] = gnn.forward(
                cfg, _on(params, dev), b["node_feats"], b["edge_src"],
                b["edge_dst"]).cpu()
    _assert_rel(logits[card.type], logits["cpu"], 1e-5)
    cpu_loss, cpu_g = _loss_and_grads(loss_fn, params, batch, "cpu")
    loss, grads = _loss_and_grads(loss_fn, params, batch, card)
    _assert_rel(loss, cpu_loss, 1e-5)
    for name, g in grads.items():
        _assert_rel(g, cpu_g[name], 1e-5, name)


@pytest.mark.cuda
def test_gnn_padded_edges_on_the_card(card):
    """512 pad edges (dst = n_nodes) on the card: no device-side assert;
    the loss and every gradient finite and within 1e-5 of the unpadded
    batch's on the card."""
    from repro_torch.models import gnn
    cfg, params, padded = _gnn_case(pads=512)
    _, _, plain = _gnn_case()

    def loss_fn(p, b):
        return gnn.loss_fn(cfg, p, b)

    lp, gp = _loss_and_grads(loss_fn, params, padded, card)
    lu, gu = _loss_and_grads(loss_fn, params, plain, card)
    torch.cuda.synchronize()
    _assert_rel(lp, lu, 1e-5)
    for name, g in gp.items():
        _assert_rel(g, gu[name], 1e-5, name)


@pytest.mark.cuda
def test_gnn_step_gives_the_same_bits_twice_on_the_card(card):
    """One AdamW step of the padded batch, twice from the same weights: the
    loss, grad norm and every updated weight bit for bit."""
    from repro_torch.models import gnn
    from repro_torch.train.optimizer import AdamW, named_params
    from repro_torch.train.trainer import make_train_step
    cfg, params, batch = _gnn_case(pads=100)
    opt = AdamW(lr=1e-3, warmup_steps=2)
    step = make_train_step(lambda p, b: gnn.loss_fn(cfg, p, b), opt)
    runs = []
    for _ in range(2):
        p = _on(params, card)
        p, _, m = step(p, opt.init(p), {k: _on(v, card).detach()
                                         for k, v in batch.items()})
        runs.append((m, {k: t.detach().cpu()
                         for k, t in named_params(p).items()}))
    (m0, w0), (m1, w1) = runs
    assert float(m0["loss"]) == float(m1["loss"])
    assert float(m0["gnorm"]) == float(m1["gnorm"])
    for name, w in w0.items():
        assert torch.equal(w, w1[name]), name
