"""Shared harness of the port's end-to-end parity tests: both packages run
around the SAME artifacts. The reference builds the index, the layout and
(for the modes that need them) the resident bit and FDE tables;
``repro_torch.convert`` carries them across, and each package's
``Pipeline.from_artifacts`` serves the same queries.

Scores are fp32 sums taken in another order by XLA and by PyTorch, so two
candidates whose aggregate scores lie within ``SCORE_TOL`` of each other may
come out in either order; such an adjacent swap is the one difference
allowed in the ranked ids.
"""
import functools

import numpy as np

from repro.core.ivf import build_ivf as ref_build_ivf
from repro.data.synthetic import make_corpus as ref_make_corpus
from repro.pipeline import Pipeline as RefPipeline
from repro.pipeline import PipelineConfig as RefConfig
from repro.storage.layout import pack as ref_pack
from repro_torch import convert
from repro_torch.pipeline import Pipeline, PipelineConfig

SCORE_TOL = 1e-5


@functools.lru_cache(maxsize=1)
def artifacts():
    c = ref_make_corpus(n_docs=1200, n_queries=12, n_clusters=16,
                        mean_len=20, max_len=48, seed=3)
    index = ref_build_ivf(c.cls, ncells=24, iters=4)
    layout = ref_pack(c.cls, c.bow, dtype=np.float16)
    return c, index, layout


def index_arrays(index):
    return dict(centroids=np.asarray(index.centroids),
                cell_ids=np.asarray(index.cell_ids),
                cell_vecs=np.asarray(index.cell_vecs),
                cell_scale=(np.asarray(index.cell_scale)
                            if index.cell_scale is not None else None),
                cell_sizes=index.cell_sizes, n_docs=index.n_docs,
                quant=index.quant)


def layout_arrays(layout):
    """The fields of the reference's ``layout.npz`` (a fixed_stride
    layout's offsets and token counts ride along; the port recomputes
    them)."""
    return dict(blob=layout.blob, offsets=layout.offsets,
                n_tokens=layout.n_tokens, d_cls=layout.d_cls,
                d_bow=layout.d_bow, dtype=str(layout.dtype),
                scales=layout.scales, block=layout.block, mode=layout.mode,
                stride_blocks=layout.stride_blocks, pool_k=layout.pool_k)


def bits_arrays(bits):
    """The fields of the reference's ``bits.npz``."""
    return dict(packed=bits.packed, starts=bits.starts, d_bow=bits.d_bow)


def fde_arrays(fde):
    """The fields of the reference's ``fde.npz``."""
    c = fde.cfg
    return dict(vecs=fde.vecs, d_bow=c.d_bow, k_sim=c.k_sim,
                r_reps=c.r_reps, d_final=c.d_final,
                fill_empty=int(c.fill_empty), seed=c.seed)


def configs(mode, **retrieval):
    """Reference and port configs with the same knobs. The filters are cut
    below the 60 candidates so the bit filter drops some of them."""
    kw = dict(mode=mode, nprobe=10, k_candidates=60, prefetch_step=0.3,
              bit_filter=24, cascade_filter=16)
    kw.update(retrieval)
    ref, port = RefConfig(), PipelineConfig()
    for cfg in (ref, port):
        cfg.storage.t_max = 48
        for k, v in kw.items():
            setattr(cfg.retrieval, k, v)
    return ref, port


def assert_same_ranking(ref_out, port_out):
    """ids equal up to adjacent swaps of scores within SCORE_TOL; scores
    within SCORE_TOL position by position."""
    a, b = np.asarray(ref_out.doc_ids), np.asarray(port_out.doc_ids)
    sa, sb = np.asarray(ref_out.scores), np.asarray(port_out.scores)
    assert a.shape == b.shape
    np.testing.assert_allclose(sb, sa, rtol=0, atol=SCORE_TOL)
    for j in np.nonzero(a != b)[0]:
        # the only allowed difference: a near-tie swapped with a neighbour
        near = [n for n in (j - 1, j + 1) if 0 <= n < len(a)
                and a[n] == b[j] and abs(sa[n] - sa[j]) <= SCORE_TOL]
        assert near, f"rank {j}: ref id {a[j]} vs port id {b[j]}"


def port_tables(ref_pipe):
    """The reference pipeline's resident side tables, carried across."""
    out = {}
    if ref_pipe.tier.bits is not None:
        out["bits"] = convert.bit_table_from_numpy(
            bits_arrays(ref_pipe.tier.bits))
    if ref_pipe.tier.fde is not None:
        out["fde"] = convert.fde_table_from_numpy(
            fde_arrays(ref_pipe.tier.fde), "cpu")
    return out


def run_both(mode, io_coalesce=True, bit_dtype="uint32", **retrieval):
    """Both packages' responses and storage-tier counters for one batch.
    The reference's IVF over the FDEs (``fde_brute_threshold`` below the
    corpus size) is carried across too: k-means sums run in another order
    in the port, so its own index is held by assignment agreement apart."""
    c, index, layout = artifacts()
    ref_cfg, port_cfg = configs(mode, **retrieval)
    ref_cfg.storage.io_coalesce = port_cfg.storage.io_coalesce = io_coalesce
    ref_cfg.storage.bit_dtype = port_cfg.storage.bit_dtype = bit_dtype
    q = (c.queries_cls, c.queries_bow, c.query_lens)
    with RefPipeline.from_artifacts(ref_cfg, index=index,
                                    layout=layout) as ref:
        r = ref.search(*q)
        r_stats = dict(ref.tier.stats)
        tables = port_tables(ref)
        fde_index = getattr(ref.backend, "fde_index", None)
        with Pipeline.from_artifacts(
                port_cfg, index=convert.ivf_index_from_numpy(
                    index_arrays(index), "cpu"),
                layout=convert.layout_from_numpy(layout_arrays(layout)),
                device="cpu", **tables) as port:
            if fde_index is not None:
                port.backend.fde_index = convert.ivf_index_from_numpy(
                    index_arrays(fde_index), "cpu")
            p = port.search(*q)
            p_stats = dict(port.tier.stats)
    return r, p, r_stats, p_stats


def assert_same_response(r, p, r_stats, p_stats):
    assert len(r.ranked) == len(p.ranked)
    for ro, po in zip(r.ranked, p.ranked):
        assert ro.n_reranked == po.n_reranked
        assert ro.bow_bytes_read == po.bow_bytes_read
        assert_same_ranking(ro, po)
    assert p.breakdown.as_dict() == r.breakdown.as_dict()
    assert p_stats == r_stats
