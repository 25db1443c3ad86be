"""Quickstart on the PyTorch/CUDA port: the ``repro_torch.pipeline`` facade
builds the whole ESPN stack — synthetic corpus, IVF candidate-generation
index, SSD-offloaded BOW layout, and the prefetching retrieval backend —
from one config, and runs retrieval end to end. The counterpart of
``examples/quickstart.py``; everything runs on the card unless ``--device
cpu`` is given.

    PYTHONPATH=src python examples/quickstart_torch.py              # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Retrieval modes are pluggable backends; swap ``mode="espn"`` for any name in
``repro_torch.pipeline.available_backends()``.
"""
import argparse

from repro_torch.core.quantize import memory_report
from repro_torch.pipeline import (CorpusConfig, Pipeline, PipelineConfig,
                                  RetrievalConfig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=10_000)
    ap.add_argument("--queries", type=int, default=32)
    args = ap.parse_args(argv)
    cfg = PipelineConfig(
        corpus=CorpusConfig(n_docs=args.docs, n_queries=args.queries,
                            n_clusters=128),
        retrieval=RetrievalConfig(mode="espn", nprobe=24, k_candidates=500,
                                  prefetch_step=0.3))
    cfg.index.ncells = 64

    # one facade call: corpus -> IVF -> packed layout -> storage tier -> backend
    print("== 1. build (corpus + IVF index + SSD layout + espn backend)")
    pipe = Pipeline.build(cfg, device=args.device)
    print(f"   {pipe.corpus.n_docs} docs, "
          f"mean {pipe.corpus.mean_tokens:.0f} tokens/doc, on {pipe.device}")
    print(f"   {pipe.index.ncells} cells, "
          f"{pipe.index.memory_bytes()/2**20:.1f} MB in memory")
    rep = memory_report(pipe.corpus.n_docs, pipe.corpus.mean_tokens)
    print(f"   blob {pipe.layout.nbytes/2**20:.1f} MB on SSD; "
          f"memory factor at msmarco-scale: {rep.factor:.1f}x")

    # retrieve: two-phase ANN + prefetch + early re-rank
    print("== 2. ESPN retrieval")
    resp = pipe.search()
    ev = pipe.evaluate(response=resp)
    print(f"   breakdown (ms): {resp.breakdown.ms()}")
    print(f"   MRR@10={ev['mrr@10']:.3f} Recall@100={ev['recall@100']:.3f}")

    # bit-vector filter: score candidates against a resident sign-bit table,
    # then read only the top-R survivors from the SSD (Nardini et al. 2024)
    print("== 3. bitvec retrieval (packed-bit filter, R=64)")
    bv = pipe.with_mode("bitvec", bit_filter=64)
    resp_bv = bv.search()
    ev_bv = bv.evaluate(response=resp_bv)
    n_q = len(resp_bv.ranked)
    print(f"   bit table resident: {bv.tier.bits.nbytes/2**20:.1f} MB "
          f"(blob: {pipe.layout.nbytes/2**20:.1f} MB)")
    print(f"   BOW bytes/query: {resp_bv.breakdown.bytes_read/n_q/1024:.0f}KB "
          f"vs espn {resp.breakdown.bytes_read/n_q/1024:.0f}KB")
    print(f"   MRR@10={ev_bv['mrr@10']:.3f} "
          f"(espn: {ev['mrr@10']:.3f})")
    bv.close()

    # FDE candidate generation: candidates come from single-vector ANN over
    # resident MUVERA-style fixed dimensional encodings — the CLS IVF index
    # is never probed (Dhulipala et al. 2024)
    print("== 4. fde retrieval (resident FDE candidate generation)")
    fd = pipe.with_mode("fde")
    resp_fd = fd.search()
    ev_fd = fd.evaluate(response=resp_fd)
    print(f"   FDE table resident: {fd.tier.fde.nbytes/2**20:.1f} MB "
          f"(CLS index: {pipe.index.memory_bytes()/2**20:.1f} MB)")
    print(f"   Recall@100={ev_fd['recall@100']:.3f} "
          f"MRR@10={ev_fd['mrr@10']:.3f} "
          f"(espn: {ev['recall@100']:.3f} / {ev['mrr@10']:.3f})")
    fd.close()
    pipe.close()


if __name__ == "__main__":
    main()
