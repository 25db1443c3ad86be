"""End-to-end serving driver on the PyTorch/CUDA port (``repro_torch``), the
counterpart of ``examples/espn_serving.py``: a ColBERTer-style encoder
encodes incoming queries on the fly, the retrieval server batches
concurrent requests, the ESPN pipeline serves embeddings from the storage
tier with prefetching, and mmap / GDS / ESPN latency are compared like the
paper's Tables 4/5.

The stack is built once through ``repro_torch.pipeline``; each compared mode
is a registered backend swapped in with ``Pipeline.with_mode``. Everything
runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/espn_serving_torch.py               # card
    PYTHONPATH=src python examples/espn_serving_torch.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.metrics import mrr_at_k
from repro_torch.models import colberter as C
from repro_torch.pipeline import (CorpusConfig, Pipeline, PipelineConfig,
                                  RetrievalConfig, ServeConfig, StorageConfig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=8_000)
    ap.add_argument("--queries", type=int, default=64)
    args = ap.parse_args(argv)
    cfg = PipelineConfig(
        corpus=CorpusConfig(n_docs=args.docs, n_queries=args.queries,
                            n_clusters=128),
        storage=StorageConfig(t_max=64, mem_budget_frac=0.125),
        retrieval=RetrievalConfig(mode="mmap", nprobe=16, k_candidates=200,
                                  prefetch_step=0.3, rerank_count=64),
        serve=ServeConfig(max_batch=12, max_wait_s=0.003))
    cfg.index.ncells = 64
    base = Pipeline.build(cfg, device=args.device)
    corpus = base.corpus

    # a real (smoke-scale) encoder in the loop: queries arrive as token ids
    ccfg = C.smoke_config(get_config("colberter")).scaled(
        d_cls=corpus.queries_cls.shape[-1],
        d_bow=corpus.queries_bow.shape[-1])
    params = C.init_params(ccfg, torch.Generator(base.device).manual_seed(0),
                           base.device)
    C.encode(ccfg, params, np.zeros((4, 8), np.int32))     # warm up
    n_params = sum(p.numel() for p in params.parameters())
    print(f"encoder: {n_params / 1e6:.1f}M params (smoke scale) on "
          f"{base.device}")

    for mode in ("mmap", "gds", "espn"):
        pipe = base if mode == base.cfg.retrieval.mode else \
            base.with_mode(mode)
        srv = pipe.serve()
        t0 = time.time()
        reqs = []
        for i in range(args.queries):
            # encode the "text" (synthetic ids) then submit to the server
            toks = np.random.default_rng(i).integers(
                0, ccfg.vocab_size, (1, 8)).astype(np.int32)
            C.encode(ccfg, params, toks)             # encoder in the loop
            reqs.append(srv.query_async(corpus.queries_cls[i],
                                        corpus.queries_bow[i],
                                        int(corpus.query_lens[i])))
        ranked = []
        for r in reqs:
            r.done.wait(60)
            ranked.append(r.result.doc_ids)
        wall = time.time() - t0
        s = srv.stats.summary()
        print(f"{mode:5s}: wall={wall:5.2f}s sim_mean={s['mean_ms']:7.2f}ms "
              f"p99={s['p99_ms']:7.2f}ms batch~{s['mean_batch']:.1f} "
              f"MRR@10={mrr_at_k(ranked, corpus.qrels, 10):.3f}")
        srv.shutdown()
        pipe.close()


if __name__ == "__main__":
    main()
