"""Serving launcher: builds the ported ESPN stack through the
``repro_torch.pipeline`` facade on the card (``--device cpu`` to run on the
CPU) and replays the corpus's query set through the continuous batcher.
The retrieval mode (and with it the storage-tier software stack) comes from
the backend registry.

    PYTHONPATH=src python -m repro_torch.launch.serve --docs 50000 --queries 128
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core.metrics import mrr_at_k, recall_at_k
from repro_torch.pipeline import Pipeline, PipelineConfig

WAIT_S = 60.0      # per-request wait: a request not done by then fails


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    PipelineConfig.add_cli_args(ap)
    ap.add_argument("--device", default="cuda",
                    help="device for the index and kernels (cuda or cpu)")
    ap.set_defaults(clusters=0)        # 0 = derive from the cell count below
    args = ap.parse_args(argv)
    cfg = PipelineConfig.from_cli(args)
    if not cfg.corpus.n_clusters:
        cfg.corpus.n_clusters = max(64, cfg.index.resolve_ncells(
            cfg.corpus.n_docs) // 2)

    print(f"building corpus ({cfg.corpus.n_docs} docs) ...", flush=True)
    with Pipeline.build(cfg, device=args.device) as pipe:
        server = pipe.serve()
        try:
            c = pipe.corpus
            print(f"serving ({cfg.retrieval.mode} backend on "
                  f"{pipe.backend.storage_stack} tier, {pipe.device}) ...",
                  flush=True)
            t0 = time.time()
            reqs = [server.query_async(c.queries_cls[i], c.queries_bow[i],
                                       int(c.query_lens[i]))
                    for i in range(cfg.corpus.n_queries)]
            ranked, qrels = [], []
            for i, r in enumerate(reqs):
                if not r.done.wait(WAIT_S):
                    raise TimeoutError(f"request {r.rid} not served in "
                                       f"{WAIT_S:.0f} s")
                if r.error is not None:
                    raise r.error
                if r.shed:             # admission control (--slo-ms): the
                    continue           # request has no result by design
                ranked.append(r.result.doc_ids)
                qrels.append(c.qrels[i])
            wall = time.time() - t0
            print(f"wall={wall:.2f}s  stats={server.stats.summary()}")
            if ranked:
                print(f"MRR@10={mrr_at_k(ranked, qrels, 10):.4f}  "
                      f"R@100={recall_at_k(ranked, qrels, 100):.4f}")
            if args.metrics_out:
                with open(args.metrics_out, "w") as f:
                    f.write(server.metrics_text())
        finally:
            server.shutdown()


if __name__ == "__main__":
    main()
