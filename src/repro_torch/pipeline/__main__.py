"""CLI entry for the ported pipeline:

    PYTHONPATH=src python -m repro_torch.pipeline --docs 2000 --queries 8 --mode espn

Builds the full stack from flags on the card (``--device cpu`` to run on
the CPU), runs the bundled query set, and prints the latency breakdown and
quality metrics. ``--trace-json PATH`` exports the run's spans,
``--metrics-out PATH`` the tier's counters and ``--save DIR`` the index,
layout, tables and corpus (``Pipeline.load(DIR)`` reloads them).
"""
from __future__ import annotations

import argparse

from repro_torch.pipeline import Pipeline, PipelineConfig


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        prog="repro_torch.pipeline",
        description="Build an ESPN retrieval stack and run its query set.")
    PipelineConfig.add_cli_args(ap)
    ap.add_argument("--device", default="cuda",
                    help="device for the index and kernels (cuda or cpu)")
    ap.add_argument("--save", default="",
                    help="directory to persist index+layout+corpus")
    args = ap.parse_args(argv)
    cfg = PipelineConfig.from_cli(args)

    with Pipeline.build(cfg, device=args.device) as pipe:
        print(f"corpus: {pipe.corpus.n_docs} docs, "
              f"mean {pipe.corpus.mean_tokens:.0f} tokens/doc")
        print(f"index: {pipe.index.ncells} cells, "
              f"{pipe.index.memory_bytes()/2**20:.1f} MB on {pipe.device}; "
              f"blob {pipe.layout.nbytes/2**20:.1f} MB on "
              f"{pipe.backend.storage_stack}")
        if pipe.tier.bits is not None:
            print(f"bit table: {pipe.tier.bits.nbytes/2**20:.1f} MB resident")
        if pipe.tier.fde is not None:
            print(f"fde table: {pipe.tier.fde.nbytes/2**20:.1f} MB on "
                  f"{pipe.tier.fde.vecs.device}")
        ev = pipe.evaluate()
        print(f"mode={cfg.retrieval.mode} breakdown (ms): "
              f"{ev['breakdown_ms']}")
        print(f"MRR@10={ev['mrr@10']:.3f} Recall@100={ev['recall@100']:.3f}")
        if args.trace_json:
            n = pipe.export_trace(args.trace_json)
            print(f"trace: {n} events -> {args.trace_json}")
        if args.metrics_out:
            text = pipe.metrics_text()
            with open(args.metrics_out, "w") as f:
                f.write(text)
            print(f"metrics: {len(text.splitlines())} lines -> "
                  f"{args.metrics_out}")
        if args.save:
            print(f"saved -> {pipe.save(args.save)}")


if __name__ == "__main__":
    main()
