"""Readings that the limits of ``correct`` and the serve mix's rate were set
from, taken on the card:

    python3 espnbench/calibrate.py --workload espn-1m.batch64 \\
        --seeds 11 12 13 --seconds 5 --control --out readings/c.jsonl
    python3 espnbench/calibrate.py --index --seeds 1 2 3 \\
        --out readings/index.jsonl
    python3 espnbench/calibrate.py --workload espn-1m.serve-zipf --serve \\
        --seeds 21 --traffic-over '{"rate_qps": 40}' --seconds 20 \\
        --out readings/sweep.jsonl

Each seed is one ``harness.run_cell`` of the cell, as ``run.py`` makes it,
with the configuration's and traffic's entries changed by
``--config-over`` and ``--traffic-over`` (JSON, merged into the files'
entries; ``{"corpus": {"seed": 5}}`` draws another corpus). It records the
compared numbers and the end-to-end metrics. ``--control`` judges the
control's answers (the reference in TF32 in the program's place) instead of
the program's. ``--serve`` adds the open-loop serve cell, which
``BENCHMARK.json`` leaves out (PERF.md), with its ``p95_ms``.

``--index`` reads the index stage alone on the corpus drawn from each seed:
the program's IVF index, built by ``build_ivf`` as
``Pipeline.from_embeddings`` builds it, and the control's, each held to the
reference's by ``cell_mismatch``.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from espnbench import gen, harness, reference  # noqa: E402

#: the open-loop serve cell and its metrics, kept out of BENCHMARK.json
SERVE_CELL = {"name": "espn-1m.serve-zipf", "config": "espn-colberter-1m",
              "traffic": "serve-zipf-poisson", "chips": 1,
              "why": "independent users under Zipf skew, open loop"}
SERVE_E2E = [{"name": "p95_ms", "unit": "ms", "better": "lower",
              "bound": 0.25, "source": "host_clock",
              "workloads": [SERVE_CELL["name"]]}]
SERVE_LAYER = [
    {"name": n, "unit": u, "better": b, "source": src, "layer": lay,
     "moves": "p95_ms", "workloads": [SERVE_CELL["name"]]}
    for n, u, b, src, lay in (
        ("mean_batch.serve", "queries", "higher", "program_counter",
         "serve"),
        ("dedup_share.serve", "%", "higher", "program_counter", "storage"),
        ("device_idle.serve", "%", "lower", "device_trace", "device"))]


def with_serve_cell(bench: dict) -> dict:
    """``bench`` with the serve cell and its metrics added."""
    return dict(bench, workloads=bench["workloads"] + [SERVE_CELL],
                end_to_end=bench["end_to_end"] + SERVE_E2E,
                per_layer=bench["per_layer"] + SERVE_LAYER)


def index_readings(config: dict, seed: int, device) -> dict:
    """``cell_mismatch`` of the program's index and of the control's, on
    the corpus drawn from ``seed``."""
    from repro_torch.core.ivf import build_ivf
    from repro_torch.pipeline import PipelineConfig
    spec = dict(config["corpus"], seed=seed)
    _, _, cls = gen.make_cls(spec, gen.generator(seed, device), device)
    ix = PipelineConfig.from_dict(config["pipeline"]).index
    n = cls.shape[0]
    t0 = time.perf_counter()
    built = build_ivf(cls.cpu().numpy(), ncells=ix.resolve_ncells(n),
                      iters=ix.iters, quant=ix.quant,
                      train_sample=ix.train_sample, device=device)
    program = reference.IndexState(
        built.centroids, built.cell_ids.cpu().numpy().astype(np.int64))
    t1 = time.perf_counter()
    rule = reference.IndexRule.of(config)
    ref = reference.kmeans_index(cls, rule)
    t2 = time.perf_counter()
    ctrl = reference.kmeans_index(cls, rule, control=True)
    return {"corpus_seed": seed, "n_docs": n,
            "program": reference.cell_mismatch(program, ref, n),
            "control": reference.cell_mismatch(ctrl, ref, n),
            "program_s": t1 - t0, "reference_s": t2 - t1}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="espn-1m.batch64")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--index", action="store_true")
    ap.add_argument("--config-over", type=json.loads, default=None)
    ap.add_argument("--traffic-over", type=json.loads, default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    bench = harness.load_benchmark(ROOT)
    if args.serve:
        bench = with_serve_cell(bench)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    for seed in args.seeds:
        if args.index:
            config = harness.load_config(
                harness.cell_of(bench, args.workload)["config"])
            emit(index_readings(harness._merge(config, args.config_over),
                                seed, device))
            continue
        result, checks = harness.run_cell(
            bench, args.workload, seed, args.seconds, False, device=device,
            config_over=args.config_over, traffic_over=args.traffic_over,
            control=args.control)
        emit({"workload": args.workload, "seed": seed,
              "control": args.control, "config_over": args.config_over,
              "traffic_over": args.traffic_over,
              "correct": result["correct"],
              "attempted": result["attempted"],
              "failed": result["failed"],
              "metrics": {k: v["value"]
                          for k, v in result["metrics"].items()},
              "checks": {n: v for n, v, _ in checks}})
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
