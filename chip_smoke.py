#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which must pass:

1. card: the ``nvidia-smi`` name and power limit; no CUDA device -> exit 2;
2. build: both CUDA kernels from the checkout's sources, in parallel;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the query path's shapes and at ragged edges, with its time (CUDA events,
   median of 50 after warm-up), the plain version's time, a one-call PyTorch
   yardstick where there is one, and the least time the card could take;
4. main path: ``Pipeline.build`` at the ColBERTer widths on a 1M-doc corpus,
   4 batches of 64 queries through ``espn`` and one through ``gds``, with
   every kernel's launch count read around each run, quality, the simulated
   latency breakdown, and the wall time per batch split by stage;
5. agreement: on a small corpus, at the main path's retrieval settings,
   the card path ranks, scores and bills as the CPU path does.

It then prints the card line, the ``{"kernels": [...]}`` line and, last,
the ``{"ok": ...}`` line. Any failed phase exits non-zero without them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from collections import defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and fp32 outside the tensor
# cores. The kernels here run fp32 FMA, so the fp32 rate is their ceiling.
HBM_BYTES_S = 3.35e12
FP32_FLOPS_S = 67e12

KERNELS = {
    "maxsim": {"source": "src/repro_torch/kernels/maxsim/csrc/maxsim.cu",
               "replaces": "src/repro/kernels/maxsim/maxsim.py:44"},
    "ivf_scan": {"source": "src/repro_torch/kernels/ivf_scan/csrc/ivf_scan.cu",
                 "replaces": "src/repro/kernels/ivf_scan/ivf_scan.py:34"},
}
REL_TOL = 1e-5      # fp32 FMA sums taken in another order than the plain
                    # version's cuBLAS product: |err| <= 1e-5 * max(1, |ref|)
AGREE_TOL = 1e-5    # card path vs CPU path: aggregate scores (~25 in size)
                    # after the same fp32 reordering
N_DOCS = 1_000_000  # main-path corpus
BATCHES, BATCH_SIZE = 4, 64
# ESPNConfig's defaults, used by the main path and the agreement phase
NPROBE, K_CANDIDATES, PREFETCH_STEP = 128, 1000, 0.10


def log(*a):
    print(*a, flush=True)


def unit(x):
    return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                           1e-9)).astype(np.float32)


def time_ms(fn, reps=50, warmup=5) -> float:
    """Median device time of one call, from CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / FP32_FLOPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_maxsim(dev, rng, failures) -> dict:
    import torch

    from repro_torch.kernels.maxsim.ops import maxsim
    from repro_torch.kernels.maxsim.ref import maxsim_ref
    T, D = 180, 32
    cases = [  # name, K, Lq, lens, fp16 docs, query mask
        ("slice K=1000 Lq=24", 1000, 24,
         np.clip((rng.pareto(2.5, 1000) + 1) * 36, 8, T), False, False),
        ("K=37 Lq=24 lens 0..T", 37, 24, np.r_[0, T, rng.integers(0, T + 1, 35)],
         False, True),
        ("K=1000 Lq=1", 1000, 1, rng.integers(0, T + 1, 1000), False, False),
        ("K=1000 Lq=24 fp16 docs", 1000, 24, rng.integers(0, T + 1, 1000),
         True, True),
    ]
    row = None
    worst = 0.0
    for name, K, lq, lens, fp16, masked in cases:
        q = torch.tensor(unit(rng.standard_normal((lq, D))), device=dev)
        qm = torch.tensor((rng.random(lq) > 0.2) if masked else np.ones(lq),
                          dtype=torch.float32, device=dev)
        docs = torch.tensor(unit(rng.standard_normal((K, T, D))), device=dev)
        if fp16:
            docs = docs.half()
        lens_t = torch.tensor(np.asarray(lens, np.int32), device=dev)
        out = maxsim(q, qm, docs, lens_t)
        ref = maxsim_ref(q, qm, docs, lens_t)
        torch.cuda.synchronize()
        live = lens_t > 0
        err = float((out[live] - ref[live]).abs().max()) if live.any() else 0.0
        tol = REL_TOL * max(1.0, float(ref[live].abs().max()))
        empty_ok = bool(torch.allclose(out[~live], ref[~live], rtol=1e-6,
                                       atol=0))
        ok = err <= tol and empty_ok and out.shape == (K,)
        worst = max(worst, err)
        log(f"  maxsim {name}: max_abs_err={err:.3g} tol={tol:.3g} "
            f"zero-length docs {'match' if empty_ok else 'DIFFER'} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"maxsim {name}")
        if row is None:                       # the slice's own shape
            n_tok = float(lens_t.clamp(0, T).sum())
            ms = time_ms(lambda: maxsim(q, qm, docs, lens_t))
            plain = time_ms(lambda: maxsim_ref(q, qm, docs, lens_t))
            n_bytes = 4 * (lq * D + lq + 2 * K) + 4 * D * n_tok
            n_ops = 2 * lq * D * n_tok + lq * n_tok + 2 * K * lq
            b_ms, by = bound_ms(n_bytes, n_ops)
            row = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                   "bound_by": by, "library_ms": None}
            log(f"  maxsim timing (K={K}, T={T}, D={D}, Lq={lq}, "
                f"{int(n_tok)} valid tokens): kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, bound {b_ms:.4f} ms ({by})")
    row["max_abs_err"] = worst
    return row


def check_ivf_scan(dev, rng, failures) -> dict:
    import torch

    from repro_torch.kernels.ivf_scan.ops import centroid_scores
    from repro_torch.kernels.ivf_scan.ref import ivf_scan_ref
    cases = [("slice B=64 N=3703 D=128", 64, 3703, 128, True),
             ("B=1 N=37 D=32", 1, 37, 32, False),
             ("B=33 N=130 D=100", 33, 130, 100, False),
             ("B=70 N=3703 D=128", 70, 3703, 128, False)]
    row = None
    worst = 0.0
    for name, B, N, D, is_unit in cases:
        qn = rng.standard_normal((B, D)).astype(np.float32)
        cn = rng.standard_normal((N, D)).astype(np.float32)
        if is_unit:
            qn, cn = unit(qn), unit(cn)
        q = torch.tensor(qn, device=dev)
        c = torch.tensor(cn, device=dev)
        out = centroid_scores(q, c)
        ref = ivf_scan_ref(q, c)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = REL_TOL * max(1.0, float(ref.abs().max()))
        ok = err <= tol and out.shape == (B, N)
        worst = max(worst, err)
        log(f"  ivf_scan {name}: max_abs_err={err:.3g} tol={tol:.3g} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"ivf_scan {name}")
        if row is None:
            ms = time_ms(lambda: centroid_scores(q, c))
            plain = time_ms(lambda: ivf_scan_ref(q, c))
            lib = time_ms(lambda: torch.matmul(q, c.T))
            b_ms, by = bound_ms(4 * (B * D + N * D + B * N), 2 * B * N * D)
            row = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                   "bound_by": by, "library_ms": lib}
            log(f"  ivf_scan timing (B={B}, N={N}, D={D}): kernel {ms:.4f} "
                f"ms, plain {plain:.4f} ms, torch.matmul {lib:.4f} ms, "
                f"bound {b_ms:.4f} ms ({by})")
    row["max_abs_err"] = worst
    return row


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

class StageClock:
    """Wall seconds spent in the query path's stages, read by wrapping the
    functions the path calls: the port itself carries no instrumentation.
    Each key also gets the calling thread's CPU seconds (``key + "_cpu"``):
    wall well above CPU means the thread waited, e.g. for the GIL."""

    def __init__(self):
        self.s = defaultdict(float)

    def wrap(self, owner, name, key, sync=False):
        import torch
        orig = getattr(owner, name)

        def timed(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return orig(*a, **kw)
            finally:
                if sync:
                    torch.cuda.synchronize()
                self.s[key] += time.perf_counter() - t0
                self.s[key + "_cpu"] += time.thread_time() - c0
        setattr(owner, name, timed)

    def install(self):
        from repro_torch.core import prefetcher, rerank
        from repro_torch.pipeline import backends
        from repro_torch.storage.batch_io import BatchReadPlan, BatchReadResult
        from repro_torch.storage.io_engine import StorageTier
        self.wrap(prefetcher.ANNPrefetcher, "run_batch", "prefetch_total")
        # run_batch's two np.isin uses: the per-query hit mask and the
        # cross-query reuse check (``contains``, itself one np.isin), which
        # are the only np.isin calls on the path
        self.wrap(np, "isin", "isin_total")
        self.wrap(BatchReadPlan, "contains", "reuse_check")
        self.wrap(prefetcher, "search_two_phase", "candidate_gen", sync=True)
        self.wrap(backends, "search", "candidate_gen", sync=True)
        self.wrap(StorageTier, "read_batch", "io_plan_submit")
        self.wrap(BatchReadResult, "ensure_query", "host_gather_wait")
        self.wrap(BatchReadResult, "ensure_rows", "host_gather_wait")
        self.wrap(backends, "rerank_query", "rerank_total")
        self.wrap(rerank, "_maxsim_np", "maxsim_call")
        self.wrap(rerank, "maxsim", "maxsim_kernel", sync=True)

    def split(self, wall: float) -> dict:
        s = self.s
        out = {
            "candidate_gen_s": s["candidate_gen"],
            "host_gather_wait_s": s["host_gather_wait"],
            "h2d_d2h_s": s["maxsim_call"] - s["maxsim_kernel"],
            "rerank_kernel_s": s["maxsim_kernel"],
            "rerank_host_s": (s["rerank_total"] - s["host_gather_wait"]
                              - s["maxsim_call"]),
            "io_plan_submit_s": s["io_plan_submit"],
            # espn only: run_batch's host work between its calls, split
            # into the reuse check, the hit-mask np.isin and the rest
            "reuse_check_s": s["reuse_check"],
            "reuse_check_cpu_s": s["reuse_check_cpu"],
            "hit_mask_isin_s": s["isin_total"] - s["reuse_check"],
            "hit_mask_isin_cpu_s": s["isin_total_cpu"] - s["reuse_check_cpu"],
            "prefetch_host_other_s": (s["prefetch_total"] - s["candidate_gen"]
                                      - s["io_plan_submit"] - s["isin_total"]
                                      if s["prefetch_total"] else 0.0),
        }
        out["unattributed_s"] = wall - sum(
            v for k, v in out.items() if not k.endswith("_cpu_s"))
        return out


def counters():
    from repro_torch.kernels.ivf_scan.ops import centroid_scores
    from repro_torch.kernels.maxsim.ops import maxsim
    return {"maxsim": maxsim, "ivf_scan": centroid_scores}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


def check_ranked(resp, n_docs, failures, what):
    for b, r in enumerate(resp.ranked):
        ids, sc = np.asarray(r.doc_ids), np.asarray(r.scores)
        ok = (len(ids) > 0 and ids.shape == sc.shape
              and np.isfinite(sc).all() and (np.diff(sc) <= 0).all()
              and ids.min() >= 0 and ids.max() < n_docs
              and len(np.unique(ids)) == len(ids))
        if not ok:
            failures.append(f"{what}: query {b} ranking malformed")
            return


def run_batches(pipe, corpus, batches, bs, clock, failures, what):
    from repro_torch.core.metrics import mrr_at_k, recall_at_k
    ranked, hits = [], []
    for i in range(batches):
        sl = slice(i * bs, (i + 1) * bs)
        clock.s.clear()
        t0 = time.perf_counter()
        resp = pipe.search(corpus.queries_cls[sl], corpus.queries_bow[sl],
                           corpus.query_lens[sl])
        wall = time.perf_counter() - t0
        check_ranked(resp, corpus.n_docs, failures, f"{what} batch {i}")
        ranked += [r.doc_ids for r in resp.ranked]
        hits.append(resp.breakdown.hit_rate)
        split = {k: round(v, 4) for k, v in clock.split(wall).items()}
        log(f"  {what} batch {i}: wall {wall:.3f} s {json.dumps(split)}")
        log(f"  {what} batch {i}: simulated breakdown "
            f"{json.dumps(resp.breakdown.as_dict())}")
    qrels = corpus.qrels[:batches * bs]
    return {"mrr@10": mrr_at_k(ranked, qrels, 10),
            "recall@100": recall_at_k(ranked, qrels, 100),
            "mean_hit_rate": float(np.mean(hits))}


def profile_batch(pipe, corpus, bs):
    """Main-thread profile of one more espn batch: where its wall time goes
    function by function (cProfile's clock is the wall clock)."""
    import cProfile
    import io
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    pipe.search(corpus.queries_cls[:bs], corpus.queries_bow[:bs],
                corpus.query_lens[:bs])
    prof.disable()
    for key in ("tottime", "cumulative"):
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(18)
        lines = [ln.replace(SRC + "/", "") for ln in buf.getvalue().splitlines()
                 if ln.strip() and not ln.lstrip().startswith(("Ordered",
                                                                 "List"))]
        log(f"  profile of one espn batch by {key}:")
        for ln in lines:
            log("    " + ln[:160])


def main_path(dev, failures, profile=False) -> dict:
    import torch

    from repro_torch.data.synthetic import make_corpus
    from repro_torch.pipeline import (CorpusConfig, Pipeline, PipelineConfig,
                                      RetrievalConfig, StorageConfig)
    batches, bs = BATCHES, BATCH_SIZE
    # ColBERTer widths; retrieval at the paper's ESPNConfig defaults
    cfg = PipelineConfig(
        corpus=CorpusConfig(n_docs=N_DOCS, n_queries=batches * bs,
                            d_cls=128, d_bow=32, max_len=180),
        storage=StorageConfig(dtype="float16", t_max=180),
        retrieval=RetrievalConfig(mode="espn", nprobe=NPROBE,
                                  k_candidates=K_CANDIDATES,
                                  prefetch_step=PREFETCH_STEP,
                                  rerank_count=None))
    c = cfg.corpus
    t0 = time.perf_counter()
    corpus = make_corpus(n_docs=c.n_docs, n_queries=c.n_queries,
                         d_cls=c.d_cls, d_bow=c.d_bow,
                         n_clusters=c.n_clusters, mean_len=c.mean_len,
                         max_len=c.max_len, seed=c.seed)
    log(f"  corpus: {N_DOCS} docs, mean {corpus.mean_tokens:.1f} tokens/doc, "
        f"synthesized in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pipe = Pipeline.build(cfg, corpus=corpus, device=dev)
    torch.cuda.synchronize()
    idx = pipe.index
    log(f"  index: {idx.ncells} cells x {idx.max_cell} slots, "
        f"{idx.memory_bytes() / 2**30:.2f} GiB on {idx.device}; blob "
        f"{pipe.layout.nbytes / 2**30:.2f} GiB on the host; built in "
        f"{time.perf_counter() - t0:.1f} s")
    tensors = [idx.centroids, idx.cell_ids, idx.cell_vecs]
    if not all(t.device.type == "cuda" for t in tensors):
        failures.append("index tensors are not all on cuda")
    clock = StageClock()
    clock.install()
    out = {"n_docs": N_DOCS, "ncells": idx.ncells}
    with pipe:
        reset_counts()
        out["espn"] = run_batches(pipe, corpus, batches, bs, clock, failures,
                                  "espn")
        out["espn"]["launches"] = read_counts()
        cfg.retrieval.mode = "gds"
        with Pipeline.from_artifacts(cfg, index=idx, layout=pipe.layout,
                                     corpus=corpus, device=dev) as gds:
            reset_counts()
            out["gds"] = run_batches(gds, corpus, 1, bs, clock, failures,
                                     "gds")
            out["gds"]["launches"] = read_counts()
        if profile:
            profile_batch(pipe, corpus, bs)
    for mode in ("espn", "gds"):
        r = out[mode]
        log(f"  {mode}: MRR@10={r['mrr@10']:.4f} "
            f"Recall@100={r['recall@100']:.4f} mean hit rate "
            f"{r['mean_hit_rate']:.4f} launches {r['launches']}")
        for name, n in r["launches"].items():
            if n <= 0:
                failures.append(f"{mode}: kernel {name} was never launched")
        if r["mrr@10"] <= 0.5:
            failures.append(f"{mode}: MRR@10 {r['mrr@10']:.3f} too low")
    return out


# ---------------------------------------------------------------------------
# phase 5: the card path agrees with the CPU path on a small input
# ---------------------------------------------------------------------------

def agreement(dev, failures):
    """At the main path's retrieval settings, so the chunked probe merge
    (nprobe > probe_chunk) and the full 1000-candidate rerank run on both
    sides; 512 cells keep nprobe=128 a quarter of the index."""
    from repro_torch.pipeline import Pipeline, PipelineConfig
    for mode in ("espn", "gds"):
        cfg = PipelineConfig()
        cfg.corpus.n_docs, cfg.corpus.n_queries = 20_000, 32
        cfg.index.ncells = 512
        cfg.retrieval.mode = mode
        cfg.retrieval.nprobe = NPROBE
        cfg.retrieval.k_candidates = K_CANDIDATES
        cfg.retrieval.prefetch_step = PREFETCH_STEP
        with Pipeline.build(cfg, device="cpu") as cpu:
            want = cpu.search()
            with Pipeline.from_artifacts(cfg, index=cpu.index,
                                         layout=cpu.layout,
                                         corpus=cpu.corpus,
                                         device=dev) as card:
                got = card.search()
        worst, swaps, bad = 0.0, 0, 0
        for w, g in zip(want.ranked, got.ranked):
            worst = max(worst, float(np.abs(w.scores - g.scores).max()))
            for j in np.nonzero(w.doc_ids != g.doc_ids)[0]:
                # allowed: two candidates within AGREE_TOL trading places
                swaps += 1
                bad += not any(0 <= n < len(w.doc_ids)
                               and w.doc_ids[n] == g.doc_ids[j]
                               and abs(w.scores[n] - w.scores[j]) <= AGREE_TOL
                               for n in (j - 1, j + 1))
        same_bill = want.breakdown.as_dict() == got.breakdown.as_dict()
        ok = worst <= AGREE_TOL and same_bill and bad == 0
        log(f"  {mode} card vs CPU on 20,000 docs: max score diff "
            f"{worst:.3g} (tol {AGREE_TOL}), {swaps} ids swapped between "
            f"near-tied neighbours, {bad} other id differences, simulated "
            f"bill {'equal' if same_bill else 'DIFFERS'} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{mode}: card path disagrees with CPU path")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one espn batch on the host (cProfile)")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    failures: list[str] = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        failures.append("nvidia-smi gave no card line")
    dev = resolve_device("cuda")
    log(f"[card] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f", torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build(list(KERNELS))
    log(f"[build] {time.perf_counter() - t0:.1f} s; nvcc per kernel "
        f"{json.dumps({k: round(v, 1) for k, v in _build.build_seconds.items()})}")

    rng = np.random.default_rng(0)
    rows = {}
    phases = [("kernels", lambda: rows.update(
                  maxsim=check_maxsim(dev, rng, failures),
                  ivf_scan=check_ivf_scan(dev, rng, failures))),
              ("main path", lambda: rows.update(
                  path=main_path(dev, failures, args.profile))),
              ("agreement", lambda: agreement(dev, failures))]
    for name, fn in phases:
        log(f"[{name}]")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failures.append(f"phase {name} raised")
            break
        log(f"[{name}] {time.perf_counter() - t0:.1f} s")
    if failures:
        print("chip_smoke.py FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    launches = rows["path"]["espn"]["launches"]
    kernels = [{"name": name, "route": "cuda", **meta,
                "launches": launches[name], **rows[name],
                "kernel_ms": rows[name]["ms"]}
               for name, meta in KERNELS.items()]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
