#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which must pass:

1. card: the ``nvidia-smi`` name and power limit; no CUDA device -> exit 2;
2. build: the six CUDA kernels from the checkout's sources, in parallel;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the paths' shapes and at ragged edges (``fdescan``, ``maxsim`` and
   ``bitsim`` on both of their kernels, each case naming the one it took;
   ``flash_decode`` one launch a call and the same bits twice), with its
   time two ways: ``ms`` (CUDA events around one Python call, median of 50
   after warm-up: the host's time to reach the launch is inside) and
   ``device_ms`` (20 calls in one CUDA graph replayed between two events,
   / 20: the card's own time, with the profiler's kernel time beside it as
   a cross-check); the plain version's time, a one-call PyTorch yardstick
   where there is one (both ways), the least time the card could take and
   the share of it reached;
4. main path: ``Pipeline.build`` at the ColBERTer widths on a 1M-doc corpus,
   1 batch of 64 queries through ``espn`` and one through ``gds``, then,
   through ``Pipeline.from_artifacts`` on the same corpus, index and layout,
   one batch each through ``mmap``, ``swap``, ``dram``, ``bitvec``, ``fde``
   and ``cascade`` (their bit and FDE tables built once, with size and
   build time), and one ``cspn`` batch on the corpus pooled to 32 tokens a
   doc in the ``fixed_stride`` layout, with the same index; every kernel's
   launch count read around each mode's run (and, in phases 5-11, around
   each of their paths), the device the rerank's tiles
   lie on, the K and the kernel of each maxsim and bitsim call (every one
   on the tensor cores, or the run fails; bitsim then timed on the device
   at the K it was called at), quality, the simulated latency breakdown,
   and the wall time per batch split by stage;
5. persist: the main path's index, layout, bit and FDE tables saved (no
   corpus) under ``build/``, loaded back onto the card with
   ``Pipeline.load``, one espn and one cascade batch held bit for bit to
   the unsaved pipeline's; bytes written, save and load seconds;
6. serve: ``RetrievalServer`` on the loaded espn pipeline (batches of up to
   32): 128 requests through ``query_async``, each equal bit for bit to
   ``Pipeline.search`` of its query alone, the server's latency summary
   and throughput; then a gds server under ``SLOPolicy`` offered a
   Poisson stream (``serve/workload.py``) at twice that throughput, under
   a 50 ms deadline and under twice the static median latency: the shed
   fraction and goodput under the SLO;
7. encoder: ColBERTer at its published widths (6 layers, d_model 768,
   bf16 compute over fp32 masters, random weights from numpy seed 0): 64
   queries of 32 tokens and 1,024 docs of the corpus's ragged lengths (up
   to 180) in batches of 128, timed (docs/s, ms a batch, peak memory);
   fp32 on the card within 1e-4 of fp32 on the CPU, bf16 at cosine >=
   0.99 to fp32; then 128 requests through phase 6's server pipeline, each
   query encoded on the card first, each answer equal bit for bit to
   ``search`` of its query alone;
8. disk_ivf: the main path's index as a SPANN-style disk IVF (postings in
   a host disk image, no cache and a 10% hot-cell cache), 64 queries at
   nprobe 128, k 1,000 (probes on ``ivf_scan``): bills and stats equal to
   the same search on the CPU, ids up to near ties; at least 90% of k
   shared with the in-memory search; resident bytes below 1/20 of the
   in-memory index's; a fully cached warm pass bills nothing;
9. faults: the layout's crc32 pass timed, two espn batches with seeded
   read errors, stalls and corruptions (checksums on, degraded answers
   on): the counters, the degraded queries, and maxsim launched for the
   non-degraded queries alone; a batch whose every read fails (no maxsim,
   no gather_pack); one traced server batch exported to Perfetto and read
   back by ``analyze_trace``;
10. cluster: the storage cluster on the same artifacts (its espn batches
   of 16 queries, held to a single-tier batch of the same 16): a 1x1
   cluster's espn batch equal to the single tier's bit for bit (bill
   included); 4 shards x 2 replicas in cascade and espn, equal in ids,
   scores and byte bills (only the clock moves); a sharded espn server
   whose 32 answers equal ``search`` of each query alone; a killed replica
   failing over with nothing degraded, and its recovery's re-sync bill; gds
   on stragglers
   (a 3x primary, jitter, hedging past the 0.95 quantile, a 4,000 MB arena
   cache): three batches, the first hedged, the next two from the cache
   with no critical I/O; an autoscaled gds server under a 50 ms SLO and
   its decisions;
11. mutation: live mutation on the same artifacts: an unmutated mutable 1x1
   cluster's espn batch equal to the single tier's bit for bit (bill
   included); on a mutable 4 x 2 cluster over phase 10's shard images, 4
   ingests of 2,500 fresh docs (the generator under another seed) and
   10,000 base docs plus ~30% of the new ones tombstoned, a cascade batch
   of 64 and an espn batch of 16 mid-churn with no tombstoned id in any
   answer; the appended bit and FDE tables equal to a rebuild of the grown
   layout, the grown layout to a pack from scratch and the grown index to
   the pre-ingest one with ``ivf_add`` replayed, bit for bit; the churned
   espn answers equal to that rebuild oracle's bit for bit; the churned tier
   saved in the ``mutation/`` format under ``build/`` and loaded back onto
   the card (tombstones and segments as saved, an espn and a cascade
   batch equal to the unsaved tier's in ids, scores and bill, and an
   ingest and a delete on the loaded pipeline alone giving the ids that
   follow the unsaved one's and answering no tombstoned id); ``compact``
   (every tombstone's blocks reclaimed), ``rebalance`` (both sides billed) and
   ``maintain``, each leaving the answers bit for bit; host seconds of
   each step;
12. train: ColBERTer at its published widths (bf16 compute over fp32
   masters, weights from numpy seed 0) trained 20 ``Trainer`` steps of 32
   ``synth_pairs`` pairs (AdamW, a checkpoint every 10 steps under
   ``build/``): step ms, pairs/s, tokens/s, peak memory, the losses; a
   fresh Trainer resumed from step 10 replaying steps 10-19; grad_accum=2
   equal to its halves' averaged update; 5 compressed steps finite; one
   fp32 step at 2 layers on the card = the CPU's; SmolLM-135M at full
   width and depth, 3 steps of 8 x 4,096 tokens (train_4k's sequence)
   through its loss, each layer recomputed in the backward (``remat``, the
   default); one SmolLM step of 8 x 512 tokens with ``remat`` on and off
   from the same weights and batch, in bf16 and in fp32: the loss and every
   gradient within 3e-2 / 1e-6 of the tensor's largest magnitude (and
   whether bit for bit); no kernel launched (the losses are plain PyTorch
   with autograd);
13. agreement: on a small corpus, at the main path's retrieval settings,
   the card path ranks, scores and bills as the CPU path does in every
   mode (``fde`` in both branches, ``cspn`` on a pooled fixed layout), and
   the card builds the FDE table the CPU builds and builds its IVF index
   and FDE table the same twice; with faults on, the card
   and the CPU give equal ids, degraded flags, counters and bills in every
   single-tier mode; tracing changes no bit on the card; a directory
   saved on the card loads on the CPU and answers as the card does; and
   the reference CI's cluster settings (hedged + cached, faulted, traced)
   give the CPU's ids, bills, cluster counters and spans on the card;
   and a churn (ingest, delete, compact, ingest, delete, rebalance) on a
   mutable 2 x 2 cluster in every mode gives the CPU's ids, bills, reports
   and counters on the card;
14. decode path: SmolLM-135M at full width and depth (random weights drawn
   on the card from a seed), 8 requests of 4,096 tokens prefilled, then 32 greedy
   decode steps over the KV cache, every step's attention on the
   ``flash_decode`` kernel (30 launches a step, 960 in all, or the run
   fails); prefill and step wall, the step's split, tokens/s, peak memory;
15. decode agreement: the same model in fp32 at 2 layers, its logits and
   greedy tokens on the card against the CPU path; at full width and depth,
   4 decode steps with ``onehot_cache_update`` off and on: logits and
   caches bit for bit, flash_decode once a layer a step either way;
16. moe: the other LM configs through the same ``decode_path`` (bf16 over
   fp32 masters drawn on the card): granite-moe-1b-a400m (24 layers, 32
   experts top-8) and qwen2-0.5b (24 layers, G 7) at full width and depth,
   8 x 4,096-token prefill and 32 decode steps (768 flash_decode launches
   each, or the run fails; granite's prefill aux loss and drops per layer),
   llama4-scout-17b-a16e at full width and 2 of its 48 layers (16 experts
   top-1 + a shared expert), 8 x 1,024 tokens and 8 steps; granite trained
   3 steps of 8 x 512 tokens (finite ce and aux, no kernel launched; each
   layer recomputed in the backward); and
   granite in fp32 at 2 layers card vs CPU, its expert choices equal up to
   near ties (each logged), keep masks equal where routing agrees;
17. recsys: fm, autoint, dlrm-mlperf and two-tower-retrieval at their
   published widths (bf16 over fp32 masters drawn on the card; tables
   capped at 20,000,000 rows to serve, 4,000,000 to train): a serve_p99
   (512) and a serve_bulk (262,144) batch through ``forward`` each (ms a
   batch, rows/s, peak memory, the same bits twice, a loss twice),
   two-tower's 1,000,448-candidate top 100 and its query tower alone; 3
   AdamW steps each (65,536 rows, two-tower 16,384; ms a step, peak
   memory, the first step's weights the same bits twice); ESPN-for-RecSys
   over a 2,000,000 x 64 fp16 table at the benchmark's three settings and
   at the measured query-tower budget (hit rate, simulated critical and
   direct I/O); each smoke config in fp32 card vs CPU;
18. gnn: gatedgcn at its published width (16 layers, d_hidden 70, 47
   classes) trained 3 AdamW steps each on full_graph_sm (edges padded by
   ``pad512``), a ``sample_block`` block of minibatch_lg (fanouts 15 and
   10, 1,024 seeds, on a 232,965-node graph of average degree 50) and a
   molecule batch (128 graphs, ``graph_ids`` readout): ms a step, peak
   memory, finite losses and gradients, the same bits twice; the smoke
   config in fp32 card vs CPU, and with 512 pad edges vs none on the card.
   Neither phase may launch any of the six kernels;
19. dryrun: the port's multi-pod dry run (``launch/dryrun.py``) on the
   card's host, in a subprocess (its fake 512-rank process group is the
   process's): colberter/serve_q32 on the 16x16 and 2x16x16 meshes,
   qwen2-72b/decode_32k and llama4-scout-17b-a16e/decode_32k on the 16x16
   mesh, each "ok", one line a cell; then, on a real 1x1 ``make_dev_mesh``
   (a one-rank NCCL group), colberter/serve_q32, fm/serve_p99 and
   gatedgcn/full_graph_sm (a training step) counted by the dry run and run
   on the card on tensors of the cell's shapes drawn from a seed, and
   smollm-135m/train_4k at 8 x 4,096 tokens (its 1x1 dry run in a
   subprocess on a one-rank gloo group, fake tensors; on the card one run
   counted, one measured and timed): the
   card step's ``FlopCounterMode`` count equals the dry run's FLOPs
   exactly, its ``max_memory_allocated`` above its start (the arguments
   already on the card) is 0.90-1.10 x the dry run's bytes above the
   arguments (temporaries + outputs - the arguments updated in place),
   and its median time of 20
   (CUDA events; the LM step's one) stands
   beside the dry run's H100 roofline bound and their ratio. No kernel may
   launch (the reference's dry run reaches no Pallas kernel either).

It then prints the card line, the ``{"kernels": [...]}`` line and, last,
the ``{"ok": ...}`` line. Any failed phase exits non-zero without them.
"""
from __future__ import annotations

import argparse
import gc
import json
import mmap
import multiprocessing
import os
import subprocess
import sys
import time
import traceback
from collections import defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, fp32 outside the tensor
# cores (the ceiling of the kernels that run fp32 FMA), dense fp16 on the
# tensor cores (fdescan's wgmma kernel, maxsim's mma kernel) and dense TF32
# on the tensor cores (ivf_scan's 3xTF32 products).
HBM_BYTES_S = 3.35e12
FP32_FLOPS_S = 67e12
FP16_TC_FLOPS_S = 989e12
TF32_TC_FLOPS_S = 495e12
GRAPH_CALLS = 20    # calls captured into one CUDA graph for device_ms

KERNELS = {
    "maxsim": {"source": "src/repro_torch/kernels/maxsim/csrc/maxsim.cu",
               "replaces": "src/repro/kernels/maxsim/maxsim.py:44"},
    "ivf_scan": {"source": "src/repro_torch/kernels/ivf_scan/csrc/ivf_scan.cu",
                 "replaces": "src/repro/kernels/ivf_scan/ivf_scan.py:34"},
    "bitsim": {"source": "src/repro_torch/kernels/bitsim/csrc/bitsim.cu",
               "replaces": "src/repro/kernels/bitsim/bitsim.py:54"},
    "fdescan": {"source": "src/repro_torch/kernels/fdescan/csrc/fdescan.cu",
                "replaces": "src/repro/kernels/fdescan/fdescan.py:33"},
    "gather_pack": {
        "source": "src/repro_torch/kernels/gather_pack/csrc/gather_pack.cu",
        "replaces": "src/repro/kernels/gather_pack/gather_pack.py:38"},
    "flash_decode": {
        "source": "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode/flash_decode.py:62"},
}
REL_TOL = 1e-5      # fp32 sums taken in another order than the plain
                    # version's cuBLAS product (on the tensor cores, of
                    # operands split in two parts that keep fp32's
                    # accuracy): |err| <= 1e-5 * max(1, |ref|)
AGREE_TOL = 1e-5    # card path vs CPU path: aggregate scores (~25 in size)
                    # after the same fp32 reordering
N_DOCS = 1_000_000  # main-path corpus
POOL_K = 32         # cspn: benchmarks/bench_constant_space.py's setting,
                    # (128 + 32 * 32) fp16 values = one 4 KiB block a doc
BATCHES, BATCH_SIZE = 1, 64   # espn batches on the main path (4 until the
                              # encoder and disk_ivf phases came, 2 until
                              # [dryrun] came: depth cuts)
N_QUERIES = 256               # the corpus's queries (the serve phase's 128 +)
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


def device_ms(fn, calls=GRAPH_CALLS, reps=5) -> float:
    """Device time of one call: ``calls`` calls captured into one CUDA graph
    after a warm-up, the graph replayed between one pair of CUDA events
    (median of ``reps`` replays), divided by ``calls``. Unlike ``time_ms``
    it holds none of the host's time to reach each launch (the wrapper's
    checks, allocation, the ctypes call). Every op launches on
    ``torch.cuda.current_stream()``, which is the capture stream inside
    ``torch.cuda.graph``; the launch counters are restored afterwards, so
    no path's count holds capture calls."""
    import torch
    saved = read_counts()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    restore_counts(saved)
    return float(np.median(times))


def profiler_ms(fn, calls=5):
    """Cross-check of ``device_ms``: the CUDA kernels' own durations (CUPTI,
    through ``torch.profiler``) over ``calls`` calls, per call; None where
    the profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    saved = read_counts()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    restore_counts(saved)
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if str(ev.device_type).endswith("CUDA"))
    return us / calls / 1e3 if us > 0 else None


def timings(kernel, plain, library, n_bytes, n_ops, flops=FP32_FLOPS_S,
            suffix="") -> dict:
    """A row's times: per call (``ms``, events around one Python call) and
    on the device alone (``device_ms``, CUDA graph), for the kernel and the
    library call; the plain version's per-call time; the bound and the
    share of it the kernel reaches on the device; the profiler's kernel
    time as a cross-check."""
    b_ms, by = bound_ms(n_bytes, n_ops, flops)
    row = {"ms": time_ms(kernel), "device_ms": device_ms(kernel),
           "plain_ms": time_ms(plain), "bound_ms": b_ms, "bound_by": by,
           "library_ms": None, "library_device_ms": None,
           "profiler_ms": profiler_ms(kernel)}
    if library is not None:
        row["library_ms"] = time_ms(library)
        row["library_device_ms"] = device_ms(library)
    row["bound_share"] = b_ms / row["device_ms"]
    return {k + suffix: v for k, v in row.items()}


def timing_line(what, row, suffix="") -> str:
    r = {k: row.get(k + suffix) for k in (
        "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "library_device_ms", "profiler_ms", "bound_share")}
    lib = ("none" if r["library_ms"] is None else
           f"{r['library_ms']:.4f} ms a call, {r['library_device_ms']:.4f} "
           f"ms on the device")
    prof = ("no device time" if r["profiler_ms"] is None
            else f"{r['profiler_ms']:.4f} ms")
    return (f"  {what}: kernel {r['ms']:.4f} ms a call, {r['device_ms']:.4f} "
            f"ms on the device (profiler {prof}), {100 * r['bound_share']:.1f}"
            f"% of the bound {r['bound_ms']:.4f} ms ({r['bound_by']}); plain "
            f"{r['plain_ms']:.4f} ms; library {lib}")


def bound_ms(n_bytes: float, n_ops: float,
             flops: float = FP32_FLOPS_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_maxsim(dev, rng, failures) -> dict:
    """Both kernels, each case naming the one it takes (``mma``, the tensor
    cores, for fp16 docs with D of 16/32/64 and Lq <= 32; ``simt`` else),
    the same bits twice; at D=32, Lq=24 and fp16 docs, K is chosen so
    that the ``mma`` kernel's four instances (1, 2, 4 and 8 docs a block)
    all run. Timed at the rerank's shape (K=1,000, fp16 docs: the row;
    fp32 docs beside it) and at the sizes the path calls it at
    (``time_path_sizes``)."""
    import torch

    from repro_torch.kernels.maxsim.ops import (kernel_for, maxsim,
                                                mma_docs_per_block)
    from repro_torch.kernels.maxsim.ref import maxsim_ref
    T, D = 180, 32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k2, k4 = 2 * sms - 7, 4 * sms - 9
    slice_lens = np.clip((rng.pareto(2.5, 1000) + 1) * 36, 8, T)
    cases = [  # name, K, Lq, D, lens, fp16 docs, query mask, timed
        # the rerank's shape: the path feeds fp16 tiles (the row); the
        # fp32 case is timed too, for comparison
        ("slice K=1000 Lq=24 fp32 docs", 1000, 24, D, slice_lens, False,
         False, True),
        ("slice K=1000 Lq=24 fp16 docs", 1000, 24, D, slice_lens, True,
         False, True),
        ("K=37 Lq=24 lens 0..T", 37, 24, D,
         np.r_[0, T, rng.integers(0, T + 1, 35)], False, True, False),
        ("K=37 Lq=24 fp16 lens 0, T, above T", 37, 24, D,
         np.r_[0, T, T + 5, rng.integers(0, T + 1, 34)], True, True, False),
        ("K=1000 Lq=1", 1000, 1, D, rng.integers(0, T + 1, 1000), False,
         False, False),
        ("K=1000 Lq=1 fp16", 1000, 1, D, rng.integers(0, T + 1, 1000), True,
         False, False),
        ("K=1000 Lq=24 fp16 docs", 1000, 24, D, rng.integers(0, T + 1, 1000),
         True, True, False),
        (f"K={k2} Lq=24 fp16 docs", k2, 24, D, rng.integers(0, T + 1, k2),
         True, True, False),
        (f"K={k4} Lq=24 fp16 docs", k4, 24, D, rng.integers(0, T + 1, k4),
         True, True, False),
        ("K=300 Lq=32 D=16 fp16", 300, 32, 16, rng.integers(0, T + 1, 300),
         True, True, False),
        ("K=300 Lq=33 D=32 fp16 (Lq above 32)", 300, 33, D,
         rng.integers(0, T + 1, 300), True, True, False),
        ("K=100 Lq=24 D=100 fp16 (D no multiple of 16)", 100, 24, 100,
         rng.integers(0, T + 1, 100), True, True, False),
    ]
    row = None
    worst = 0.0
    per_block = set()        # mma instances run at D=32, Lq=24
    for name, K, lq, d, lens, fp16, masked, timed in cases:
        q = torch.tensor(unit(rng.standard_normal((lq, d))), device=dev)
        qm = torch.tensor((rng.random(lq) > 0.2) if masked else np.ones(lq),
                          dtype=torch.float32, device=dev)
        docs = torch.tensor(unit(rng.standard_normal((K, T, d))), device=dev)
        if fp16:
            docs = docs.half()
        lens_t = torch.tensor(np.asarray(lens, np.int32), device=dev)
        out = maxsim(q, qm, docs, lens_t)
        again = maxsim(q, qm, docs, lens_t)
        ref = maxsim_ref(q, qm, docs, lens_t)
        torch.cuda.synchronize()
        live = lens_t > 0
        err = float((out[live] - ref[live]).abs().max()) if live.any() else 0.0
        tol = REL_TOL * max(1.0, float(ref[live].abs().max()))
        empty_ok = bool(torch.allclose(out[~live], ref[~live], rtol=1e-6,
                                       atol=0))
        route = kernel_for(q, docs)
        want = "mma" if fp16 and d in (16, 32, 64) and lq <= 32 else "simt"
        same = torch.equal(out, again)
        ok = (err <= tol and empty_ok and out.shape == (K,) and same
              and route == want)
        worst = max(worst, err)
        if route == "mma":
            if (d, lq) == (D, 24):
                per_block.add(mma_docs_per_block(K))
            route += f", {mma_docs_per_block(K)} docs a block"
        log(f"  maxsim {name} ({route} kernel): max_abs_err={err:.3g} "
            f"tol={tol:.3g} zero-length docs "
            f"{'match' if empty_ok else 'DIFFER'}, same bits twice {same} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"maxsim {name}")
        if not timed:
            continue

        def n_work(lens_part, k):
            """Bytes (each valid token row, q, the mask, lens, the output
            once) and operations: the tensor cores' two fp16 passes (q in
            two parts), and the fp32 products the first port counted."""
            n_tok = float(lens_part.clamp(0, T).sum())
            n_bytes = (4 * (lq * d + lq + 2 * k)
                       + docs.element_size() * d * n_tok)
            return n_tok, n_bytes, 2 * 2 * lq * d * n_tok, \
                2 * lq * d * n_tok + lq * n_tok + 2 * k * lq
        n_tok, n_bytes, tc_ops, fp32_ops = n_work(lens_t, K)
        if fp16:
            t = timings(lambda: maxsim(q, qm, docs, lens_t),
                        lambda: maxsim_ref(q, qm, docs, lens_t), None,
                        n_bytes, tc_ops, FP16_TC_FLOPS_S)
        else:
            t = timings(lambda: maxsim(q, qm, docs, lens_t),
                        lambda: maxsim_ref(q, qm, docs, lens_t), None,
                        n_bytes, fp32_ops)
        t["bound_fp32_ops_ms"] = bound_ms(n_bytes, fp32_ops)[0]
        log(timing_line(
            f"maxsim timing (K={K}, T={T}, D={d}, Lq={lq}, {int(n_tok)} "
            f"valid tokens, {'fp16' if fp16 else 'fp32'} docs, "
            f"{route} kernel{', the row' if fp16 else ''}; no one PyTorch "
            f"call computes a length-masked max-then-sum; bound by fp32 "
            f"operations {t['bound_fp32_ops_ms']:.4f} ms)", t))
        if fp16:
            row = t
            row.update(time_path_sizes(q, qm, docs, lens_t, n_work,
                                       failures))
    if per_block != {1, 2, 4, 8}:
        failures.append(f"maxsim: the mma kernel ran at {sorted(per_block)}"
                        " docs a block, not at each of 1, 2, 4 and 8")
    row["max_abs_err"] = worst
    return row


# K of the path's maxsim calls (``main_path`` logs them): cascade 64,
# bitvec 128, espn's min, quartiles and max, and 1,000 for the other modes
PATH_K = (64, 128, 213, 334, 500, 666, 787, 1000)


def time_path_sizes(q, qm, docs, lens, n_work, failures) -> dict:
    """maxsim on the card at the sizes the path calls it at: the first K
    of the timed case's docs for each of ``PATH_K``, and espn's split of a
    query's 1,000 candidates (666 prefetched hits, then 334 misses, its
    quartiles) in one timed call; 900 then 100 beside it (a 90% hit rate,
    the guess before the path's K were logged). Each is first held to the
    plain version."""
    from repro_torch.kernels.maxsim.ops import maxsim
    from repro_torch.kernels.maxsim.ref import maxsim_ref
    ref = maxsim_ref(q, qm, docs, lens)
    tol = REL_TOL * max(1.0, float(ref.abs().max()))
    out = {"path_sizes": {}}

    def check(got, k0, k1, what):
        err = float((got - ref[k0:k1]).abs().max())
        if err > tol:
            failures.append(f"maxsim {what}: err {err:.3g} > {tol:.3g}")
        return err
    for k in PATH_K:
        err = check(maxsim(q, qm, docs[:k], lens[:k]), 0, k, f"K={k}")
        _, n_bytes, tc_ops, _ = n_work(lens[:k], k)
        out["path_sizes"][k] = {
            "device_ms": device_ms(lambda k=k: maxsim(q, qm, docs[:k],
                                                      lens[:k])),
            "bound_ms": bound_ms(n_bytes, tc_ops, FP16_TC_FLOPS_S)[0],
            "max_abs_err": err}
    log("  maxsim on the device at the path's K: " + ", ".join(
        f"K={k} {v['device_ms']:.4f} ms (bound {v['bound_ms']:.4f})"
        for k, v in out["path_sizes"].items()))

    def split(hits):
        """A query's hits, then its misses: two launches, both checked."""
        parts = ((docs[:hits], lens[:hits]), (docs[hits:], lens[hits:]))
        got = [maxsim(q, qm, dd, ll) for dd, ll in parts]
        check(got[0], 0, hits, f"split {hits}: hits")
        check(got[1], hits, len(docs), f"split {hits}: misses")
        return parts, lambda: [maxsim(q, qm, dd, ll) for dd, ll in parts]
    parts, call = split(666)
    work = [n_work(ll, len(ll)) for _, ll in parts]
    out.update(timings(
        call, lambda: [maxsim_ref(q, qm, dd, ll) for dd, ll in parts], None,
        sum(w[1] for w in work), sum(w[2] for w in work), FP16_TC_FLOPS_S,
        suffix="_split"))
    out["device_ms_split_900"] = device_ms(split(900)[1])
    log(timing_line(
        "maxsim timing at espn's split (K=666 hits then K=334 misses, two "
        f"launches; 900 then 100: {out['device_ms_split_900']:.4f} ms on "
        "the device)", out, "_split"))
    return out


def check_ivf_scan(dev, rng, failures) -> dict:
    """The slice's shape and ragged edges (B, N and D past a tile; D=37,
    the 4-byte copies; D past 128, in rounds of four chunks through two
    buffers), the same bits twice; timed at the slice's shape,
    torch.matmul in full fp32 as the library yardstick."""
    import torch

    from repro_torch.kernels.ivf_scan.ops import centroid_scores
    from repro_torch.kernels.ivf_scan.ref import ivf_scan_ref
    cases = [("slice B=64 N=3703 D=128", 64, 3703, 128, True),
             ("B=1 N=37 D=32", 1, 37, 32, False),
             ("B=33 N=130 D=100", 33, 130, 100, False),
             ("B=70 N=3703 D=128", 70, 3703, 128, False),
             ("B=5 N=77 D=37 (4-byte copies)", 5, 77, 37, False),
             ("B=33 N=130 D=160 (2 rounds)", 33, 130, 160, False),
             ("B=70 N=3703 D=300 (3 rounds)", 70, 3703, 300, False),
             ("B=5 N=77 D=258 (3 rounds, 4-byte copies)", 5, 77, 258, False),
             ("B=64 N=130 D=520 (5 rounds)", 64, 130, 520, False)]
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
        again = centroid_scores(q, c)
        ref = ivf_scan_ref(q, c)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = REL_TOL * max(1.0, float(ref.abs().max()))
        same = torch.equal(out, again)
        ok = err <= tol and out.shape == (B, N) and same
        worst = max(worst, err)
        log(f"  ivf_scan {name}: max_abs_err={err:.3g} tol={tol:.3g}, same "
            f"bits twice {same} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"ivf_scan {name}")
        if row is None:
            # bound: q and the centroids read once, the scores written
            # once; the TF32 tensor cores' three products (3xTF32)
            n_bytes = 4 * (B * D + N * D + B * N)
            row = timings(lambda: centroid_scores(q, c),
                          lambda: ivf_scan_ref(q, c),
                          lambda: torch.matmul(q, c.T),
                          n_bytes, 3 * 2 * B * N * D, TF32_TC_FLOPS_S)
            row["bound_fp32_ops_ms"] = bound_ms(n_bytes, 2 * B * N * D)[0]
            log(timing_line(f"ivf_scan timing (B={B}, N={N}, D={D}; "
                            f"library torch.matmul, TF32 off; bound by fp32 "
                            f"operations {row['bound_fp32_ops_ms']:.4f} ms)",
                            row))
    row["max_abs_err"] = worst
    return row


def bitsim_inputs(dev, rng, K, T, lq, D, lens, lanes="uint32",
                  masked=False):
    """Unit q, its mask (all ones unless ``masked``) and the signs of normal
    doc tokens in 32-bit lanes (``lanes``: the packing's own lane dtype,
    re-viewed), on the card."""
    import torch

    from repro_torch.core.quantize import binary_pack, to_uint32_lanes
    q = torch.tensor(unit(rng.standard_normal((lq, D))), device=dev)
    qm = torch.tensor((rng.random(lq) > 0.2) if masked else np.ones(lq),
                      dtype=torch.float32, device=dev)
    packed = to_uint32_lanes(binary_pack(
        rng.standard_normal((K, T, D)).astype(np.float32), dtype=lanes))
    docs = torch.tensor(packed.view(np.int32), device=dev)
    lens_t = torch.tensor(np.asarray(lens, np.int32), device=dev)
    return q, qm, docs, lens_t


def bitsim_work(q, docs, lens) -> tuple[float, float, float]:
    """Bytes (each valid token's lanes, q, the mask, lens, the output once),
    the tensor cores' operations (two fp16 parts of q against each valid
    token, as maxsim counts them: no padding of tokens or dims) and the
    fp32 operations the first port counted."""
    lq, d = q.shape
    k, t, w = docs.shape
    n_tok = float(lens.clamp(0, t).sum())
    n_bytes = 4 * (lq * d + lq + 2 * k) + 4 * w * n_tok
    tc_ops = 2 * 2 * lq * d * n_tok
    fp32_ops = 2 * lq * d * n_tok + lq * n_tok + 2 * k * lq
    return n_bytes, tc_ops, fp32_ops


def check_bitsim(dev, rng, failures) -> dict:
    """Both kernels, each case naming the one it takes (``mma``, the tensor
    cores, for Lq of 1 to 32, D up to 64 and T up to 1,024; ``simt`` else),
    one launch a call and the same bits twice; at D=32, Lq=24, K is chosen
    so that the ``mma`` kernel's four docs-a-block choices (1, 2, 4 and 8
    warps) all run. Timed at the bit filter's shape (K=1,000, T=180, W=1,
    D=32, Lq=24: the row)."""
    import torch

    from repro_torch.kernels.bitsim.ops import (bitsim, kernel_for,
                                                mma_docs_per_block)
    from repro_torch.kernels.bitsim.ref import bitsim_ref
    T = 180
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k2, k4 = 2 * sms - 7, 4 * sms - 9

    def ragged(k, t=T):
        return np.r_[0, t, t + 5, rng.integers(0, t + 1, k - 3)]
    cases = [  # name, K, T, Lq, D, lens, lane dtype, query mask
        ("slice K=1000 W=1 D=32 Lq=24", 1000, T, 24, 32,
         np.clip((rng.pareto(2.5, 1000) + 1) * 36, 8, T), "uint32", False),
        ("K=1 Lq=24", 1, T, 24, 32, [T - 3], "uint32", False),
        ("K=37 lens 0, T, above T, masked", 37, T, 24, 32, ragged(37),
         "uint32", True),
        (f"K={k2} Lq=24", k2, T, 24, 32, ragged(k2), "uint32", True),
        (f"K={k4} Lq=24", k4, T, 24, 32, ragged(k4), "uint32", True),
        ("K=1000 Lq=1", 1000, T, 1, 32, ragged(1000), "uint32", False),
        ("K=1000 Lq=32 W=2 D=64", 1000, T, 32, 64, ragged(1000), "uint32",
         True),
        ("K=333 W=2 D=40 Lq=7", 333, T, 7, 40, ragged(333), "uint32", True),
        ("K=200 W=1 D=16 Lq=24", 200, T, 24, 16, ragged(200), "uint32",
         True),
        ("K=200 W=1 D=8 Lq=24", 200, T, 24, 8, ragged(200), "uint32", True),
        ("K=200 W=1 D=1 Lq=7", 200, T, 7, 1, ragged(200), "uint8", True),
        ("K=1000 uint8 lanes re-viewed", 1000, T, 24, 32, ragged(1000),
         "uint8", False),
        ("K=300 T=1024", 300, 1024, 24, 32, ragged(300, 1024), "uint32",
         True),
        ("K=300 Lq=33 (Lq above 32)", 300, T, 33, 32, ragged(300), "uint32",
         True),
        ("K=50 T=1100 (T above 1,024)", 50, 1100, 24, 32, ragged(50, 1100),
         "uint32", True),
    ]
    row = None
    worst = 0.0
    per_block = set()        # mma instances run at D=32, Lq=24
    for name, K, t, lq, D, lens, lanes, masked in cases:
        q, qm, docs, lens_t = bitsim_inputs(dev, rng, K, t, lq, D, lens,
                                            lanes, masked)
        before = bitsim.launches
        out = bitsim(q, qm, docs, lens_t)
        again = bitsim(q, qm, docs, lens_t)
        launched = bitsim.launches - before
        ref = bitsim_ref(q, qm, docs, lens_t)
        torch.cuda.synchronize()
        live = lens_t > 0
        err = float((out[live] - ref[live]).abs().max()) if live.any() else 0.0
        tol = REL_TOL * max(1.0, float(ref[live].abs().max()))
        empty_ok = bool(torch.allclose(out[~live], ref[~live], rtol=1e-6,
                                       atol=0))
        route = kernel_for(q, docs)
        want = "mma" if 1 <= lq <= 32 and D <= 64 and t <= 1024 else "simt"
        same = torch.equal(out, again)
        ok = (err <= tol and empty_ok and out.shape == (K,) and same
              and route == want and launched == 2)
        worst = max(worst, err)
        if route == "mma":
            if (D, lq) == (32, 24):
                per_block.add(mma_docs_per_block(K))
            route += f", {mma_docs_per_block(K)} docs a block"
        log(f"  bitsim {name} ({route} kernel): max_abs_err={err:.3g} "
            f"tol={tol:.3g} zero-length docs "
            f"{'match' if empty_ok else 'DIFFER'}, same bits twice {same}, "
            f"{launched} launches for 2 calls -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"bitsim {name}")
        if row is None:                       # the bit filter's own shape
            n_bytes, tc_ops, fp32_ops = bitsim_work(q, docs, lens_t)
            row = timings(lambda: bitsim(q, qm, docs, lens_t),
                          lambda: bitsim_ref(q, qm, docs, lens_t), None,
                          n_bytes, tc_ops, FP16_TC_FLOPS_S)
            row["bound_fp32_ops_ms"] = bound_ms(n_bytes, fp32_ops)[0]
            log(timing_line(
                f"bitsim timing (K={K}, T={t}, W={docs.shape[2]}, D={D}, "
                f"Lq={lq}, {int(lens_t.clamp(0, t).sum())} valid tokens, "
                f"{route} kernel; no one PyTorch call computes a "
                f"length-masked max-then-sum; bound by fp32 operations "
                f"{row['bound_fp32_ops_ms']:.4f} ms)", row))
    if per_block != {1, 2, 4, 8}:
        failures.append(f"bitsim: the mma kernel ran at {sorted(per_block)}"
                        " docs a block, not at each of 1, 2, 4 and 8")
    row["max_abs_err"] = worst
    return row


def time_bitsim_path(dev, ks, failures) -> dict:
    """bitsim on the card at the K the bit filter called it at: the logged
    calls' min, median and max, on the slice's distribution (Lq=24, T=180,
    W=1, D=32), each first held to the plain version; the path's calls
    summed on the device, each at the nearest of them."""
    from repro_torch.kernels.bitsim.ops import bitsim
    from repro_torch.kernels.bitsim.ref import bitsim_ref
    rng = np.random.default_rng(1)
    T = 180
    timed = sorted({int(v) for v in np.percentile(ks, [0, 50, 100],
                                                   method="nearest")})
    q, qm, docs, lens = bitsim_inputs(
        dev, rng, max(timed), T, 24, 32,
        np.clip((rng.pareto(2.5, max(timed)) + 1) * 36, 8, T))
    ref = bitsim_ref(q, qm, docs, lens)
    tol = REL_TOL * max(1.0, float(ref.abs().max()))
    sizes = {}
    for k in timed:
        err = float((bitsim(q, qm, docs[:k], lens[:k]) - ref[:k]).abs().max())
        if err > tol:
            failures.append(f"bitsim path K={k}: err {err:.3g} > {tol:.3g}")
        n_bytes, tc_ops, _ = bitsim_work(q, docs[:k], lens[:k])
        sizes[k] = {"device_ms": device_ms(
                        lambda k=k: bitsim(q, qm, docs[:k], lens[:k])),
                    "bound_ms": bound_ms(n_bytes, tc_ops,
                                         FP16_TC_FLOPS_S)[0],
                    "max_abs_err": err}
    near = [min(sizes, key=lambda s: abs(s - k)) for k in ks]
    out = {"path_sizes": sizes,
           "path_device_ms_sum": sum(sizes[s]["device_ms"] for s in near),
           "path_bound_ms_sum": sum(sizes[s]["bound_ms"] for s in near)}
    log("  bitsim on the device at the path's K: " + ", ".join(
        f"K={k} {v['device_ms']:.4f} ms (bound {v['bound_ms']:.4f})"
        for k, v in sizes.items()) + f"; the path's {len(ks)} calls "
        f"{out['path_device_ms_sum']:.4f} ms on the device, bound "
        f"{out['path_bound_ms_sum']:.4f} ms")
    return out


def check_fdescan(dev, rng, failures) -> dict:
    import torch

    from repro_torch.kernels.fdescan.ops import fdescan, kernel_for
    from repro_torch.kernels.fdescan.ref import fdescan_ref
    # the slice's case and the tensor-core kernel's edges (B 1/33/64/70,
    # ragged N, D 128/256), then the SIMT kernel's (an fp32 table, D=100)
    cases = [("slice B=64 N=1,000,000 D=256 fp16", 64, N_DOCS, 256, True),
             ("B=1 N=1000 D=256 fp16", 1, 1000, 256, True),
             ("B=33 N=1037 D=128 fp16", 33, 1037, 128, True),
             ("B=70 N=3001 D=256 fp16", 70, 3001, 256, True),
             ("B=8 N=300 D=100 fp32", 8, 300, 100, False),
             ("B=8 N=300 D=100 fp16", 8, 300, 100, True)]
    want = {True: "wgmma", False: "simt"}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    row = None
    worst = 0.0
    for name, B, N, D, fp16 in cases:
        q = torch.tensor(rng.standard_normal((B, D)).astype(np.float32),
                         device=dev)
        docs = 0.1 * torch.randn(N, D, device=dev, generator=gen)
        if fp16:
            docs = docs.half()
        out = fdescan(q, docs)
        ref = fdescan_ref(q, docs)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = REL_TOL * max(1.0, float(ref.abs().max()))
        route = kernel_for(q, docs)
        ok = (err <= tol and out.shape == (B, N)
              and route == want[fp16 and D % 8 == 0])
        worst = max(worst, err)
        log(f"  fdescan {name} ({route} kernel): max_abs_err={err:.3g} "
            f"tol={tol:.3g} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"fdescan {name}")
        if row is None:
            # bound: the table and q read once, the scores written once;
            # the tensor cores' two fp16 passes (q in two parts)
            docs32 = docs.float()
            row = timings(lambda: fdescan(q, docs),
                          lambda: fdescan_ref(q, docs),
                          lambda: torch.matmul(q, docs32.T),
                          4 * B * D + docs.element_size() * N * D + 4 * B * N,
                          2 * 2 * B * N * D, FP16_TC_FLOPS_S)
            del docs32
            log(timing_line(f"fdescan timing (B={B}, N={N}, D={D}, fp16 "
                            f"table; library torch.matmul on an fp32 copy)",
                            row))
        del q, docs, out, ref
    torch.cuda.empty_cache()
    row["max_abs_err"] = worst
    return row


def check_gather_pack(dev, rng, failures) -> dict:
    """A copy has no rounding: the kernel must give the plain version's
    bytes exactly, pad rows included."""
    import torch

    from repro_torch.kernels.gather_pack.ops import gather_pack
    from repro_torch.kernels.gather_pack.ref import gather_pack_ref
    T = 180
    real = np.clip((rng.pareto(2.5, 1000) + 1) * 36, 8, T).astype(np.int64)
    cases = [  # name, token counts of the K docs, D, pool dtype
        ("slice K=1000 T=180 D=32 fp16", real, 32, torch.float16),
        ("K=1000 D=32 fp32", real, 32, torch.float32),
        ("K=1000 D=32 int8 (1-byte elements)", real, 32, torch.int8),
        ("K=300 D=7 int8 (7-byte rows)", rng.integers(0, T + 1, 300), 7,
         torch.int8),
        ("K=1000 D=20 fp16 (40-byte rows)", real, 20, torch.float16),
        ("K=37 all-pad doc and a full one", np.r_[0, T, rng.integers(
            0, T + 1, 35)], 32, torch.float16),
        ("K=1 D=32 fp16", np.array([57]), 32, torch.float16),
    ]
    row = None
    worst = 0.0
    for name, lens, D, dtype in cases:
        K = len(lens)
        R = int(lens.sum())
        # the rerank's order: a query's docs lie anywhere in the arena
        first = np.zeros(K, np.int64)
        np.cumsum(lens[:-1], out=first[1:])
        perm = rng.permutation(K)
        steps = np.arange(T)
        idx_np = np.where(steps[None, :] < lens[perm, None],
                          first[perm, None] + steps[None, :], -1)
        if dtype == torch.int8:
            pool = torch.tensor(rng.integers(-128, 128, (R, D)),
                                dtype=dtype, device=dev)
        else:
            pool = torch.tensor(rng.standard_normal((R, D)), dtype=dtype,
                                device=dev)
        idx = torch.tensor(idx_np.astype(np.int32), device=dev)
        out = gather_pack(pool, idx)
        ref = gather_pack_ref(pool, idx)
        torch.cuda.synchronize()
        same = out.shape == ref.shape and torch.equal(
            out.view(torch.uint8), ref.view(torch.uint8))
        err = float((out.float() - ref.float()).abs().max()) \
            if out.shape == ref.shape else float("inf")
        worst = max(worst, err)
        log(f"  gather_pack {name}: pool {R} rows, max_abs_err={err:.3g}, "
            f"{'bytes equal' if same else 'bytes DIFFER'} -> "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            failures.append(f"gather_pack {name}")
        if row is None:                       # the rerank's own shape
            # one library call for the same function: index_select over
            # the pool with a zero row appended and -1 mapped to it
            padded = torch.cat([pool, pool.new_zeros(1, D)])
            flat = torch.where(idx >= 0, idx, R).view(-1).long()
            elt = pool.element_size()
            n_valid = int((idx >= 0).sum())
            n_bytes = K * T * D * elt + n_valid * D * elt + 4 * K * T
            row = timings(lambda: gather_pack(pool, idx),
                          lambda: gather_pack_ref(pool, idx),
                          lambda: torch.index_select(padded, 0, flat),
                          n_bytes, 0)
            log(timing_line(
                f"gather_pack timing (K={K}, T={T}, D={D} fp16, {n_valid} "
                f"valid rows, {n_bytes / 1e6:.2f} MB moved; library "
                f"torch.index_select)", row))
    row["max_abs_err"] = worst
    return row


def check_flash_decode(dev, rng, failures) -> dict:
    """Every dtype, Dh and G the kernel takes, ragged lengths with 1, S and
    0, S no multiple of the split; the other LMs' decode shapes (granite's
    G 2 over KV 8, qwen2's G 7 over KV 2, llama4's G 5 over KV 8 at Dh
    128); then each decode path's first step (SmolLM's and the three of
    [moe], at the shapes their configs give) and decode_32k's context,
    timed. fp32 within REL_TOL x max(1, |ref|);
    bf16/fp16 within one ulp of the output dtype."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode.ops import flash_decode, split_slots
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    ulp = {torch.float32: REL_TOL, torch.bfloat16: 2**-7,
           torch.float16: 2**-10}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def inputs(b, s, kv, g, dh, dtype):
        q, kc, vc = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((b, kv, g, dh), (b, s, kv, dh),
                                   (b, s, kv, dh)))
        return q, kc, vc

    cases = [(f"B=4 S=300 KV=3 G={g} Dh={dh} {str(dt).split('.')[-1]} "
              f"lens 1,S,0,123", 4, 300, 3, g, dh, dt, [1, 300, 0, 123])
             for dt in ulp for dh in (16, 32, 64, 128) for g in (1, 3, 8)]
    cases += [(f"B=4 S=300 KV={kv} G={g} Dh={dh} {str(dt).split('.')[-1]} "
               f"lens 1,S,0,123 ({arch})", 4, 300, kv, g, dh, dt,
               [1, 300, 0, 123])
              for dt in ulp for kv, g, dh, arch in (
                  (8, 2, 64, "granite"), (2, 7, 64, "qwen2"),
                  (8, 5, 128, "llama4"))]
    # each decode path's first step (SmolLM's, then [moe]'s, at the shapes
    # its config gives), each timed under its row suffix; decode_32k's
    # context
    timed = {"decode_32k": "_32k"}
    for arch, (_, prompt, steps) in {LM: (None, PROMPT_LEN, DECODE_STEPS),
                                     **MOE_DECODES}.items():
        c = get_config(arch)
        path = "path" if arch == LM else f"path {arch}"
        timed[path] = "" if arch == LM else "_" + arch.split("-")[0]
        s_, kv, g = prompt + steps, c.n_kv_heads, c.n_heads // c.n_kv_heads
        cases.append((f"{path} B={DECODE_BATCH} S={s_} KV={kv} G={g} "
                      f"Dh={c.head_dim} bf16 lens {prompt + 1}", DECODE_BATCH,
                      s_, kv, g, c.head_dim, torch.bfloat16,
                      [prompt + 1] * DECODE_BATCH))
    cases += [("decode_32k B=8 S=32768 KV=3 G=3 Dh=64 bf16 lens S", 8, 32_768,
               3, 3, 64, torch.bfloat16, [32_768] * 8)]
    row: dict = {}
    worst = 0.0
    for name, b, s, kv, g, dh, dtype, lens in cases:
        q, kc, vc = inputs(b, s, kv, g, dh, dtype)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        before = flash_decode.launches
        out = flash_decode(q, kc, vc, lens_t)
        again = flash_decode(q, kc, vc, lens_t)
        one_launch = flash_decode.launches == before + 2
        ref = flash_decode_ref(q, kc, vc, lens_t)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = ulp[dtype] * max(1.0, float(ref.float().abs().max()))
        same = torch.equal(out, again)      # the fixed combine order
        ok = (err <= tol and out.shape == ref.shape and out.dtype == dtype
              and same and one_launch)
        worst = max(worst, err)
        split, n_splits = split_slots(s, b, sms)
        log(f"  flash_decode {name} ({n_splits} splits of {split}): "
            f"max_abs_err={err:.3g} tol={tol:.3g}, same bits twice "
            f"{same} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash_decode {name}")
        key = timed.get(name.split(" B=")[0])
        if key is None:
            continue
        # one library call for the same function: SDPA over the same cache,
        # its (B, KV, S, Dh) operands strided views of it (made inside the
        # timed call, no copy), q as (B, H, 1, Dh), a (B, 1, 1, S) mask
        mask = (torch.arange(s, device=dev)[None, :]
                < lens_t[:, None])[:, None, None, :]
        q4 = q.reshape(b, kv * g, 1, dh)

        def sdpa():
            return F.scaled_dot_product_attention(
                q4, kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=mask,
                enable_gqa=True)
        lib_err = float((sdpa().reshape(out.shape).float()
                         - ref.float()).abs().max())
        n = int(lens_t.clamp(0, s).sum())
        elt = kc.element_size()
        n_bytes = 2 * kv * n * dh * elt + 2 * b * kv * g * dh * elt + 4 * b
        row.update(timings(lambda: flash_decode(q, kc, vc, lens_t),
                           lambda: flash_decode_ref(q, kc, vc, lens_t), sdpa,
                           n_bytes, 4 * kv * g * n * dh, suffix=key))
        log(timing_line(
            f"flash_decode timing ({name}, {n_bytes / 1e6:.2f} MB of k/v "
            f"read; library SDPA with enable_gqa, a boolean mask and strided "
            f"cache views, its max_abs_err {lib_err:.3g})", row, key))
        del q, kc, vc, out, again, ref, mask, q4
    torch.cuda.empty_cache()
    row["max_abs_err"] = worst
    return row


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

class StageClock:
    """Wall seconds spent in a path's stages (the query path's, the decode
    step's), read by wrapping the functions the path calls: the port itself
    carries no instrumentation.
    Each key also gets the calling thread's CPU seconds (``key + "_cpu"``):
    wall well above CPU means the thread waited, e.g. for the GIL."""

    def __init__(self):
        self.s = defaultdict(float)
        self.tiles: set = set()
        self.mode = ""                   # the path being run, for maxsim_k
        self.maxsim_k: dict = defaultdict(list)   # K of each maxsim call
        self.maxsim_kernels: dict = defaultdict(int)   # kernel_for's names
        self.bitsim_k: dict = defaultdict(list)   # K of each bitsim call
        self.bitsim_kernels: dict = defaultdict(int)
        self._wrapped: list = []

    def wrap(self, owner, name, key, sync=False):
        import torch
        orig = getattr(owner, name)
        self._wrapped.append((owner, name, orig))

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

    def restore(self):
        """Undo every ``wrap``, the last first."""
        while self._wrapped:
            setattr(*self._wrapped.pop())

    def install(self):
        from repro_torch.core import prefetcher, rerank
        from repro_torch.core.fde import FDEEncoder
        from repro_torch.pipeline import backends, pipeline
        from repro_torch.storage import batch_io, io_engine
        from repro_torch.storage.batch_io import BatchReadPlan, BatchReadResult
        from repro_torch.storage.io_engine import StorageTier
        # the resident tables the new modes build from the blob
        self.wrap(pipeline, "bits_from_layout", "bit_table_build")
        self.wrap(pipeline, "fde_from_layout", "fde_table_build", sync=True)
        # fde/cascade candidate generation, split into disjoint parts
        self.wrap(backends.FDEBackend, "_fde_candidates", "fde_candidates",
                  sync=True)
        self.wrap(FDEEncoder, "encode_queries", "fde_encode", sync=True)
        self.wrap(backends, "fdescan", "fdescan_kernel", sync=True)
        self.wrap(backends, "topk_stable", "fde_topk", sync=True)
        # bitvec/cascade bit filter: the host gather and the kernel
        self.wrap(StorageTier, "read_bits", "read_bits")
        self.wrap(backends, "bitsim", "bitsim_kernel", sync=True)
        self.wrap(prefetcher.ANNPrefetcher, "run_batch", "prefetch_total")
        # run_batch's two np.isin uses: the per-query hit mask and the
        # cross-query reuse check (``contains``, itself one np.isin), which
        # are the only np.isin calls on the path
        self.wrap(np, "isin", "isin_total")
        self.wrap(BatchReadPlan, "contains", "reuse_check")
        self.wrap(prefetcher, "search_two_phase", "candidate_gen", sync=True)
        self.wrap(backends, "search", "candidate_gen", sync=True)
        self.wrap(StorageTier, "read_batch", "io_plan_submit")
        # the rerank's arrival barrier: the wait for a run's host staging,
        # then (inside it) the run's host->device copy of the pool rows
        self.wrap(BatchReadResult, "ensure_query", "ensure")
        self.wrap(BatchReadResult, "ensure_rows", "ensure")
        self.wrap(batch_io, "upload", "h2d_pool", sync=True)
        self.wrap(io_engine, "upload", "h2d_pool", sync=True)
        self.wrap(backends, "rerank_query", "rerank_total")
        self.wrap(rerank, "_maxsim_np", "maxsim_call")
        self.wrap(rerank, "gather_pack", "gather_pack_kernel", sync=True)
        self.wrap(rerank, "maxsim", "maxsim_kernel", sync=True)
        # where the tiles that reach maxsim lie, in which dtype, how many
        # docs each call scores and which of maxsim's kernels it launches
        from repro_torch.kernels.maxsim.ops import kernel_for
        timed = rerank.maxsim

        def watched(q, q_mask, docs, doc_lens):
            self.tiles.add((docs.device.type, str(docs.dtype)))
            self.maxsim_k[self.mode].append(docs.shape[0])
            self.maxsim_kernels[kernel_for(q, docs)] += 1
            return timed(q, q_mask, docs, doc_lens)
        rerank.maxsim = watched
        # the same for the bit filter's bitsim calls
        from repro_torch.kernels.bitsim import ops as bitsim_ops
        timed_bits = backends.bitsim

        def watched_bits(q, q_mask, docs_packed, doc_lens):
            self.bitsim_k[self.mode].append(docs_packed.shape[0])
            self.bitsim_kernels[bitsim_ops.kernel_for(q, docs_packed)] += 1
            return timed_bits(q, q_mask, docs_packed, doc_lens)
        backends.bitsim = watched_bits

    def split(self, wall: float) -> dict:
        s = self.s
        out = {
            "candidate_gen_s": s["candidate_gen"],
            # the rerank: waiting for the staging threads, the pool's
            # host->device copies (every path here is coalesced, so all of
            # them are issued inside the barrier), the gather_pack and
            # maxsim launches, the rest of each MaxSim call (index table,
            # query H2D, scores D2H) and the per-query host loop
            "host_staging_wait_s": s["ensure"] - s["h2d_pool"],
            "h2d_pool_s": s["h2d_pool"],
            "gather_pack_kernel_s": s["gather_pack_kernel"],
            "maxsim_kernel_s": s["maxsim_kernel"],
            "maxsim_call_other_s": (s["maxsim_call"] - s["gather_pack_kernel"]
                                    - s["maxsim_kernel"]),
            "rerank_host_s": (s["rerank_total"] - s["ensure"]
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
            # fde/cascade: the FDE query encode, the scan, the stable top-k
            # over (B, N), and the rest of candidate generation (the D2H
            # of the candidates)
            "fde_encode_s": s["fde_encode"],
            "fdescan_kernel_s": s["fdescan_kernel"],
            "fde_topk_s": s["fde_topk"],
            "fde_candidates_other_s": (s["fde_candidates"] - s["fde_encode"]
                                       - s["fdescan_kernel"] - s["fde_topk"]),
            # bitvec/cascade: the bit-lane gather from the resident table and
            # the bitsim launches (their H2D and the host survivor selection
            # stay in unattributed)
            "read_bits_s": s["read_bits"],
            "bitsim_kernel_s": s["bitsim_kernel"],
        }
        out["unattributed_s"] = wall - sum(
            v for k, v in out.items() if not k.endswith("_cpu_s"))
        return out


def counters():
    from repro_torch.kernels.bitsim.ops import bitsim
    from repro_torch.kernels.fdescan.ops import fdescan
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.gather_pack.ops import gather_pack
    from repro_torch.kernels.ivf_scan.ops import centroid_scores
    from repro_torch.kernels.maxsim.ops import maxsim
    return {"maxsim": maxsim, "ivf_scan": centroid_scores, "bitsim": bitsim,
            "fdescan": fdescan, "gather_pack": gather_pack,
            "flash_decode": flash_decode}


# the kernels each path must launch: every retrieval mode's rerank packs its
# tiles with gather_pack, one launch before each maxsim launch; the LM's
# decode steps launch flash_decode once per layer
IVF_RERANK = ("ivf_scan", "gather_pack", "maxsim")
PATH_KERNELS = {"espn": IVF_RERANK, "gds": IVF_RERANK, "mmap": IVF_RERANK,
                "swap": IVF_RERANK, "dram": IVF_RERANK,
                "bitvec": ("ivf_scan", "bitsim", "gather_pack", "maxsim"),
                "fde": ("fdescan", "gather_pack", "maxsim"),
                "cascade": ("fdescan", "bitsim", "gather_pack", "maxsim"),
                "cspn": IVF_RERANK,
                "decode": ("flash_decode",)}
RETRIEVAL_MODES = [m for m in PATH_KERNELS if m != "decode"]


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


def restore_counts(saved: dict):
    for k, fn in counters().items():
        fn.launches = saved[k]


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


#: the main path's artifacts, for the serving phases that follow it (no
#: rebuild): corpus, index, layout, config, resident tables, and each
#: mode's first response (``FIRST``)
CTX: dict = {}
FIRST: dict = {}


def run_batches(pipe, corpus, batches, bs, clock, failures, what):
    from repro_torch.core.metrics import mrr_at_k, recall_at_k
    ranked, hits = [], []
    clock.mode = what
    for i in range(batches):
        sl = slice(i * bs, (i + 1) * bs)
        clock.s.clear()
        t0 = time.perf_counter()
        resp = pipe.search(corpus.queries_cls[sl], corpus.queries_bow[sl],
                           corpus.query_lens[sl])
        wall = time.perf_counter() - t0
        check_ranked(resp, corpus.n_docs, failures, f"{what} batch {i}")
        if i == 0:
            FIRST[what] = resp
        ranked += [r.doc_ids for r in resp.ranked]
        hits.append(resp.breakdown.hit_rate)
        split = {k: round(v, 4) for k, v in clock.split(wall).items() if v}
        log(f"  {what} batch {i}: wall {wall:.3f} s {json.dumps(split)}")
        log(f"  {what} batch {i}: simulated breakdown "
            f"{json.dumps(resp.breakdown.as_dict())}")
    qrels = corpus.qrels[:batches * bs]
    return {"mrr@10": mrr_at_k(ranked, qrels, 10),
            "recall@100": recall_at_k(ranked, qrels, 100),
            "mean_hit_rate": float(np.mean(hits)),
            # the first batch alone, the queries every mode answers
            "batch0": {"mrr@10": mrr_at_k(ranked[:bs], qrels[:bs], 10),
                       "recall@100": recall_at_k(ranked[:bs], qrels[:bs],
                                                 100)}}


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


def tf32_off(failures, when):
    """The FDE encoder's sign tests and the plain products must run in full
    fp32: TF32 keeps about three decimal digits."""
    import torch
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        failures.append(f"TF32 is on for fp32 products ({when})")


def side_mode(cfg, mode, idx, layout, corpus, dev, clock, failures, out,
              tables):
    """One batch through ``mode`` on the espn pipeline's corpus and index
    and on ``layout``, via ``Pipeline.from_artifacts``; a side table another
    mode built already is handed down, one not built yet is built by the
    entry point (its build time read from the clock)."""
    import dataclasses

    from repro_torch.pipeline import Pipeline
    mcfg = dataclasses.replace(cfg, retrieval=dataclasses.replace(
        cfg.retrieval, mode=mode))
    clock.s.clear()
    t0 = time.perf_counter()
    with Pipeline.from_artifacts(mcfg, index=idx, layout=layout,
                                 corpus=corpus, device=dev, **tables) as p:
        for name, attr, key in (("bits", "bits", "bit_table_build"),
                                ("fde", "fde", "fde_table_build")):
            table = getattr(p.tier, attr)
            if table is not None and name not in tables:
                tables[name] = table
                where = (table.vecs.device if name == "fde" else "the host")
                log(f"  {name} table: {table.nbytes / 2**20:.1f} MiB on "
                    f"{where}, built in {clock.s[key]:.2f} s "
                    f"(CPU {clock.s[key + '_cpu']:.2f} s)")
                out[f"{name}_table"] = {"bytes": table.nbytes,
                                        "build_s": clock.s[key]}
        log(f"  {mode} pipeline assembled in "
            f"{time.perf_counter() - t0:.2f} s")
        reset_counts()
        out[mode] = run_batches(p, corpus, 1, BATCH_SIZE, clock, failures,
                                mode)
        out[mode]["launches"] = read_counts()
        if mode in ("fde", "cascade"):
            out[mode]["candidate_gen_bytes"] = p.backend.candidate_gen_bytes()
        out[mode]["memory_resident_bytes"] = p.tier.memory_resident_bytes()


_POOL_JOB: tuple = ()


def _pool_range(rng_):
    """Worker: pool docs ``d0..d1`` of the forked parent's corpus into the
    shared output (the package's sequential ``pool_corpus`` on a slice)."""
    from repro_torch.core.pool import pool_corpus
    bow, out, k, seed = _POOL_JOB
    d0, d1 = rng_
    out[d0:d1] = np.stack(pool_corpus(bow[d0:d1], k, seed=seed))
    return d1 - d0


def pool_parallel(bow, k: int, seed: int = 0) -> list[np.ndarray]:
    """``pool_corpus(bow, k, seed)`` spread over the host's cores: a doc's
    pooled vectors depend on its own tokens only, so slices pooled apart
    concatenate to the sequential result. The workers are forked (they
    touch no CUDA) and write into one shared anonymous mapping."""
    global _POOL_JOB
    n, d = len(bow), bow[0].shape[1]
    buf = mmap.mmap(-1, max(1, n * k * d * 4))
    out = np.frombuffer(buf, np.float32, n * k * d).reshape(n, k, d)
    _POOL_JOB = (bow, out, k, seed)
    step = -(-n // 256)
    ranges = [(d0, min(n, d0 + step)) for d0 in range(0, n, step)]
    try:
        with multiprocessing.get_context("fork").Pool(os.cpu_count()) as pool:
            done = sum(pool.imap_unordered(_pool_range, ranges))
    finally:
        _POOL_JOB = ()
    if done != n:
        raise RuntimeError(f"pooled {done} of {n} docs")
    return list(out)


def cspn_mode(cfg, idx, corpus, dev, clock, failures, out):
    """The corpus pooled to POOL_K tokens a doc and packed in the
    ``fixed_stride`` layout, then one ``cspn`` batch on it with the espn
    pipeline's index (pooling changes only the BOW rows)."""
    import dataclasses

    from repro_torch.storage.layout import pack
    t0 = time.perf_counter()
    pooled = pool_parallel(corpus.bow, POOL_K, seed=cfg.storage.pool_seed)
    t_pool = time.perf_counter() - t0
    t0 = time.perf_counter()
    layout = pack(corpus.cls, pooled, dtype=np.dtype(cfg.storage.dtype),
                  block=cfg.storage.block, mode="fixed_stride",
                  pool_k=POOL_K)
    t_pack = time.perf_counter() - t0
    del pooled
    log(f"  cspn layout: {layout.n_docs} docs pooled to {POOL_K} tokens in "
        f"{t_pool:.1f} s on {os.cpu_count()} processes, packed fixed_stride "
        f"in {t_pack:.1f} s: {layout.stride_blocks} block(s) a doc, blob "
        f"{layout.nbytes / 1e9:.2f} GB on the host, resident metadata "
        f"{layout.meta_nbytes} B")
    if layout.stride_blocks != 1:
        failures.append(f"cspn: {layout.stride_blocks} blocks a doc, not 1")
    out["cspn_layout"] = {"pool_s": t_pool, "pack_s": t_pack,
                          "blob_bytes": layout.nbytes}
    ccfg = dataclasses.replace(cfg, storage=dataclasses.replace(
        cfg.storage, layout_mode="fixed_stride", pool_k=POOL_K))
    side_mode(ccfg, "cspn", idx, layout, corpus, dev, clock, failures, out,
              {})


def scan_formulations(index, corpus, failures) -> dict:
    """The cell scan's product per query (the port's ``_scan_block``)
    against the batched product it replaced (one einsum over the batch,
    whose cuBLAS kernel may change with B; defined here only to be
    timed): for each, how many of a batch of 64's queries get other
    approximate or final candidates (ids or score bits) than when searched
    alone, and ``search_two_phase``'s time at B=64 (events, median of
    10)."""
    import torch

    from repro_torch.core import ivf

    def batched_block(cell_ids, cell_vecs, cell_scale, q, probe, *, k):
        ids = cell_ids[probe]
        vf = cell_vecs[probe].float()
        if cell_scale is not None:
            vf = vf * cell_scale[probe][..., None]
        s = torch.einsum("bd,bpmd->bpm", q.float(), vf)
        s = torch.where(ids >= 0, s, ivf.NEG)
        top_s, pos = ivf.topk_stable(s.reshape(q.shape[0], -1), k)
        return top_s, torch.gather(ids.reshape(q.shape[0], -1), 1, pos)

    q = corpus.queries_cls[:BATCH_SIZE]
    delta = max(1, int(round(PREFETCH_STEP * NPROBE)))

    def search(x):
        return ivf.search_two_phase(index, x, NPROBE, K_CANDIDATES, delta)
    out, orig = {}, ivf._scan_block
    for name, block in (("per_query", orig), ("batched", batched_block)):
        ivf._scan_block = block
        try:
            got = search(q)
            differ = {"approx": 0, "final": 0}
            for b in range(len(q)):
                alone = search(q[b:b + 1])
                for phase, i in (("approx", 0), ("final", 1)):
                    differ[phase] += not (
                        torch.equal(got[i][0][b], alone[i][0][0])
                        and torch.equal(got[i][1][b], alone[i][1][0]))
            out[name] = {"queries_differing": differ,
                         "ms": time_ms(lambda: search(q), reps=10,
                                       warmup=2)}
        finally:
            ivf._scan_block = orig
    log(f"  cell scan at B={BATCH_SIZE}, queries whose candidates differ "
        f"from their own search alone, and search_two_phase ms: per-query "
        f"product {json.dumps(out['per_query'])}; the batched product it "
        f"replaced {json.dumps(out['batched'])}")
    if any(out["per_query"]["queries_differing"].values()):
        failures.append("the cell scan's candidates depend on the batch")
    return out


def main_path(dev, failures, profile=False) -> dict:
    import torch

    from repro_torch.data.synthetic import make_corpus
    from repro_torch.pipeline import (CorpusConfig, Pipeline, PipelineConfig,
                                      RetrievalConfig, StorageConfig)
    batches, bs = BATCHES, BATCH_SIZE
    # ColBERTer widths; retrieval at the paper's ESPNConfig defaults and the
    # reference's defaults for the bitvec/fde/cascade knobs, except that the
    # FDE table is scanned brute force at this size, the mutation phase's
    # grown 1,010,000 docs included (the default threshold of 100,000 docs
    # would take the IVF-over-FDEs branch, which runs no fdescan)
    cfg = PipelineConfig(
        corpus=CorpusConfig(n_docs=N_DOCS, n_queries=N_QUERIES,
                            d_cls=128, d_bow=32, max_len=180),
        storage=StorageConfig(dtype="float16", t_max=180),
        retrieval=RetrievalConfig(mode="espn", nprobe=NPROBE,
                                  k_candidates=K_CANDIDATES,
                                  prefetch_step=PREFETCH_STEP,
                                  rerank_count=None,
                                  fde_brute_threshold=2 * N_DOCS))
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
        out["scan_formulations"] = scan_formulations(idx, corpus, failures)
        cfg.retrieval.mode = "gds"
        with Pipeline.from_artifacts(cfg, index=idx, layout=pipe.layout,
                                     corpus=corpus, device=dev) as gds:
            reset_counts()
            out["gds"] = run_batches(gds, corpus, 1, bs, clock, failures,
                                     "gds")
            out["gds"]["launches"] = read_counts()
        tf32_off(failures, "before the table builds")
        tables: dict = {}
        for mode in ("mmap", "swap", "dram", "bitvec", "fde", "cascade"):
            side_mode(cfg, mode, idx, pipe.layout, corpus, dev, clock,
                      failures, out, tables)
        if tables.get("fde") is None \
                or tables["fde"].vecs.device.type != dev.type:
            failures.append("the FDE table was not built on the card")
        CTX.update(corpus=corpus, index=idx, layout=pipe.layout, cfg=cfg,
                   tables=dict(tables))
        tables.clear()
        cspn_mode(cfg, idx, corpus, dev, clock, failures, out)
        tf32_off(failures, "after the new modes")
        # every rerank of every mode packed its tiles on the card
        log(f"  tiles that reached maxsim on the path (device, dtype): "
            f"{sorted(clock.tiles)}")
        if not clock.tiles or any(d != "cuda" for d, _ in clock.tiles):
            failures.append(f"the rerank's tiles were not all on the card: "
                            f"{sorted(clock.tiles)}")
        # every maxsim launch of the path on the tensor-core kernel; the
        # sizes it is called at
        kernels = dict(clock.maxsim_kernels)
        log(f"  maxsim calls on the path by kernel: {kernels}")
        if set(kernels) != {"mma"}:
            failures.append(f"maxsim calls on the path took {kernels}, "
                            "not the tensor-core kernel alone")
        out["maxsim_kernels"] = kernels
        out["maxsim_k_calls"] = sum(clock.maxsim_k.values(), [])
        out["maxsim_k"] = {}
        for mode, ks in [("all", sum(clock.maxsim_k.values(), []))] + \
                sorted(clock.maxsim_k.items()):
            qs = np.percentile(ks, [0, 25, 50, 75, 100]).tolist()
            out["maxsim_k"][mode] = {"calls": len(ks), "quartiles": qs}
            log(f"  maxsim K over {mode}'s {len(ks)} calls: min, quartiles, "
                f"max {[round(v, 1) for v in qs]}")
        # the same for the bit filter (bitvec, cascade), and bitsim on the
        # device at the K it was called at
        kernels = dict(clock.bitsim_kernels)
        log(f"  bitsim calls on the path by kernel: {kernels}")
        if set(kernels) != {"mma"}:
            failures.append(f"bitsim calls on the path took {kernels}, "
                            "not the tensor-core kernel alone")
        out["bitsim_kernels"] = kernels
        out["bitsim_k"] = {}
        for mode, ks in [("all", sum(clock.bitsim_k.values(), []))] + \
                sorted(clock.bitsim_k.items()):
            qs = np.percentile(ks, [0, 50, 100]).tolist()
            out["bitsim_k"][mode] = {"calls": len(ks), "min_median_max": qs}
            log(f"  bitsim K over {mode}'s {len(ks)} calls: min, median, "
                f"max {[round(v, 1) for v in qs]}")
        out["bitsim_path"] = time_bitsim_path(
            dev, sum(clock.bitsim_k.values(), []), failures)
        if profile:
            profile_batch(pipe, corpus, bs)
    base = out["espn"]["batch0"]
    for mode in RETRIEVAL_MODES:
        r = out[mode]
        log(f"  {mode}: MRR@10={r['mrr@10']:.4f} "
            f"Recall@100={r['recall@100']:.4f} (espn on the same 64 queries:"
            f" {base['mrr@10']:.4f} / {base['recall@100']:.4f}) mean hit "
            f"rate {r['mean_hit_rate']:.4f} launches {r['launches']}")
        for name in PATH_KERNELS[mode]:
            if r["launches"][name] <= 0:
                failures.append(f"{mode}: kernel {name} was never launched")
        if mode in ("espn", "gds") and r["mrr@10"] <= 0.5:
            failures.append(f"{mode}: MRR@10 {r['mrr@10']:.3f} too low")
    # the reference's own quality claims, checked there at 2,000 docs
    # (tests/test_bitvec.py, tests/test_fde.py): findings here, not gates
    for mode, metric, frac in (("bitvec", "mrr@10", 0.99),
                               ("fde", "recall@100", 0.95)):
        got, want = out[mode]["batch0"][metric], frac * base[metric]
        log(f"  claim {mode} {metric} >= {frac} x espn's: {got:.4f} vs "
            f"{want:.4f} -> {'met' if got >= want else 'NOT met'}")
    return out


# ---------------------------------------------------------------------------
# phases 5-11: serving the main path's index (persist, serve, encoder,
# disk_ivf, faults, cluster, mutation)
# ---------------------------------------------------------------------------

SERVE_REQUESTS, SERVE_MAX_BATCH = 128, 32
WAIT_S = 120.0          # any one request's wait; a request not done fails
SLO_SECONDS = 3.0       # the SLO runs' offered stream
SLO_DEFAULT_MS = 50.0   # the reference's SLOPolicy and WorkloadConfig
                        # default deadline
FAULTS = dict(read_error_rate=0.05, stall_rate=0.05, corruption_rate=0.05,
              checksum=True, degrade=True, seed=0)
# the phases' own paths, each driven with the counts at 0 and read after
SERVING_KERNELS = {"persist_espn": IVF_RERANK,
                   "persist_cascade": PATH_KERNELS["cascade"],
                   "serve": IVF_RERANK, "serve_slo50": IVF_RERANK,
                   "serve_slo": IVF_RERANK,
                   "faults": IVF_RERANK,
                   "cluster_1x1_espn": IVF_RERANK,
                   "cluster_cascade": PATH_KERNELS["cascade"],
                   "cluster_espn": IVF_RERANK,
                   "cluster_serve": IVF_RERANK,
                   "cluster_failover": IVF_RERANK,
                   "cluster_gds": IVF_RERANK,
                   "cluster_autoscale": IVF_RERANK,
                   "mutation_1x1_espn": IVF_RERANK,
                   "mutation_cascade": PATH_KERNELS["cascade"],
                   "mutation_espn": IVF_RERANK,
                   "mutation_oracle_espn": IVF_RERANK,
                   "mutation_compacted_espn": IVF_RERANK,
                   "mutation_rebalanced_espn": IVF_RERANK,
                   "mutation_loaded_espn": IVF_RERANK,
                   "mutation_loaded_cascade": PATH_KERNELS["cascade"],
                   "mutation_loaded_ingest_espn": IVF_RERANK,
                   "mutation_maintained_espn": IVF_RERANK,
                   "encoder_serve": IVF_RERANK,
                   "disk_ivf_search": ("ivf_scan",)}
MUTATION_PATHS = [p for p in SERVING_KERNELS if p.startswith("mutation_")]
# the [cluster] phase: the reference's CI scale-out settings (ci.yml), at the
# main path's size
SHARDS, REPLICAS = 4, 2
CLUSTER_ESPN_QUERIES = 16   # its espn batches (64 until [recsys] and [gnn]
                            # came: a depth cut)
STRAGGLERS = dict(replica_mults=[3.0, 1.0], jitter_sigma=0.25,
                  hedge_quantile=0.95, arena_cache_mb=4000.0)
AUTOSCALE_REQUESTS = 128


def require_launches(out, failures, *paths):
    """Each of the phase's paths launched every kernel it runs."""
    for path in paths:
        if path not in out:
            failures.append(f"{path}: the path did not run")
            continue
        for name in SERVING_KERNELS[path]:
            if out[path]["launches"][name] <= 0:
                failures.append(f"{path}: kernel {name} was never launched")


def mode_cfg(cfg, mode, **sections):
    import dataclasses
    return dataclasses.replace(cfg, retrieval=dataclasses.replace(
        cfg.retrieval, mode=mode), **sections)


def first_queries(corpus, n=BATCH_SIZE):
    return (corpus.queries_cls[:n], corpus.queries_bow[:n],
            corpus.query_lens[:n])


def same_bits(want, got) -> bool:
    """Two responses equal bit for bit: ids, scores, flags and bill."""
    return (want.breakdown.as_dict() == got.breakdown.as_dict()
            and all(np.array_equal(w.doc_ids, g.doc_ids)
                    and np.array_equal(w.scores, g.scores)
                    and w.degraded == g.degraded
                    for w, g in zip(want.ranked, got.ranked)))


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def persist_phase(dev, failures, out):
    """Save the 1M-doc index, layout and resident tables (no corpus), load
    them back onto the card, and hold one espn and one cascade batch of
    the loaded pipeline to the unsaved one's bit for bit."""
    import shutil
    import tempfile

    import torch

    from repro_torch.pipeline import Pipeline
    corpus, idx, layout, cfg = (CTX[k] for k in ("corpus", "index",
                                                 "layout", "cfg"))
    tables = CTX["tables"]
    need = (layout.nbytes + idx.memory_bytes() + tables["bits"].nbytes
            + tables["fde"].nbytes)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="persist-", dir=os.path.join(ROOT, "build"))
    free = shutil.disk_usage(root).free
    log(f"  to write ~{need / 2**30:.2f} GiB; {free / 2**30:.1f} GiB free "
        f"under {os.path.relpath(root, ROOT)}")
    if free < 1.2 * need:
        failures.append(f"persist: {free / 2**30:.1f} GiB free, "
                        f"{need / 2**30:.2f} GiB needed")
        return
    try:
        with Pipeline.from_artifacts(mode_cfg(cfg, "cascade"), index=idx,
                                     layout=layout, device=dev,
                                     **tables) as saved:
            t0 = time.perf_counter()
            saved.save(root)
            t_save = time.perf_counter() - t0
        n_bytes = dir_bytes(root)
        files = sorted(f for f in os.listdir(root) if f.endswith(".npz"))
        t0 = time.perf_counter()
        loaded = Pipeline.load(root, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"  saved {files} + config.json: {n_bytes:,} bytes in {t_save:.2f} "
        f"s; loaded onto {loaded.device} in {t_load:.2f} s")
    if files != ["bits.npz", "fde.npz", "index.npz", "layout.npz"]:
        failures.append(f"persist: the directory held {files}")
    if loaded.device.type != "cuda" or loaded.tier.fde.vecs.device.type \
            != "cuda":
        failures.append("persist: the loaded index or FDE table is not on "
                        "the card")
    out["persist"] = {"bytes": n_bytes, "save_s": t_save, "load_s": t_load,
                      "free_bytes": free}
    espn = loaded.with_mode("espn")
    for mode, pipe in (("espn", espn), ("cascade", loaded)):
        reset_counts()
        got = pipe.search(*first_queries(corpus))
        out[f"persist_{mode}"] = {"launches": read_counts()}
        same = same_bits(FIRST[mode], got)
        log(f"  loaded {mode} batch of {BATCH_SIZE} vs the unsaved "
            f"pipeline's: ids, scores and bill "
            f"{'equal bit for bit' if same else 'DIFFER'}; launches "
            f"{out[f'persist_{mode}']['launches']}")
        if not same:
            failures.append(f"persist: loaded {mode} differs from unsaved")
    loaded.close()
    CTX["served"] = espn          # the serve phase's pipeline
    require_launches(out, failures, "persist_espn", "persist_cascade")


def answers_vs_alone(reqs, want):
    """(max score diff, swapped ids, other id differences) of served
    requests against ``search`` of each query alone."""
    worst, swaps, bad = 0.0, 0, 0
    for r, w in zip(reqs, want):
        resp = type(w)(ranked=[r.result], breakdown=w.breakdown)
        d, sw, b = same_ranking(w, resp)
        worst, swaps, bad = max(worst, d), swaps + sw, bad + b
    return worst, swaps, bad


def served_queries(corpus, n=SERVE_REQUESTS):
    return [(corpus.queries_cls[i], corpus.queries_bow[i],
             int(corpus.query_lens[i])) for i in range(n)]


def serve_phase(dev, failures, out):
    """``RetrievalServer`` on the loaded espn pipeline: 128 requests
    through ``query_async``, each held to ``Pipeline.search`` of its query
    alone; then a gds server under ``SLOPolicy`` offered a Poisson stream
    at twice the static run's throughput."""
    from repro_torch.serve import workload as W
    from repro_torch.serve.scheduler import BatchPolicy
    corpus, cfg = CTX["corpus"], CTX["cfg"]
    pipe = CTX["served"]     # the encoder phase serves it again, then closes
    qs = served_queries(corpus)
    n = len(qs)
    t0 = time.perf_counter()
    want = [pipe.search(c[None], b[None], np.array([ln], np.int32))
            for c, b, ln in qs]
    log(f"  {n} single-query searches in {time.perf_counter() - t0:.2f} s")
    CTX["alone"] = want      # the encoder's and the cluster phase's servers
    reset_counts()           # are held to them too
    srv = pipe.serve(BatchPolicy(max_batch=SERVE_MAX_BATCH,
                                 max_wait_s=cfg.serve.max_wait_s))
    try:
        t0 = time.perf_counter()
        reqs = [srv.query_async(*q) for q in qs]
        late = [r.rid for r in reqs if not r.done.wait(WAIT_S)]
        wall = time.perf_counter() - t0
    finally:
        srv.shutdown()
    out["serve"] = {"launches": read_counts(), "wall_s": wall,
                    "qps": n / wall, "summary": srv.stats.summary()}
    if late or any(r.error is not None or r.shed for r in reqs):
        failures.append(f"serve: {len(late)} requests not done in "
                        f"{WAIT_S:.0f} s, "
                        f"{sum(r.error is not None for r in reqs)} failed")
        return
    # a query's answer must not depend on the batch it lands in: each
    # equals search of its query alone bit for bit
    worst, swaps, bad = answers_vs_alone(reqs, want)
    ok = worst == 0.0 and swaps == 0 and bad == 0
    log(f"  server: {n} requests in {wall:.2f} s ({n / wall:.1f} "
        f"requests/s); each against search of its query alone: max score "
        f"diff {worst:.3g}, {swaps} swapped ids, {bad} other id "
        f"differences (all must be 0) -> {'ok' if ok else 'FAIL'}")
    log(f"  server stats {json.dumps(srv.stats.summary())}")
    log(f"  server launches {out['serve']['launches']}")
    if not ok:
        failures.append("serve: answers differ from Pipeline.search")
    # the SLO runs: a gds pipeline on the same artifacts offered twice the
    # static run's throughput, under the reference's default deadline
    # (SLOPolicy.slo_ms = 50 ms) and under twice the static run's median
    # request latency (wall + device share)
    from repro_torch.pipeline import Pipeline
    s = srv.stats
    rate = 2.0 * n / wall
    for path, slo_ms in (
            ("serve_slo50", SLO_DEFAULT_MS),
            ("serve_slo", 2.0 * (s.percentile(50, sim=False)
                                 + s.percentile(50)))):
        scfg = mode_cfg(cfg, "gds")
        scfg.serve.slo_ms, scfg.serve.max_batch = slo_ms, SERVE_MAX_BATCH
        w = W.generate(W.WorkloadConfig(duration_s=SLO_SECONDS,
                                        rate_qps=rate, slo_ms=slo_ms,
                                        seed=0), corpus)
        with Pipeline.from_artifacts(scfg, index=CTX["index"],
                                     layout=CTX["layout"], device=dev) as gds:
            reset_counts()
            slo = gds.serve()
            try:
                reqs = W.replay(slo, w)
                done = W.drain(reqs, timeout_s=WAIT_S)
            finally:
                slo.shutdown()
            launches = read_counts()
        st = slo.stats
        out[path] = {"launches": launches, "slo_ms": slo_ms,
                     "offered_qps": w.offered_qps(), "offered": st.offered,
                     "shed": st.shed, "served_in_slo": st.served_in_slo,
                     "violations": st.slo_violations,
                     "shed_frac": st.shed / max(st.offered, 1),
                     "goodput_under_slo": st.goodput_under_slo(),
                     "summary": st.summary()}
        log(f"  SLO run (gds, SLOPolicy, slo {slo_ms:.1f} ms): {w.n} Poisson "
            f"arrivals at {w.offered_qps():.1f}/s over {SLO_SECONDS:.0f} s; "
            f"shed {st.shed} ({100 * st.shed / max(st.offered, 1):.1f}%), "
            f"in SLO {st.served_in_slo}, violations {st.slo_violations}, "
            f"goodput under SLO {st.goodput_under_slo():.4f}, mean batch "
            f"{st.summary()['mean_batch']}, SLO latency p50/p99 "
            f"{st.slo_percentile(50):.1f}/{st.slo_percentile(99):.1f} ms; "
            f"launches {launches}")
        if done != w.n or st.errors:
            failures.append(f"serve: SLO run finished {done} of {w.n}, "
                            f"{st.errors} errors")
    require_launches(out, failures, "serve", "serve_slo50", "serve_slo")


# phases 7-8: the encoder in the serving loop, and the disk IVF

ENCODER = "colberter"      # published widths, nothing cut
ENC_QUERIES, ENC_QUERY_LEN = 64, 32
ENC_DOCS, ENC_DOC_BATCH = 1_024, 128
ENC_AGREE = 8              # queries and docs held card vs CPU in fp32
ENC_TOL, ENC_COS = 1e-4, 0.99
ENC_REPS = 10              # timed passes (after one warm-up)


def encoder_tokens(rng, lens, seq_len, vocab) -> np.ndarray:
    """Random token ids, [CLS] (0) first, each row ``lens[i]`` long and
    padded with -1 to ``seq_len``."""
    toks = rng.integers(1, vocab, (len(lens), seq_len))
    toks[:, 0] = 0
    toks[np.arange(seq_len)[None, :] >= np.asarray(lens)[:, None]] = -1
    return toks.astype(np.int32)


def encoder_phase(dev, failures, out):
    """ColBERTer at its published widths (6 layers, d_model 768, 12 heads,
    d_ff 3,072, vocab 30,522, CLS 128, BOW 32, docs up to 180 tokens; bf16
    compute over fp32 masters; random weights from numpy seed 0) on the
    card: a batch of 64 queries of 32 tokens and 1,024 docs of the
    corpus's ragged lengths in batches of 128, timed; fp32 on the card held
    to fp32 on the CPU, bf16 to fp32 by cosine; then 128 requests through
    the loaded espn server, each query encoded on the card first (as
    ``examples/espn_serving_torch.py`` does), each answer held to
    ``search`` of its query alone."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import colberter
    from repro_torch.serve.scheduler import BatchPolicy
    corpus, cfg = CTX["corpus"], CTX["cfg"]
    pipe = CTX.pop("served")
    ecfg = get_config(ENCODER)
    rng = np.random.default_rng(0)
    params = numpy_params(colberter.param_table(ecfg), rng)
    t0 = time.perf_counter()
    model = convert.colberter_params_from_numpy(params, ecfg, dev)
    n_params = sum(p.numel() for p in model.parameters())
    queries = encoder_tokens(rng, np.full(ENC_QUERIES, ENC_QUERY_LEN),
                             ENC_QUERY_LEN, ecfg.vocab_size)
    doc_lens = np.minimum(corpus.doc_lens[:ENC_DOCS], ecfg.max_doc_len)
    docs = encoder_tokens(rng, doc_lens, ecfg.max_doc_len, ecfg.vocab_size)
    torch.cuda.synchronize()
    log(f"  {ENCODER}: {ecfg.n_layers} layers, d_model {ecfg.d_model}, "
        f"{ecfg.n_heads} heads, d_ff {ecfg.d_ff}, vocab {ecfg.vocab_size}, "
        f"CLS {ecfg.d_cls} / BOW {ecfg.d_bow}; {n_params:,} fp32 params on "
        f"{dev}, {ecfg.dtype} compute; set up in "
        f"{time.perf_counter() - t0:.1f} s")
    res = out["encoder"] = {"n_params": n_params}

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(ENC_REPS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms)), ms

    def doc_pass():
        return [colberter.encode(ecfg, model, docs[i:i + ENC_DOC_BATCH])
                for i in range(0, ENC_DOCS, ENC_DOC_BATCH)]

    torch.cuda.reset_peak_memory_stats(dev)
    q_ms, q_all = timed(lambda: colberter.encode(ecfg, model, queries))
    d_ms, d_all = timed(doc_pass)
    peak = torch.cuda.max_memory_allocated(dev)
    enc = doc_pass()
    finite = all(bool(torch.isfinite(t.float()).all()) for c, b, _ in enc
                 for t in (c, b))
    shapes = {tuple(c.shape) for c, _, _ in enc} | {
        tuple(b.shape) for _, b, _ in enc}
    res.update(query_batch_ms=q_ms, query_batch_ms_all=q_all,
               doc_pass_ms=d_ms, doc_batch_ms=d_ms / (ENC_DOCS //
                                                      ENC_DOC_BATCH),
               docs_per_s=ENC_DOCS / (d_ms / 1e3), peak_bytes=peak,
               doc_tokens=int(doc_lens.sum()))
    log(f"  {ENC_QUERIES} queries x {ENC_QUERY_LEN} tokens: {q_ms:.3f} ms a "
        f"batch (median of {ENC_REPS}); {ENC_DOCS} docs (lengths "
        f"{int(doc_lens.min())}-{int(doc_lens.max())}, mean "
        f"{doc_lens.mean():.1f}, padded to {ecfg.max_doc_len}) in batches "
        f"of {ENC_DOC_BATCH}: {d_ms:.2f} ms a pass, "
        f"{res['doc_batch_ms']:.3f} ms a batch, {res['docs_per_s']:,.0f} "
        f"docs/s; peak device memory {peak / 2**30:.2f} GiB; outputs "
        f"{sorted(shapes)} {'finite' if finite else 'NOT finite'}")
    if not finite or shapes != {(ENC_DOC_BATCH, ecfg.d_cls),
                                (ENC_DOC_BATCH, ecfg.max_doc_len,
                                 ecfg.d_bow)}:
        failures.append("encoder: outputs not finite or misshapen")

    # fp32 on the card against fp32 on the CPU, and bf16 against fp32
    f32 = ecfg.scaled(dtype=torch.float32)
    cpu_model = convert.colberter_params_from_numpy(params, f32, "cpu")
    worst, low = 0.0, 1.0
    for what, toks in (("queries", queries[:ENC_AGREE]),
                       ("docs", docs[:ENC_AGREE])):
        want = colberter.encode(f32, cpu_model, toks)
        got = colberter.encode(f32, model, toks)
        half = colberter.encode(ecfg, model, toks)
        mask = got[2]
        worst = max(worst, *(float((g.cpu() - w).abs().max())
                             for g, w in zip(got[:2], want[:2])))
        for f, h in ((got[0], half[0]), (got[1][mask], half[1][mask])):
            low = min(low, float(torch.nn.functional.cosine_similarity(
                f, h.float(), dim=-1).min()))
    del cpu_model
    ok = worst <= ENC_TOL and low >= ENC_COS
    res.update(fp32_card_vs_cpu=worst, bf16_min_cosine=low)
    log(f"  {ENC_AGREE} queries and {ENC_AGREE} docs: fp32 on the card vs "
        f"the CPU max |diff| {worst:.3g} (tol {ENC_TOL}); bf16 vs fp32 on "
        f"the card min cosine {low:.6f} (>= {ENC_COS}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("encoder: card vs CPU or bf16 vs fp32 off")

    # the encoder in the serving loop
    qs, want = served_queries(corpus), CTX["alone"]
    toks = encoder_tokens(rng, np.full(len(qs), ENC_QUERY_LEN),
                          ENC_QUERY_LEN, ecfg.vocab_size)
    with pipe:
        reset_counts()
        srv = pipe.serve(BatchPolicy(max_batch=SERVE_MAX_BATCH,
                                     max_wait_s=cfg.serve.max_wait_s))
        try:
            t0 = time.perf_counter()
            reqs = []
            for i, q in enumerate(qs):
                colberter.encode(ecfg, model, toks[i:i + 1])
                reqs.append(srv.query_async(*q))
            late = [r.rid for r in reqs if not r.done.wait(WAIT_S)]
            wall = time.perf_counter() - t0
        finally:
            srv.shutdown()
        out["encoder_serve"] = {"launches": read_counts(), "wall_s": wall,
                                "qps": len(qs) / wall,
                                "summary": srv.stats.summary()}
    del model
    if late or any(r.error is not None or r.shed for r in reqs):
        failures.append(f"encoder: {len(late)} served requests late or "
                        "failed")
        return
    worst, swaps, bad = answers_vs_alone(reqs, want)
    ok = worst == 0.0 and swaps == 0 and bad == 0
    res["serve_qps"] = len(qs) / wall
    log(f"  server with the encoder in the loop: {len(qs)} requests in "
        f"{wall:.2f} s ({len(qs) / wall:.1f} requests/s; without it "
        f"{out['serve']['qps']:.1f}); each against search of its query "
        f"alone: max score diff {worst:.3g}, {swaps} swapped ids, {bad} "
        f"other id differences -> {'ok' if ok else 'FAIL'}; launches "
        f"{out['encoder_serve']['launches']}")
    if not ok:
        failures.append("encoder: served answers differ from search alone")
    require_launches(out, failures, "encoder_serve")


DISK_NPROBE, DISK_K = NPROBE, 1_000     # the paper's nprobe, k = 1,000
DISK_CACHE_FRAC = 0.10                  # the hot-cell cache: 10% of cells
DISK_OVERLAP = 0.9                      # of k (the reference test's 18/20)


def fresh_disk(disk, cache_cells: int, centroids=None):
    """A ``DiskIVFIndex`` on the same disk image with an empty cache of
    ``cache_cells`` and zeroed stats (optionally other centroids)."""
    import dataclasses
    from collections import OrderedDict
    return dataclasses.replace(
        disk, cache_cells=cache_cells, _cache=OrderedDict(),
        stats={k: type(v)(0) for k, v in disk.stats.items()},
        centroids=disk.centroids if centroids is None else centroids)


def disk_ivf_phase(dev, failures, out):
    """The SPANN-style disk IVF over the main path's index: the postings
    packed into a host disk image (no cache, and a 10% hot-cell cache),
    the first 64 queries searched at nprobe 128, k 1,000, with the probes
    on the card (``ivf_scan``) and each query's scores one product on the
    card; held to the same search on the CPU (bills and stats exactly, ids
    up to near ties), to the in-memory search (overlap), the memory factor
    and a fully cached warm pass that bills nothing."""
    import torch

    from repro_torch.core.disk_ivf import build_disk_ivf, search_disk
    from repro_torch.core.ivf import search
    corpus, idx = CTX["corpus"], CTX["index"]
    q = corpus.queries_cls[:BATCH_SIZE]
    res = out["disk_ivf"] = {}
    hot = int(DISK_CACHE_FRAC * idx.ncells)
    builds = {}
    for cells in (0, hot):
        t0 = time.perf_counter()
        builds[cells] = build_disk_ivf(idx, cache_cells=cells)
        res[f"build_s_cache{cells}"] = time.perf_counter() - t0
    disk, cached = builds[0], builds[hot]
    same_image = disk.blob.tobytes() == cached.blob.tobytes()
    res.update(blob_bytes=int(disk.blob.nbytes), cache_cells=hot,
               memory_bytes=disk.memory_bytes(),
               memory_bytes_cached=cached.memory_bytes(),
               index_memory_bytes=idx.memory_bytes())
    log(f"  disk image {disk.blob.nbytes:,} bytes on the host "
        f"({idx.ncells} cells, built in {res['build_s_cache0']:.2f} s; with "
        f"a {hot}-cell cache in {res[f'build_s_cache{hot}']:.2f} s, the "
        f"same image: {same_image}); resident {disk.memory_bytes():,} / "
        f"{cached.memory_bytes():,} bytes (no cache / cached) vs the "
        f"in-memory index's {idx.memory_bytes():,}")

    def run(d, what):
        t0 = time.perf_counter()
        got = search_disk(d, q, DISK_NPROBE, DISK_K)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res[f"{what}_wall_s"] = wall
        res[f"{what}_io_s"] = got[2]
        log(f"  {what}: batch of {len(q)} in {wall:.3f} s, simulated I/O "
            f"{got[2] * 1e3:.3f} ms, stats {json.dumps(d.stats)}")
        return got

    reset_counts()
    s_card, i_card, io_card = run(disk, "cold")
    launches = read_counts()
    cpu = fresh_disk(disk, 0, disk.centroids.cpu())
    s_cpu, i_cpu, io_cpu = run(cpu, "cpu")
    _, i_mem = search(idx, q, DISK_NPROBE, DISK_K)
    i_mem = i_mem.cpu().numpy()
    overlap = min(len(set(a.tolist()) & set(b.tolist()) - {-1})
                  for a, b in zip(i_card, i_mem))
    worst, swaps, bad = 0.0, 0, 0
    for b in range(len(q)):
        worst = max(worst, float(np.abs(s_card[b] - s_cpu[b]).max()))
        for j in np.nonzero(i_card[b] != i_cpu[b])[0]:
            swaps += 1
            bad += not any(0 <= n < DISK_K and i_cpu[b][n] == i_card[b][j]
                           and abs(s_cpu[b][n] - s_cpu[b][j]) <= AGREE_TOL
                           for n in (j - 1, j + 1))
    same_bill = io_card == io_cpu and disk.stats == cpu.stats
    res.update(card_vs_cpu={"max_score_diff": worst, "swaps": swaps,
                            "other": bad, "same_bill": same_bill},
               min_overlap=overlap)
    ok = same_bill and worst <= AGREE_TOL and bad == 0 and same_image
    log(f"  card vs CPU: bill and stats {'equal' if same_bill else 'DIFFER'}"
        f", max score diff {worst:.3g}, {swaps} swapped ids, {bad} other id "
        f"differences -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("disk_ivf: the card's search differs from the CPU's")
    ok = overlap >= DISK_OVERLAP * DISK_K
    log(f"  overlap with the in-memory search: at least {overlap} of "
        f"{DISK_K} ids a query (>= {DISK_OVERLAP * DISK_K:.0f}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("disk_ivf: overlap with the in-memory search")
    ok = cached.memory_bytes() < idx.memory_bytes() / 20
    log(f"  memory factor {idx.memory_bytes() / cached.memory_bytes():.1f}x "
        f"with the cache (> 20) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("disk_ivf: resident bytes not below 1/20")
    for what in ("hot_cold", "hot_warm"):
        run(cached, what)
    full = fresh_disk(disk, idx.ncells)
    for what in ("full_cold", "full_warm"):
        run(full, what)
    ok = res["full_warm_io_s"] == 0.0 and full.stats["cache_hits"] > 0
    log(f"  every cell cached: warm pass bills {res['full_warm_io_s']} s "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("disk_ivf: the fully cached pass billed I/O")
    out["disk_ivf_search"] = {"launches": launches}
    log(f"  launches {launches}")
    require_launches(out, failures, "disk_ivf_search")


def faults_phase(dev, failures, out):
    """The espn pipeline with seeded faults: the checksum pass over the
    layout, two batches (degraded queries launch no maxsim), a batch whose
    every read fails, and one traced server batch exported to Perfetto."""
    import tempfile

    from repro_torch.kernels.maxsim.ops import maxsim as maxsim_op
    from repro_torch.obs import analyze_trace
    from repro_torch.pipeline import Pipeline, backends
    from repro_torch.storage.faults import FaultConfig, add_checksums
    corpus, idx, layout, cfg = (CTX[k] for k in ("corpus", "index",
                                                 "layout", "cfg"))
    t0 = time.perf_counter()
    add_checksums(layout)
    t_sum = time.perf_counter() - t0
    log(f"  crc32 of {layout.n_docs:,} records ({layout.nbytes / 2**30:.2f} "
        f"GiB) in {t_sum:.2f} s")
    out["faults"] = {"checksum_s": t_sum}
    # each query's maxsim launches, read around its rerank
    per_query = []
    orig = backends.rerank_query

    def counted(*a, **kw):
        n0 = maxsim_op.launches
        res = orig(*a, **kw)
        per_query.append((res.degraded, maxsim_op.launches - n0))
        return res
    backends.rerank_query = counted
    try:
        fcfg = mode_cfg(cfg, "espn", faults=FaultConfig(**FAULTS))
        with Pipeline.from_artifacts(fcfg, index=idx, layout=layout,
                                     device=dev) as p:
            reset_counts()
            resps = [p.search(corpus.queries_cls[sl], corpus.queries_bow[sl],
                              corpus.query_lens[sl])
                     for sl in (slice(0, BATCH_SIZE),
                                slice(BATCH_SIZE, 2 * BATCH_SIZE))]
            out["faults"]["launches"] = read_counts()
            counters = {k: v for k, v in p.tier.stats.items()
                        if k in ("retries", "read_errors", "stalls",
                                 "replica_flaps", "corruptions_injected",
                                 "checksum_failures", "repairs",
                                 "repair_bytes", "faults_injected")}
            degraded = sum(r.breakdown.degraded_queries for r in resps)
            # one traced server batch, exported and read back; a 50 ms
            # deadline, no shedding: every request is served and each
            # violation is attributed to its dominant stage
            p.cfg.serve.slo_ms, p.cfg.serve.shed = 50.0, False
            build = os.path.join(ROOT, "build")
            os.makedirs(build, exist_ok=True)
            with tempfile.TemporaryDirectory(prefix="trace-",
                                             dir=build) as tmp:
                path = os.path.join(tmp, "faults.json")
                srv = p.serve(trace_path=path)
                try:
                    reqs = [srv.query_async(corpus.queries_cls[i],
                                            corpus.queries_bow[i],
                                            int(corpus.query_lens[i]))
                            for i in range(SERVE_MAX_BATCH)]
                    late = sum(not r.done.wait(WAIT_S) for r in reqs)
                finally:
                    srv.shutdown()
                n_events = srv.export_trace(path)
                rep = analyze_trace(path)
        all_fail = mode_cfg(cfg, "espn", faults=FaultConfig(
            read_error_rate=1.0, read_retries=0, seed=0))
        with Pipeline.from_artifacts(all_fail, index=idx, layout=layout,
                                     device=dev) as p:
            reset_counts()
            dead = p.search(*first_queries(corpus))
            dead_launches = read_counts()
    finally:
        backends.rerank_query = orig
    mx = out["faults"]["launches"]["maxsim"]
    first = per_query[:2 * BATCH_SIZE]
    ok_counts = (all(n == 0 for d, n in first if d)
                 and all(n > 0 for d, n in first if not d)
                 and mx == sum(n for _, n in first))
    log(f"  2 faulted espn batches: counters {json.dumps(counters)}, "
        f"degraded queries {degraded}; maxsim launches {mx} = those of the "
        f"{sum(not d for d, _ in first)} non-degraded queries "
        f"({'ok' if ok_counts else 'FAIL'}); launches "
        f"{out['faults']['launches']}")
    log(f"  bills {[r.breakdown.as_dict()['total_ms'] for r in resps]} ms")
    log(f"  traced server batch of {SERVE_MAX_BATCH}: {n_events} Perfetto "
        f"events; analyze_trace: requests {rep['requests']}, violations "
        f"{rep['violations']}, by stage {rep['by_stage']}")
    n_dead = dead.breakdown.degraded_queries
    ok_dead = (n_dead == BATCH_SIZE and dead_launches["maxsim"] == 0
               and dead_launches["gather_pack"] == 0
               and dead_launches["ivf_scan"] > 0)
    log(f"  every read failing: {n_dead} of {BATCH_SIZE} queries degraded, "
        f"launches {dead_launches} -> {'ok' if ok_dead else 'FAIL'}")
    out["faults"].update(counters=counters, degraded=degraded,
                         trace_events=n_events, all_fail=dead_launches)
    if not (ok_counts and ok_dead) or late or srv.stats.errors \
            or rep["requests"] != SERVE_MAX_BATCH:
        failures.append("faults: degraded routing or the traced run failed")
    require_launches(out, failures, "faults")


def cluster_phase(dev, failures, out):
    """The storage cluster on the main path's 1M-doc artifacts (nothing
    rebuilt or cut): a trivial cluster, 4 shards x 2 replicas in espn and
    cascade, a sharded server, gds with stragglers, hedges and the arena
    cache, a killed replica and its recovery, and the autoscaler."""
    from repro_torch.pipeline import Pipeline, get_backend
    from repro_torch.pipeline.config import ClusterConfig
    from repro_torch.serve.scheduler import BatchPolicy
    from repro_torch.storage.cluster import StorageCluster
    corpus, idx, layout, cfg = (CTX[k] for k in ("corpus", "index",
                                                 "layout", "cfg"))
    tables, q = CTX["tables"], first_queries(corpus)

    def same_answers(want, got) -> bool:
        """ids, scores and per-query byte bills equal bit for bit."""
        return (want.breakdown.bytes_read == got.breakdown.bytes_read
                and want.breakdown.dedup_bytes_saved
                == got.breakdown.dedup_bytes_saved
                and all(np.array_equal(w.doc_ids, g.doc_ids)
                        and np.array_equal(w.scores, g.scores)
                        and w.bow_bytes_read == g.bow_bytes_read
                        for w, g in zip(want.ranked, got.ranked)))

    def check(path, ok, what):
        log(f"  {path}: {what} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"cluster: {path}: {what}")

    # the espn batches here are of CLUSTER_ESPN_QUERIES (a depth cut), held
    # to a single-tier batch of the same queries, whose answers are the
    # main path's for them (a query's answer is its own alone)
    ecfg = mode_cfg(cfg, "espn")
    q16 = first_queries(corpus, CLUSTER_ESPN_QUERIES)
    with Pipeline.from_artifacts(ecfg, index=idx, layout=layout,
                                 device=dev) as single:
        want16 = single.search(*q16)
    first = {"espn": want16, "cascade": FIRST["cascade"]}
    check("cluster_single_espn", all(
        np.array_equal(w.doc_ids, g.doc_ids)
        and np.array_equal(w.scores, g.scores)
        for w, g in zip(FIRST["espn"].ranked, want16.ranked)),
        f"single-tier espn batch of {CLUSTER_ESPN_QUERIES}: ids and scores "
        f"those of the main path's batch of {BATCH_SIZE} for its queries")
    # 1) a 1x1 cluster IS the single tier: ids, scores and the whole bill
    clus = StorageCluster(layout, t_max=ecfg.storage.t_max, device=dev)
    backend = get_backend("espn")(idx, clus,
                                  ecfg.retrieval.to_espn_config())
    reset_counts()
    t0 = time.perf_counter()
    got = backend.query_batch(*q16)
    out["cluster_1x1_espn"] = {"launches": read_counts(),
                               "wall_s": time.perf_counter() - t0}
    clus.close()
    check("cluster_1x1_espn", same_bits(want16, got),
          f"1x1 cluster espn batch of {CLUSTER_ESPN_QUERIES} vs the single "
          f"tier: ids, scores and bill bit for bit (wall "
          f"{out['cluster_1x1_espn']['wall_s']:.2f} s)")
    # 2) 4 shards x 2 replicas, cascade then espn on the same shard
    #    layouts: only the clock moves
    scfg = mode_cfg(cfg, "cascade", cluster=ClusterConfig(
        n_shards=SHARDS, replication=REPLICAS))
    t0 = time.perf_counter()
    casc = Pipeline.from_artifacts(scfg, index=idx, layout=layout,
                                   device=dev, **tables)
    t_shard = time.perf_counter() - t0
    log(f"  {SHARDS} shard layouts of the {layout.n_docs:,} docs built in "
        f"{t_shard:.2f} s "
        f"({sum(sh.layout.nbytes for sh in casc.tier.shards):,} bytes)")
    out["cluster"] = {"shard_build_s": t_shard}
    # the [mutation] phase's mutable cluster starts from these shard images
    CTX["shard_layouts"] = list(zip((sh.layout for sh in casc.tier.shards),
                                    casc.tier.shard_ids))
    with casc, casc.with_mode("espn") as espn:
        for mode, pipe, qs in (("cascade", casc, q), ("espn", espn, q16)):
            reset_counts()
            t0 = time.perf_counter()
            got = pipe.search(*qs)
            path = f"cluster_{mode}"
            out[path] = {"launches": read_counts(),
                         "wall_s": time.perf_counter() - t0,
                         "critical_io_ms": got.breakdown.critical_io_s * 1e3}
            check(path, same_answers(first[mode], got)
                  and pipe.tier.stats["hedged_reads"] == 0,
                  f"{SHARDS}x{REPLICAS} {mode} batch of {len(qs[0])} vs the "
                  f"single tier: ids, scores, byte bills bit for bit; "
                  f"critical I/O {got.breakdown.critical_io_s * 1e3:.3f} ms "
                  f"(single tier "
                  f"{first[mode].breakdown.critical_io_s * 1e3:.3f}); "
                  f"wall {out[path]['wall_s']:.2f} s")
        # 3) a sharded server: every answer is search's of its query alone
        alone = CTX.pop("alone")[:SERVE_MAX_BATCH]
        reset_counts()
        srv = espn.serve(BatchPolicy(max_batch=SERVE_MAX_BATCH,
                                     max_wait_s=cfg.serve.max_wait_s))
        try:
            reqs = [srv.query_async(corpus.queries_cls[i],
                                    corpus.queries_bow[i],
                                    int(corpus.query_lens[i]))
                    for i in range(SERVE_MAX_BATCH)]
            late = sum(not r.done.wait(WAIT_S) for r in reqs)
        finally:
            srv.shutdown()
        out["cluster_serve"] = {"launches": read_counts(),
                                "summary": srv.stats.summary()}
        worst, swaps, bad = (answers_vs_alone(reqs, alone)
                             if not late and not srv.stats.errors
                             else (np.inf, 0, len(reqs)))
        check("cluster_serve", worst == 0.0 and swaps == 0 and bad == 0,
              f"sharded espn server, {SERVE_MAX_BATCH} requests vs search "
              f"of each query alone on the single tier: max score diff "
              f"{worst:.3g}, {swaps} swapped, {bad} other differences; "
              f"shard blocks {srv.stats.summary().get('shard_blocks')}")
        # 4) a killed replica: its turns fail over, nothing degrades; its
        #    recovery bills the shard image's re-sync
        espn.kill_replica(0, 0)
        reset_counts()
        got = espn.search(*q16)
        out["cluster_failover"] = {"launches": read_counts()}
        st = espn.tier.stats
        rec = espn.recover_replica(0, 0)
        image = espn.tier._shard_disk_blocks(0) * layout.block
        out["cluster_failover"].update(
            failovers=st["failovers"], degraded=got.breakdown
            .degraded_queries, recovery=rec)
        check("cluster_failover", same_answers(want16, got)
              and st["failovers"] > 0 and got.breakdown.degraded_queries == 0
              and rec["bytes"] == image == st["recovery_bytes"]
              and espn.tier.replica_status() == [[True] * REPLICAS] * SHARDS,
              f"replica 0 of shard 0 killed: {st['failovers']} failovers, "
              f"{got.breakdown.degraded_queries} degraded, answers bit for "
              f"bit; recover_replica re-synced {rec['bytes']:,} bytes in "
              f"{rec['seconds']:.3f} simulated s")
    # 5) gds on stragglers (a 3x slow primary, jitter, hedging past the
    #    0.95 quantile, a 4,000 MB arena cache): three batches of the same
    #    queries; the first hedges, the next two come from the cache
    gcfg = mode_cfg(cfg, "gds", cluster=ClusterConfig(
        n_shards=SHARDS, replication=REPLICAS, **STRAGGLERS))
    with Pipeline.from_artifacts(gcfg, index=idx, layout=layout,
                                 device=dev) as gds:
        reset_counts()
        resps, walls = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            resps.append(gds.search(*q))
            walls.append(time.perf_counter() - t0)
        st = dict(gds.tier.stats)
        cio = [r.breakdown.critical_io_s * 1e3 for r in resps]
        out["cluster_gds"] = {
            "launches": read_counts(), "wall_s": walls,
            "critical_io_ms": cio, "hedged_reads": st["hedged_reads"],
            "hedge_wins": st["hedge_wins"], "hedge_bytes": st["hedge_bytes"],
            "cache_hits": st["cache_hits"],
            "cache": gds.tier.arena_cache.stats()}
        same_ids = all(np.array_equal(w.doc_ids, g.doc_ids)
                       for r in resps
                       for w, g in zip(FIRST["gds"].ranked, r.ranked))
        check("cluster_gds", st["hedged_reads"] > 0 and st["hedge_wins"] > 0
              and cio[0] > 0 and cio[1] == cio[2] == 0.0 and same_ids,
              f"gds, 3 batches of the same {BATCH_SIZE} queries on "
              f"stragglers: {st['hedged_reads']} hedged reads, "
              f"{st['hedge_wins']} won, {st['hedge_bytes']:,} hedge bytes; "
              f"critical I/O ms {[round(x, 3) for x in cio]}; cache "
              f"{gds.tier.arena_cache.stats()}; ids equal the single "
              f"tier's: {same_ids}; walls {[round(w, 3) for w in walls]} s")
        # 6) the autoscaler on the same cluster, under the reference's
        #    default 50 ms SLO (no shedding: every request is observed)
        gds.cfg.serve.slo_ms, gds.cfg.serve.shed = SLO_DEFAULT_MS, False
        gds.cfg.serve.autoscale = True
        gds.cfg.serve.max_batch = SERVE_MAX_BATCH
        reset_counts()
        srv = gds.serve()
        try:
            reqs = [srv.query_async(corpus.queries_cls[i],
                                    corpus.queries_bow[i],
                                    int(corpus.query_lens[i]))
                    for i in range(AUTOSCALE_REQUESTS)]
            late = sum(not r.done.wait(WAIT_S) for r in reqs)
        finally:
            srv.shutdown()
        acts = srv.autoscaler.actions
        out["cluster_autoscale"] = {
            "launches": read_counts(), "actions": acts,
            "hedge_quantile": gds.tier.hedge_quantile,
            "summary": srv.stats.summary()}
        for a in acts:
            log(f"    autoscaler: {json.dumps(a)}")
        check("cluster_autoscale", not late and not srv.stats.errors
              and len(acts) > 0,
              f"autoscaled gds server, {AUTOSCALE_REQUESTS} requests under "
              f"a {SLO_DEFAULT_MS:.0f} ms SLO: {len(acts)} decisions, hedge "
              f"quantile 0.95 -> {gds.tier.hedge_quantile}; p99 SLO latency "
              f"{srv.stats.slo_percentile(99):.1f} ms")
    require_launches(out, failures, "cluster_1x1_espn", "cluster_cascade",
                     "cluster_espn", "cluster_serve", "cluster_failover",
                     "cluster_gds", "cluster_autoscale")


# the [mutation] phase: 4 ingest batches of fresh docs from the generator
# under another seed, 10,000 base docs and ~30% of the ingested ones
# tombstoned, on the [cluster] phase's 4 x 2 shard images
INGEST_BATCHES, INGEST_DOCS, INGEST_SEED = 4, 2_500, 24
BASE_DELETES, INGEST_KILL = 10_000, 0.3
CHECK_QUERIES = 16      # the post-compaction checks' batch (each answer is
                        # the same bits as in a batch of 64: run AF)


RELOAD_INGEST, RELOAD_DELETES = 500, 1_000   # the loaded pipeline's own churn


def save_and_load_mutable(pipe, dev, failures, res, out, q, check,
                          alive_only):
    """Save the churned mutable cluster (segments and tombstones on every
    shard) under ``build/``, load it onto the card, and hold the loaded
    pipeline to the unsaved one: the tombstone mask and segment counts
    equal, an espn and a cascade batch equal in ids, scores and bill (each
    on a fresh ``with_mode`` view of either tier, so both bill from the
    same clock state), then one ingest and one delete on the loaded
    pipeline alone: its new ids follow the unsaved pipeline's last one,
    and no tombstoned id is answered. The unsaved pipeline is not
    touched."""
    import shutil
    import tempfile

    import torch

    from repro_torch.data.synthetic import make_corpus
    from repro_torch.pipeline import Pipeline
    t = pipe.tier
    need = (2 * t.layout.nbytes + pipe.index.memory_bytes()
            + t.bits.nbytes + t.fde.nbytes)
    root = tempfile.mkdtemp(prefix="mutation-",
                            dir=os.path.join(ROOT, "build"))
    free = shutil.disk_usage(root).free
    log(f"  save: to write ~{need / 2**30:.2f} GiB; {free / 2**30:.1f} GiB "
        f"free under {os.path.relpath(root, ROOT)}")
    if free < 1.2 * need:
        shutil.rmtree(root, ignore_errors=True)
        failures.append(f"mutation: save: {free / 2**30:.1f} GiB free, "
                        f"{need / 2**30:.2f} GiB needed")
        return
    try:
        t0 = time.perf_counter()
        pipe.save(root)
        t_save = time.perf_counter() - t0
        n_bytes = dir_bytes(root)
        files = sorted(os.listdir(os.path.join(root, "mutation")))
        t0 = time.perf_counter()
        loaded = Pipeline.load(root, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_seg = sum(len(x) for x in t.segments)
    want_files = {"state.npz"} | {f"shard_{s}.npz" for s in
                                  range(t.n_shards)} | {
        f"seg_{s}_{k}.npz" for s in range(t.n_shards)
        for k in range(len(t.segments[s]))}
    res["save_load"] = {"bytes": n_bytes, "save_s": t_save,
                        "load_s": t_load, "free_bytes": free,
                        "files": len(files)}
    with loaded:
        lt = loaded.tier
        check("mutation_saved",
              {f for f in files if f.endswith(".npz")} == want_files
              and np.array_equal(lt.alive, t.alive)
              and [len(x) for x in lt.segments] == [len(x) for x in
                                                    t.segments]
              and loaded.device.type == "cuda"
              and lt.fde.vecs.device.type == "cuda",
              f"saved {n_bytes:,} bytes ({len(want_files)} npz under "
              f"mutation/: {t.n_shards} shard images, {n_seg} segments, the "
              f"state) in {t_save:.2f} s, loaded onto {loaded.device} in "
              f"{t_load:.2f} s: {int((~lt.alive).sum()):,} tombstones and "
              f"segments per shard {[len(x) for x in lt.segments]} as "
              f"saved")
        for mode in ("espn", "cascade"):
            path = f"mutation_loaded_{mode}"
            with pipe.with_mode(mode) as a, loaded.with_mode(mode) as b:
                want = a.search(*q)
                reset_counts()
                t0 = time.perf_counter()
                got = b.search(*q)
                res[path] = {"launches": read_counts(),
                             "wall_s": time.perf_counter() - t0}
            out[path] = {"launches": res[path]["launches"]}
            check(path, same_bits(want, got),
                  f"loaded {mode} batch of {BATCH_SIZE} vs the unsaved "
                  f"tier's: ids, scores and bill bit for bit (wall "
                  f"{res[path]['wall_s']:.2f} s)")
        new = make_corpus(n_docs=RELOAD_INGEST, n_queries=1,
                          d_cls=t.layout.d_cls, d_bow=t.layout.d_bow,
                          max_len=CTX["cfg"].corpus.max_len,
                          seed=INGEST_SEED + 1)
        rng = np.random.default_rng(INGEST_SEED + 1)
        n0, alive0 = t.layout.n_docs, t.alive.copy()
        t0 = time.perf_counter()
        gids = loaded.ingest(new.cls.astype(np.float32), new.bow)
        torch.cuda.synchronize()
        t_ingest = time.perf_counter() - t0
        live = np.flatnonzero(lt.alive)
        dead = np.concatenate([gids[::2], rng.choice(live, RELOAD_DELETES,
                                                     replace=False)])
        loaded.delete(np.unique(dead))
        path = "mutation_loaded_ingest_espn"
        with loaded.with_mode("espn") as b:
            reset_counts()
            t0 = time.perf_counter()
            got = b.search(*first_queries(CTX["corpus"], CHECK_QUERIES))
            res[path] = {"launches": read_counts(),
                         "wall_s": time.perf_counter() - t0}
        out[path] = {"launches": res[path]["launches"]}
        follows = np.array_equal(gids, n0 + np.arange(RELOAD_INGEST))
        untouched = t.layout.n_docs == n0 and np.array_equal(t.alive, alive0)
        check(path, follows and untouched
              and alive_only(got, lt.alive, path),
              f"loaded pipeline alone: ingest of {RELOAD_INGEST} docs in "
              f"{t_ingest:.2f} s, ids {int(gids[0]):,}-{int(gids[-1]):,} "
              f"(the unsaved pipeline's last is {n0 - 1:,}); "
              f"{len(np.unique(dead)):,} more tombstones; espn batch of "
              f"{CHECK_QUERIES} with no tombstoned id (wall "
              f"{res[path]['wall_s']:.2f} s); the unsaved tier untouched")
    res["save_load"]["reload_ingest_s"] = t_ingest


def mutation_phase(dev, failures, out):
    """Live mutation on the main path's 1M-doc artifacts (nothing rebuilt
    or cut) through ``MutableStorageCluster``: an unmutated 1x1 mutable
    cluster against the single tier; then, on 4 shards x 2 replicas,
    ingests, deletes, espn and cascade batches mid-churn, the side tables
    and the grown layout and index against a rebuild, the churned espn
    answers against a rebuild oracle, a save and load of the churned tier
    in the ``mutation/`` format, and compact, rebalance and maintain with
    the answers held."""
    import dataclasses

    import torch

    from repro_torch.core.fde import fde_from_layout
    from repro_torch.core.ivf import ivf_add
    from repro_torch.data.synthetic import make_corpus
    from repro_torch.pipeline import Pipeline
    from repro_torch.pipeline.config import ClusterConfig, MutationConfig
    from repro_torch.pipeline.pipeline import _pack_layout
    from repro_torch.storage.layout import bits_from_layout
    corpus, idx, layout, cfg = (CTX[k] for k in ("corpus", "index",
                                                 "layout", "cfg"))
    tables, q = CTX["tables"], first_queries(corpus)
    q16 = first_queries(corpus, CHECK_QUERIES)
    mut = MutationConfig(enabled=True)
    res = out["mutation"] = {}

    def check(path, ok, what):
        log(f"  {path}: {what} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"mutation: {path}: {what}")

    def alive_only(resp, alive, path):
        """No tombstoned id in any answer (and a well-formed ranking)."""
        check_ranked(resp, len(alive), failures, path)
        return all(alive[r.doc_ids].all() for r in resp.ranked)

    def same_answers(want, got) -> bool:
        """ids and scores bit for bit (``got`` may answer a prefix of
        ``want``'s queries: each answer is its query's alone)."""
        return all(np.array_equal(w.doc_ids, g.doc_ids)
                   and np.array_equal(w.scores, g.scores)
                   for w, g in zip(want.ranked, got.ranked))

    def espn_batch(pipe, path, queries=q):
        """An espn batch on a fresh ``with_mode`` view of the churned tier,
        its kernels counted."""
        with pipe.with_mode("espn") as espn:
            reset_counts()
            t0 = time.perf_counter()
            got = espn.search(*queries)
            res[path] = {"launches": read_counts(),
                         "wall_s": time.perf_counter() - t0}
        out[path] = {"launches": res[path]["launches"]}
        return got

    # 1) an unmutated mutable 1x1 cluster IS the single tier, bill included
    with Pipeline.from_artifacts(mode_cfg(cfg, "espn", mutation=mut),
                                 index=idx, layout=layout,
                                 device=dev) as one:
        reset_counts()
        t0 = time.perf_counter()
        got = one.search(*q)
        out["mutation_1x1_espn"] = {"launches": read_counts()}
        res["mutation_1x1_espn"] = {"wall_s": time.perf_counter() - t0}
    check("mutation_1x1_espn", same_bits(FIRST["espn"], got),
          f"unmutated mutable 1x1 cluster, espn batch of {BATCH_SIZE} vs "
          f"the single tier: ids, scores and bill bit for bit (wall "
          f"{res['mutation_1x1_espn']['wall_s']:.2f} s)")

    # 2) churn on 4 shards x 2 replicas in cascade (the bit and FDE tables
    #    ride along); espn batches run on with_mode views of the same tier
    mcfg = mode_cfg(cfg, "cascade", mutation=mut,
                    cluster=ClusterConfig(n_shards=SHARDS,
                                          replication=REPLICAS))
    pipe = Pipeline.from_artifacts(mcfg, index=idx, layout=layout,
                                   device=dev,
                                   shard_layouts=CTX.pop("shard_layouts"),
                                   **tables)
    new = make_corpus(n_docs=INGEST_BATCHES * INGEST_DOCS, n_queries=1,
                      d_cls=cfg.corpus.d_cls, d_bow=cfg.corpus.d_bow,
                      max_len=cfg.corpus.max_len, seed=INGEST_SEED)
    rng = np.random.default_rng(INGEST_SEED)
    base_dead = rng.choice(N_DOCS, BASE_DELETES, replace=False)
    times = defaultdict(list)
    batches = []
    with pipe:
        for i in range(INGEST_BATCHES):
            sl = slice(i * INGEST_DOCS, (i + 1) * INGEST_DOCS)
            # fp32 CLS rows, as a caller's encoder gives them (the
            # generator's are float64; ingest takes fp32)
            batch = (new.cls[sl].astype(np.float32), new.bow[sl])
            batches.append(batch)
            t0 = time.perf_counter()
            gids = pipe.ingest(*batch)
            torch.cuda.synchronize()
            times["ingest_s"].append(time.perf_counter() - t0)
            dead = np.concatenate([
                base_dead[i::INGEST_BATCHES],
                gids[rng.random(len(gids)) < INGEST_KILL]])
            t0 = time.perf_counter()
            pipe.delete(dead)
            times["delete_s"].append(time.perf_counter() - t0)
            if i == 1:
                # mid-churn: two of four segments live, tombstones in both
                alive = pipe.tier.alive
                reset_counts()
                t0 = time.perf_counter()
                got = pipe.search(*q)
                out["mutation_cascade"] = {"launches": read_counts()}
                res["mutation_cascade"] = {
                    "wall_s": time.perf_counter() - t0}
                ok = alive_only(got, alive, "mutation_cascade")
                check("mutation_cascade", ok,
                      f"cascade batch of {BATCH_SIZE} mid-churn "
                      f"({sum(len(x) for x in pipe.tier.segments)} segments"
                      f", {int((~alive).sum()):,} tombstones): no "
                      f"tombstoned id in any answer (wall "
                      f"{res['mutation_cascade']['wall_s']:.2f} s)")
                # 16 queries (64 until the encoder and disk_ivf phases
                # came: a depth cut)
                got = espn_batch(pipe, "mutation_espn", q16)
                check("mutation_espn", alive_only(got, alive,
                                                  "mutation_espn"),
                      f"espn batch of {CHECK_QUERIES} mid-churn: no "
                      f"tombstoned id in any answer (wall "
                      f"{res['mutation_espn']['wall_s']:.2f} s)")
        t = pipe.tier
        alive = t.alive.copy()
        st = dict(t.stats)
        res.update(times, segments=[len(x) for x in t.segments],
                   n_docs=t.layout.n_docs, tombstones=int((~alive).sum()),
                   ingest_bytes=st["ingest_bytes"],
                   ingest_sim_s=st["ingest_seconds"])
        log(f"  ingest {INGEST_BATCHES} x {INGEST_DOCS:,} docs: host s "
            f"{[round(x, 3) for x in times['ingest_s']]} (each copies the "
            f"{t.layout.nbytes / 2**30:.2f} GiB grown blob); delete s "
            f"{[round(x, 4) for x in times['delete_s']]}; "
            f"{res['tombstones']:,} tombstones; segments per shard "
            f"{res['segments']}; {st['ingest_bytes']:,} ingest bytes, "
            f"{st['ingest_seconds']:.4f} simulated s")

        # 3) the appended side tables equal a rebuild of the grown layout
        t0 = time.perf_counter()
        bits = bits_from_layout(t.layout, dtype=str(t.bits.packed.dtype))
        t_bits = time.perf_counter() - t0
        t0 = time.perf_counter()
        fde = fde_from_layout(t.layout, t.fde.cfg,
                              dtype=str(t.fde.vecs.dtype).split(".")[-1],
                              device=dev)
        torch.cuda.synchronize()
        t_fde = time.perf_counter() - t0
        same_bits_table = (np.array_equal(bits.packed, t.bits.packed)
                           and np.array_equal(bits.starts, t.bits.starts))
        same_fde = torch.equal(fde.vecs, t.fde.vecs)
        del bits, fde
        check("side_tables", same_bits_table and same_fde,
              f"appended bit table ({t.bits.packed.shape[0]:,} tokens) and "
              f"FDE table ({t.fde.vecs.shape[0]:,} docs, on "
              f"{t.fde.vecs.device}) vs bits_from_layout / fde_from_layout "
              f"of the grown layout ({t_bits:.1f} / {t_fde:.1f} s): "
              f"{'equal' if same_bits_table else 'BITS DIFFER'}, "
              f"{'equal' if same_fde else 'FDE DIFFERS'} bit for bit")

        # 4) the rebuild oracle: the pre-ingest index with ivf_add
        #    replayed, every doc packed from scratch, the same tombstones
        oracle_index = dataclasses.replace(idx)
        start = N_DOCS
        for cls_b, _ in batches:
            ivf_add(oracle_index, cls_b, np.arange(start, start + len(cls_b)))
            start += len(cls_b)
        same_index = all(torch.equal(getattr(oracle_index, k),
                                     getattr(pipe.index, k))
                         for k in ("cell_ids", "cell_vecs")) \
            and np.array_equal(oracle_index.cell_sizes,
                               pipe.index.cell_sizes)
        ocfg = mode_cfg(cfg, "espn")
        t0 = time.perf_counter()
        grown = _pack_layout(ocfg, np.concatenate(
            [corpus.cls] + [b[0] for b in batches]),
            list(corpus.bow) + [bw for b in batches for bw in b[1]])
        t_pack = time.perf_counter() - t0
        same_layout = (np.array_equal(grown.blob, t.layout.blob)
                       and np.array_equal(grown.offsets, t.layout.offsets))
        with Pipeline.from_artifacts(ocfg, index=oracle_index, layout=grown,
                                     device=dev) as oracle:
            oracle.tier.alive = alive
            want = oracle.search(*q)
        del grown
        got = espn_batch(pipe, "mutation_oracle_espn")
        res["pack_from_scratch_s"] = t_pack
        check("mutation_oracle_espn", same_index and same_layout
              and same_answers(want, got)
              and alive_only(got, alive, "mutation_oracle_espn"),
              f"churned espn batch of {BATCH_SIZE} vs the rebuild oracle "
              f"(index with ivf_add replayed: "
              f"{'equal' if same_index else 'DIFFERS'}; grown layout vs a "
              f"pack from scratch in {t_pack:.1f} s: "
              f"{'equal' if same_layout else 'DIFFERS'}): ids and scores "
              f"bit for bit")
        before = got

        # 4b) the churned tier saved in the mutation/ format, loaded back
        #     onto the card, and mutated on its own
        save_and_load_mutable(pipe, dev, failures, res, out, q, check,
                              alive_only)

        # 5) compaction: every dead row's blocks reclaimed, answers held
        phys = sum(t._shard_disk_blocks(s) for s in range(t.n_shards))
        dead_blocks = int(t.layout.offsets[~alive, 1].sum())
        t0 = time.perf_counter()
        rep = pipe.compact()
        times["compact_s"] = time.perf_counter() - t0
        got = espn_batch(pipe, "mutation_compacted_espn", q16)
        phys_after = sum(t._shard_disk_blocks(s) for s in range(t.n_shards))
        res["compact"] = {k: rep[k] for k in ("segments_merged",
                                              "blocks_reclaimed")}
        check("mutation_compacted_espn",
              rep["blocks_reclaimed"] == dead_blocks == phys - phys_after
              and not any(t.segments) and same_answers(before, got),
              f"compact() in {times['compact_s']:.2f} s: "
              f"{rep['segments_merged']} segments merged, "
              f"{rep['blocks_reclaimed']:,} blocks reclaimed (the "
              f"tombstones' blocks on the host: {dead_blocks:,}); "
              f"{CHECK_QUERIES} espn answers bit for bit as before")

        # 6) rebalance, then maintain: answers held, both sides billed
        mass0 = t._live_block_mass()
        mig0 = t.stats["migration_bytes"]
        t0 = time.perf_counter()
        reb = pipe.rebalance()
        times["rebalance_s"] = time.perf_counter() - t0
        mass1 = t._live_block_mass()
        got = espn_batch(pipe, "mutation_rebalanced_espn", q16)
        migrated = t.stats["migration_bytes"] - mig0
        res["rebalance"] = {**reb, "migration_bytes": migrated,
                            "mass_before": mass0.tolist(),
                            "mass_after": mass1.tolist()}
        check("mutation_rebalanced_espn",
              migrated == 2 * reb["moved_blocks"] * layout.block
              and int(mass1.sum()) == int(mass0.sum())
              and mass1.max() - mass1.min() <= mass0.max() - mass0.min()
              and same_answers(before, got),
              f"rebalance() in {times['rebalance_s']:.3f} s: "
              f"{reb['moved_docs']:,} docs ({reb['moved_blocks']:,} blocks) "
              f"shard {reb['src']} -> {reb['dst']}, {migrated:,} migration "
              f"bytes (2 x moved blocks x block); live block mass "
              f"{mass0.tolist()} -> {mass1.tolist()}; answers bit for bit")
        t0 = time.perf_counter()
        mnt = pipe.maintain()
        times["maintain_s"] = time.perf_counter() - t0
        got = espn_batch(pipe, "mutation_maintained_espn", q16)
        res["maintain"] = {"compacted": len(mnt["compacted"]),
                           "reclaimed": sum(r["blocks_reclaimed"]
                                            for r in mnt["compacted"])}
        check("mutation_maintained_espn", same_answers(before, got),
              f"maintain() in {times['maintain_s']:.2f} s: "
              f"{res['maintain']['compacted']} shards compacted "
              f"({res['maintain']['reclaimed']:,} blocks); answers bit for "
              f"bit")
        res.update(compact_s=times["compact_s"],
                   rebalance_s=times["rebalance_s"],
                   maintain_s=times["maintain_s"],
                   stats={k: st2 for k, st2 in t.stats.items()
                          if k in ("ingests", "ingested_docs", "deletes",
                                   "tombstones", "compactions",
                                   "compaction_bytes", "rebalances",
                                   "migration_bytes")})
    log(f"  mutation summary: {json.dumps(res, default=str)}")
    require_launches(out, failures, *MUTATION_PATHS)


# the [train] phase: examples/train_retriever_torch.py's recipe at the
# published widths; the LM branch at SmolLM-135M's full width and depth
TRAIN_PAIRS, TRAIN_STEPS, TRAIN_CKPT_EVERY = 32, 20, 10
TRAIN_COMPRESSED_STEPS = 5
TRAIN_AGREE_PAIRS = 8       # pairs of the fp32 card-vs-CPU step
TRAIN_LOSS_TOL = 3e-2       # a replay on the card: the bf16 loss tolerance
TRAIN_TOL = 1e-5            # fp32 card vs CPU: loss, grad norm, weights
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 512, 3
LM_LONG_SEQ = 4096          # SmolLM's steps: train_4k's sequence length
REMAT_TOL = {"bfloat16": 3e-2, "float32": 1e-6}   # remat on vs off, of the
                            # tensor's largest |value|


def weights_disagree(w_a, w_b, m_a, m_b, lr_1) -> list[str]:
    """The leaves where one AdamW step from the same weights disagrees
    beyond the CPU tests' tolerance. Adam's first step moves a weight by
    lr_1 x g / (|g| + 1e-8): +-lr_1 by the gradient's sign, unless |g|
    is near Adam's eps. So a weight may differ by more than ``TRAIN_TOL``
    only where the two gradients (the first moment m = 0.1 g) have
    opposite signs or |g| < 1e-7, and then by at most 2 x lr_1."""
    import torch

    bad = []
    for k, w in w_b.items():
        dw = (w_a[k] - w).abs()
        far = dw > TRAIN_TOL
        loose = (torch.sign(m_a[k]) != torch.sign(m_b[k])) | (
            m_b[k].abs() < 1e-8)
        if float(dw.max()) > 2 * lr_1 + 1e-6 or bool((far & ~loose).any()):
            bad.append(k)
    return bad


def train_phase(dev, failures, out):
    """Training on the card. ColBERTer at its published widths (bf16
    compute over fp32 masters, weights from numpy seed 0): 20 ``Trainer``
    steps of 32 ``synth_pairs`` pairs with ``AdamW(lr=1e-3, grad_clip=5.0,
    warmup_steps=30)``, a checkpoint every 10 steps under ``build/``; a
    fresh Trainer resumed from step 10 replays steps 10-19 (within
    ``TRAIN_LOSS_TOL``, and says whether bit for bit: PyTorch promises a
    deterministic backward only under ``use_deterministic_algorithms``);
    ``grad_accum=2`` equal to the average of its two halves' gradients
    put through the same update; 5 steps with int8 error-feedback
    compression finite; one fp32 step at 2 layers on the card and on the
    CPU from the same weights (loss and grad norm within ``TRAIN_TOL``,
    the weights as ``weights_disagree`` holds them); then
    SmolLM-135M at full width and depth, 3 steps of 8 x ``LM_LONG_SEQ``
    tokens through ``transformer.loss_fn`` (remat on, the default), and
    ``remat_agreement``. No kernel
    of the port may launch: the losses' MaxSim and attention are plain
    PyTorch with autograd."""
    import shutil
    import tempfile

    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import colberter
    from repro_torch.train.optimizer import AdamW, named_params
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           make_train_step)
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from train_retriever_torch import synth_pairs

    res = out["train"] = {}
    cfg = get_config(ENCODER)
    params = numpy_params(colberter.param_table(cfg), np.random.default_rng(0))
    opt = AdamW(lr=1e-3, grad_clip=5.0, warmup_steps=30)
    lr_1 = opt.schedule(torch.tensor(1)).item()      # the first update's lr

    def loss_fn(c):
        return lambda p, b: colberter.contrastive_loss(c, p, b)

    def data(c, n=TRAIN_PAIRS, where=dev):
        return lambda step: synth_pairs(step, n, c, where)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="train-", dir=os.path.join(ROOT, "build"))
    reset_counts()
    try:
        def trainer(directory, steps=TRAIN_STEPS, **kw):
            model = convert.colberter_params_from_numpy(params, cfg, dev)
            return Trainer(TrainerConfig(total_steps=steps,
                                         ckpt_every=TRAIN_CKPT_EVERY,
                                         log_every=TRAIN_CKPT_EVERY,
                                         ckpt_dir=directory, **kw),
                           loss_fn(cfg), opt, data(cfg), model)

        tr = trainer(os.path.join(root, "run"))
        n_params = sum(p.numel() for p in tr.params.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        hist = tr.run(verbose=False)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        step_ms = np.array([m["step_s"] for m in hist]) * 1e3
        med = float(np.median(step_ms[1:]))
        tokens = TRAIN_PAIRS * (cfg.max_query_len + cfg.max_doc_len)
        losses = [m["loss"] for m in hist]
        ckpt = os.path.join(root, "run", f"step_{TRAIN_CKPT_EVERY}")
        ckpt_bytes = dir_bytes(ckpt)
        res.update(n_params=n_params, step_ms=step_ms.tolist(),
                   median_step_ms=med, pairs_per_s=TRAIN_PAIRS / med * 1e3,
                   tokens_per_s=tokens / med * 1e3, peak_bytes=peak,
                   losses=losses, run_s=run_s, ckpt_bytes=ckpt_bytes,
                   ckpts=tr.ckpt.all_steps())
        finite = bool(np.isfinite(losses).all())
        log(f"  {ENCODER}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{n_params:,} fp32 params on {dev}, {cfg.dtype} compute; "
            f"{TRAIN_STEPS} steps of {TRAIN_PAIRS} pairs ({tokens:,} tokens "
            f"a step) in {run_s:.2f} s: step 0 {step_ms[0]:.1f} ms, then a "
            f"median {med:.2f} ms (range {step_ms[1:].min():.2f}-"
            f"{step_ms[1:].max():.2f}), {res['pairs_per_s']:,.1f} pairs/s, "
            f"{res['tokens_per_s']:,.0f} tokens/s; peak device memory "
            f"{peak / 2**30:.2f} GiB")
        log(f"  loss at steps 0 / 10 / 19: {losses[0]:.4f} / "
            f"{losses[10]:.4f} / {losses[19]:.4f} "
            f"({'all finite' if finite else 'NOT finite'}); checkpoints "
            f"{res['ckpts']}, step_{TRAIN_CKPT_EVERY} {ckpt_bytes:,} bytes")
        if not finite:
            failures.append("train: a loss is not finite")
        if res["ckpts"] != [TRAIN_CKPT_EVERY, TRAIN_STEPS]:
            failures.append(f"train: checkpoints {res['ckpts']}")

        # resume: a fresh Trainer from the step-10 checkpoint alone
        shutil.copytree(ckpt, os.path.join(root, "resume",
                                           f"step_{TRAIN_CKPT_EVERY}"),
                        copy_function=os.link)
        again = trainer(os.path.join(root, "resume"))
        t0 = time.perf_counter()
        start = again.maybe_resume()
        resume_s = time.perf_counter() - t0
        replay = again.run(verbose=False)
        diffs = [abs(a["loss"] - b["loss"])
                 for a, b in zip(hist[TRAIN_CKPT_EVERY:], replay)]
        worst = max(diffs)
        same = all(a["loss"] == b["loss"] and a["gnorm"] == b["gnorm"]
                   for a, b in zip(hist[TRAIN_CKPT_EVERY:], replay))
        w_diff = max(float((p.detach() - q.detach()).abs().max())
                     for p, q in zip(tr.params.parameters(),
                                     again.params.parameters()))
        ok = (start == TRAIN_CKPT_EVERY and len(replay) == len(diffs)
              == TRAIN_STEPS - TRAIN_CKPT_EVERY and worst <= TRAIN_LOSS_TOL)
        res.update(resume_step=start, resume_s=resume_s,
                   replay_loss_diffs=diffs, replay_bitwise=same,
                   replay_weight_diff=w_diff)
        log(f"  resumed at step {start} in {resume_s:.2f} s; steps "
            f"{TRAIN_CKPT_EVERY}-{TRAIN_STEPS - 1} replayed: max |loss diff| "
            f"{worst:.3g} (tol {TRAIN_LOSS_TOL}), "
            f"{'bit for bit' if same else 'not bit for bit'}; final weights "
            f"max |diff| {w_diff:.3g} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("train: the resumed run does not replay")
        del tr, again

        # accumulation: grad_accum=2 against its halves' mean gradient
        batch = data(cfg)(0)
        m2 = convert.colberter_params_from_numpy(params, cfg, dev)
        m2, _, acc_metrics = make_train_step(loss_fn(cfg), opt,
                                             grad_accum=2)(m2, opt.init(m2),
                                                           batch)
        m1 = convert.colberter_params_from_numpy(params, cfg, dev)
        leaves = named_params(m1)
        half = TRAIN_PAIRS // 2
        grads = None
        for i in range(2):
            loss, _ = loss_fn(cfg)(m1, {k: v[i * half:(i + 1) * half]
                                        for k, v in batch.items()})
            g = torch.autograd.grad(loss, list(leaves.values()),
                                    materialize_grads=True)
            grads = ({k: t.float() for k, t in zip(leaves, g)}
                     if grads is None else
                     {k: grads[k] + t for k, t in zip(leaves, g)})
        opt.update({k: t / 2 for k, t in grads.items()}, opt.init(m1), m1)
        acc_err = {k: float((p - named_params(m2)[k]).detach().abs().max())
                   for k, p in leaves.items()}
        full = convert.colberter_params_from_numpy(params, cfg, dev)
        full, _, _ = make_train_step(loss_fn(cfg), opt)(full, opt.init(full),
                                                        batch)
        vs_full = float(np.median([float((p - q).detach().abs().max())
                                   for p, q in zip(full.parameters(),
                                                   m2.parameters())]))
        ok = all(e <= (2 * lr_1 + 1e-6 if k == "embed" else 1e-6)
                 for k, e in acc_err.items())
        res.update(accum_max_diff=acc_err, accum_vs_full_median=vs_full,
                   accum_loss=float(acc_metrics["loss"]))
        log(f"  grad_accum=2 on step 0's batch vs the update of its halves' "
            f"mean gradient: max |weight diff| {max(acc_err.values()):.3g} "
            f"(embed {acc_err['embed']:.3g}, tol 2 x lr_1 = {2 * lr_1:.3g}; "
            f"others {max(v for k, v in acc_err.items() if k != 'embed'):.3g}"
            f", tol 1e-6) -> {'ok' if ok else 'FAIL'}; against grad_accum=1 "
            f"on the whole batch (other in-batch negatives) median of the "
            f"leaves' max |diff| {vs_full:.3g}")
        if not ok:
            failures.append("train: grad_accum=2 differs from its halves")
        del m1, m2, full, grads

        # int8 error-feedback compression
        comp = trainer(os.path.join(root, "compressed"),
                       TRAIN_COMPRESSED_STEPS, grad_compression=True)
        c_hist = comp.run(verbose=False)
        c_losses = [m["loss"] for m in c_hist]
        ok = len(c_losses) == TRAIN_COMPRESSED_STEPS and bool(
            np.isfinite(c_losses).all())
        res.update(compressed_losses=c_losses)
        log(f"  {TRAIN_COMPRESSED_STEPS} steps with int8 error-feedback "
            f"compression: losses {[round(x, 4) for x in c_losses]} "
            f"(uncompressed {[round(x, 4) for x in losses[:5]]}) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("train: a compressed step is not finite")
        del comp
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # one fp32 step on the card and on the CPU from the same weights
    f32 = cfg.scaled(n_layers=2, dtype=torch.float32)
    small = numpy_params(colberter.param_table(f32), np.random.default_rng(1))
    step = make_train_step(loss_fn(f32), opt)
    got = {}
    for where in (dev, torch.device("cpu")):
        model = convert.colberter_params_from_numpy(small, f32, where)
        model, state, m = step(model, opt.init(model),
                               data(f32, TRAIN_AGREE_PAIRS, where)(0))
        got[where.type] = (m, {k: p.detach().cpu() for k, p in
                               named_params(model).items()},
                           {k: t.cpu() for k, t in state["m"].items()})
    (m_card, w_card, g_card), (m_cpu, w_cpu, g_cpu) = got[dev.type], got["cpu"]
    errs = {k: abs(float(m_card[k]) - float(m_cpu[k])) / max(
        1.0, abs(float(m_cpu[k]))) for k in ("loss", "gnorm")}
    bad = weights_disagree(w_card, w_cpu, g_card, g_cpu, lr_1)
    w_err = {k: float((w_card[k] - w).abs().max()) for k, w in w_cpu.items()}
    flips = sum(int(((w_card[k] - w).abs() > TRAIN_TOL).sum())
                for k, w in w_cpu.items())
    ok = max(errs.values()) <= TRAIN_TOL and not bad
    res.update(card_vs_cpu=errs, card_vs_cpu_weights=w_err,
               card_vs_cpu_flips=flips)
    log(f"  fp32, 2 layers, {TRAIN_AGREE_PAIRS} pairs, one step, card vs "
        f"CPU: loss {errs['loss']:.3g}, grad norm {errs['gnorm']:.3g} x "
        f"max(1, |cpu|) (tol {TRAIN_TOL}); weights max |diff| "
        f"{max(w_err.values()):.3g}, {flips} beyond {TRAIN_TOL} (each where "
        f"the gradients' signs differ or |g| < 1e-7, <= 2 x lr_1 = "
        f"{2 * lr_1:.3g}) -> {'ok' if ok else 'FAIL: ' + ', '.join(bad)}")
    if not ok:
        failures.append("train: the card's step disagrees with the CPU's")

    # the LM branch at full width and depth
    lm = lm_train(dev, failures, get_config(LM), seq=LM_LONG_SEQ)
    res.update({f"lm_{k}": v for k, v in lm.items()},
               lm_remat=remat_agreement(dev, failures),
               launches=read_counts())
    launched = {k: v for k, v in res["launches"].items() if v}
    log(f"  kernel launches in [train]: {launched or 'none'}")
    if launched:
        failures.append(f"train: kernels launched {launched}")


def lm_train(dev, failures, cfg, seq=LM_TRAIN_SEQ) -> dict:
    """``cfg`` at full width trained ``LM_TRAIN_STEPS`` ``Trainer`` steps of
    ``LM_TRAIN_BATCH`` x ``seq`` tokens through
    ``transformer.loss_fn`` with AdamW, from random weights (``lm_model``):
    step ms, tokens/s, peak memory, finite losses (and, from the
    loss's metrics, finite ``ce`` and ``aux``)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models import transformer
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import Trainer, TrainerConfig
    model = lm_model(cfg, dev, np.random.default_rng(0))
    n_params = sum(p.numel() for p in model.parameters())
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="train-lm-", dir=os.path.join(ROOT, "build"))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        tr = Trainer(
            TrainerConfig(total_steps=LM_TRAIN_STEPS, ckpt_every=1_000,
                          ckpt_dir=root),
            lambda p, b: transformer.loss_fn(cfg, p, b), AdamW(),
            lambda i: {k: torch.as_tensor(v, device=dev) for k, v in
                       make_lm_batch(i, LM_TRAIN_BATCH, seq,
                                     cfg.vocab_size).items()}, model)
        hist = tr.run(verbose=False)
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del tr, model
    gc.collect()
    torch.cuda.empty_cache()
    ms = np.array([m["step_s"] for m in hist]) * 1e3
    metrics = {k: [m[k] for m in hist] for k in ("loss", "ce", "aux")}
    tokens = LM_TRAIN_BATCH * seq
    ok = len(hist) == LM_TRAIN_STEPS and all(
        bool(np.isfinite(v).all()) for v in metrics.values())
    res = {"n_params": n_params, "seq": seq, "remat": cfg.remat,
           "step_ms": ms.tolist(),
           "tokens_per_s": tokens / float(np.median(ms[1:])) * 1e3,
           "peak_bytes": peak, "losses": metrics["loss"],
           "ce": metrics["ce"], "aux": metrics["aux"]}
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params:,} fp32 params; {LM_TRAIN_STEPS} steps of "
        f"{LM_TRAIN_BATCH} x {seq} tokens, remat {cfg.remat}: step ms "
        f"{[round(float(x), 1) for x in ms]}, {res['tokens_per_s']:,.0f} "
        f"tokens/s after the first; peak device memory {peak / 2**30:.2f} "
        f"GiB; loss {[round(x, 4) for x in metrics['loss']]}, ce "
        f"{[round(x, 4) for x in metrics['ce']]}, aux "
        f"{[round(x, 4) for x in metrics['aux']]} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"train: a {cfg.name} loss is not finite")
    return res


def remat_agreement(dev, failures) -> dict:
    """SmolLM-135M at full width and depth, one loss and its gradient over
    ``LM_TRAIN_BATCH`` x ``LM_TRAIN_SEQ`` tokens with ``remat`` on and off,
    from the same weights (drawn on the card) and batch, in bf16 compute and
    in fp32: the loss and every gradient within ``REMAT_TOL`` of the
    tensor's largest |value|; logs whether bit for bit."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models import transformer
    cfg = get_config(LM)
    model = lm_model(cfg, dev, np.random.default_rng(1))
    params = list(model.parameters())
    batch = {k: torch.as_tensor(v, device=dev) for k, v in make_lm_batch(
        0, LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.vocab_size).items()}
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        got = []
        for remat in (True, False):
            loss, _ = transformer.loss_fn(cfg.scaled(dtype=dtype,
                                                     remat=remat), model,
                                          batch)
            got.append([loss.detach()]
                       + list(torch.autograd.grad(loss, params)))
        on, off = got
        errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(on, off)]
        bits = all(torch.equal(a, b) for a, b in zip(on, off))
        ok = all(np.isfinite(errs)) and max(errs) <= REMAT_TOL[name]
        res[name] = {"loss": [float(on[0]), float(off[0])],
                     "max_rel": max(errs), "loss_rel": errs[0],
                     "bit_for_bit": bits}
        log(f"  {LM} {name}, {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens, remat "
            f"on vs off: loss {float(on[0]):.6f} / {float(off[0]):.6f}, "
            f"loss and {len(params)} gradients max |diff| {max(errs):.3g} x "
            f"max |value| (tol {REMAT_TOL[name]}), bit for bit: {bits} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"train: {LM} {name} remat on and off disagree "
                            f"({max(errs):.3g})")
        del got, on, off
    del model, params
    free_card()
    return res


def free_main_path():
    """After the last phase on the main path's artifacts: drop them (the
    servers' threads hold their pipelines in reference cycles, so collect
    those too), so the LM phases' peak device memory holds none of the
    retrieval index."""
    CTX.clear()
    FIRST.clear()
    gc.collect()


# ---------------------------------------------------------------------------
# phase 12: the card path agrees with the CPU path on a small input
# ---------------------------------------------------------------------------

def same_ranking(want, got):
    """(max score diff, ids swapped between near-tied neighbours, other id
    differences) of two responses to the same queries."""
    worst, swaps, bad = 0.0, 0, 0
    for w, g in zip(want.ranked, got.ranked):
        if w.doc_ids.shape != g.doc_ids.shape:
            bad += 1
            continue
        worst = max(worst, float(np.abs(w.scores - g.scores).max()))
        for j in np.nonzero(w.doc_ids != g.doc_ids)[0]:
            # allowed: two candidates within AGREE_TOL trading places
            swaps += 1
            bad += not any(0 <= n < len(w.doc_ids)
                           and w.doc_ids[n] == g.doc_ids[j]
                           and abs(w.scores[n] - w.scores[j]) <= AGREE_TOL
                           for n in (j - 1, j + 1))
    return worst, swaps, bad


def cell_of(index) -> np.ndarray:
    """The cell each doc sits in (-1 for a doc no cell holds)."""
    ids = index.cell_ids.cpu().numpy()
    out = np.full(index.n_docs, -1, np.int64)
    cells = np.broadcast_to(np.arange(ids.shape[0])[:, None], ids.shape)
    out[ids[ids >= 0]] = cells[ids >= 0]
    return out


def check_fde_table(cpu_table, layout, dev, failures):
    """The FDE table built on the card against the one built on the CPU
    from the same layout. A token within rounding of a SimHash hyperplane
    may fall into another bucket (its sign test sums in another order), so
    the gate is the reference's own for that case (tests/test_fde.py:
    cosine > 0.98 per doc); the fp16 ulps are reported beside it."""
    import torch

    from repro_torch.core.fde import fde_from_layout
    card = fde_from_layout(layout, cpu_table.cfg,
                           dtype=str(cpu_table.vecs.dtype).split(".")[-1],
                           device=dev).vecs.cpu()
    ref = cpu_table.vecs
    a, b = card.float(), ref.float()
    ulp = (card.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(1e-9)
    rows_off = int((ulp > 1).any(-1).sum())
    ok = float(cos.min()) > 0.98
    log(f"  fde table card vs CPU on {ref.shape[0]:,} docs: "
        f"{int((ulp == 0).sum())} of {ulp.numel()} entries equal, "
        f"{int((ulp == 1).sum())} 1 ulp apart, {int((ulp > 1).sum())} more "
        f"(in {rows_off} docs), min cosine {float(cos.min()):.6f} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("fde table built on the card disagrees with the CPU")


def agreement(dev, failures):
    """At the main path's retrieval settings, so the chunked probe merge
    (nprobe > probe_chunk) and the full 1000-candidate rerank run on both
    sides; 512 cells keep nprobe=128 a quarter of the index. The corpus,
    index, layout and side tables are built once on the CPU; the card
    pipeline gets the same ones, so what is compared is the query path
    (the card's own FDE table is held to the CPU's apart)."""
    import dataclasses

    from repro_torch.core.pool import pool_corpus
    from repro_torch.pipeline import Pipeline, PipelineConfig
    from repro_torch.storage.layout import pack
    base = PipelineConfig()
    base.corpus.n_docs, base.corpus.n_queries = 20_000, 32
    base.index.ncells = 512
    base.retrieval.nprobe = NPROBE
    base.retrieval.k_candidates = K_CANDIDATES
    base.retrieval.prefetch_step = PREFETCH_STEP
    with Pipeline.build(base, device="cpu") as built:
        corpus, index, ragged = built.corpus, built.index, built.layout
    t0 = time.perf_counter()
    fixed = pack(corpus.cls, pool_corpus(corpus.bow, POOL_K),
                 dtype=np.dtype(base.storage.dtype), mode="fixed_stride",
                 pool_k=POOL_K)
    log(f"  fixed_stride layout of the 20,000 docs (pool_k={POOL_K}, "
        f"sequential pool_corpus) in {time.perf_counter() - t0:.1f} s")
    tables: dict = {}
    cases = [("espn", {}), ("gds", {}), ("mmap", {}), ("swap", {}),
             ("dram", {}), ("bitvec", {}), ("fde", {}), ("cascade", {}),
             ("fde", {"fde_brute_threshold": 0}), ("cspn", {})]
    for mode, extra in cases:
        cfg = dataclasses.replace(base, retrieval=dataclasses.replace(
            base.retrieval, mode=mode, **extra))
        layout = ragged
        if mode == "cspn":
            layout = fixed
            cfg.storage = dataclasses.replace(
                cfg.storage, layout_mode="fixed_stride", pool_k=POOL_K)
        what = mode + (" (IVF over FDEs)" if extra else "") \
            + (" (fixed_stride)" if mode == "cspn" else "")
        with Pipeline.from_artifacts(cfg, index=index, layout=layout,
                                     corpus=corpus, device="cpu",
                                     **tables) as cpu:
            for name in ("bits", "fde"):
                if getattr(cpu.tier, name) is not None:
                    tables.setdefault(name, getattr(cpu.tier, name))
            want = cpu.search()
            with Pipeline.from_artifacts(cfg, index=index, layout=layout,
                                         corpus=corpus, device=dev,
                                         **tables) as card:
                if extra:
                    # k-means sums in no fixed order on the card: report
                    # how far its own IVF over the FDEs agrees, then hold
                    # the query path on the CPU's
                    same = float(np.mean(cell_of(card.backend.fde_index)
                                         == cell_of(cpu.backend.fde_index)))
                    log(f"  {what}: the card's k-means puts {same:.4f} of "
                        f"the docs in the CPU's cell")
                    card.backend.fde_index = cpu.backend.fde_index.to(dev)
                got = card.search()
        worst, swaps, bad = same_ranking(want, got)
        same_bill = want.breakdown.as_dict() == got.breakdown.as_dict()
        ok = worst <= AGREE_TOL and same_bill and bad == 0
        log(f"  {what} card vs CPU on 20,000 docs: max score diff "
            f"{worst:.3g} (tol {AGREE_TOL}), {swaps} ids swapped between "
            f"near-tied neighbours, {bad} other id differences, simulated "
            f"bill {'equal' if same_bill else 'DIFFERS'} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{what}: card path disagrees with CPU path")
    check_fde_table(tables["fde"], ragged, dev, failures)
    check_reproducible_builds(corpus, ragged, base, tables["fde"].cfg, dev,
                              failures)
    agreement_serving(dev, failures, base, corpus, index, ragged, fixed,
                      tables)
    agreement_cluster(dev, failures, base, corpus, index, ragged, tables)
    agreement_mutation(dev, failures, base, corpus, index, ragged, fixed,
                       tables)


def check_reproducible_builds(corpus, layout, cfg, fde_cfg, dev, failures):
    """The card's IVF index and FDE table, each built twice from the same
    input, are the same bits: their sums run in a fixed order (segment
    sums, no atomics), so a saved index can be rebuilt exactly."""
    import torch

    from repro_torch.core.fde import fde_from_layout
    from repro_torch.core.ivf import build_ivf
    ix = cfg.index
    a, b = (build_ivf(corpus.cls, ncells=ix.ncells, iters=ix.iters,
                      device=dev) for _ in range(2))
    same_ivf = (torch.equal(a.centroids, b.centroids)
                and torch.equal(a.cell_ids, b.cell_ids)
                and torch.equal(a.cell_vecs, b.cell_vecs))
    f, g = (fde_from_layout(layout, fde_cfg, device=dev).vecs
            for _ in range(2))
    same_fde = torch.equal(f, g)
    log(f"  card builds twice from the same input: IVF index "
        f"{'equal' if same_ivf else 'DIFFERS'}, FDE table "
        f"{'equal' if same_fde else 'DIFFERS'}")
    if not (same_ivf and same_fde):
        failures.append("a card build is not reproducible")


# high fault rates, so every mode's reads see errors, retries, stalls and
# corruptions; half the modes without checksums (undetected sign flips)
AGREE_FAULTS = dict(read_error_rate=0.5, stall_rate=0.3, corruption_rate=0.5,
                    read_retries=1, seed=1)


def agreement_serving(dev, failures, base, corpus, index, ragged, fixed,
                      tables):
    """On the 20,000 docs: with faults on, the card and the CPU give equal
    ids, degraded flags, fault counters and bills in every single-tier
    mode; tracing changes nothing on the card; and a directory saved on
    the card loads on the CPU and answers as the card does."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.pipeline import Pipeline
    from repro_torch.storage.faults import FaultConfig
    halves = [(corpus.queries_cls[sl], corpus.queries_bow[sl],
               corpus.query_lens[sl]) for sl in (slice(0, 16),
                                                 slice(16, 32))]

    def cfg_for(mode, **sections):
        cfg = dataclasses.replace(base, retrieval=dataclasses.replace(
            base.retrieval, mode=mode), **sections)
        if mode == "cspn":
            cfg.storage = dataclasses.replace(
                cfg.storage, layout_mode="fixed_stride", pool_k=POOL_K)
        return cfg

    def run(cfg, device, mode):
        with Pipeline.from_artifacts(
                cfg, index=index, layout=fixed if mode == "cspn" else ragged,
                corpus=corpus, device=device, **tables) as p:
            return [p.search(*q) for q in halves], dict(p.tier.stats)

    modes = ("espn", "gds", "mmap", "swap", "dram", "bitvec", "fde",
             "cascade", "cspn")
    events = defaultdict(int)
    for i, mode in enumerate(modes):
        cfg = cfg_for(mode, faults=FaultConfig(**AGREE_FAULTS,
                                               checksum=bool(i % 2)))
        (want, w_stats), (got, g_stats) = run(cfg, "cpu", mode), \
            run(cfg, dev, mode)
        worst, bad, same = 0.0, 0, w_stats == g_stats
        for w, g in zip(want, got):
            d, _, b = same_ranking(w, g)
            worst, bad = max(worst, d), bad + b
            same &= (w.breakdown.as_dict() == g.breakdown.as_dict()
                     and [r.degraded for r in w.ranked]
                     == [r.degraded for r in g.ranked])
        for k in ("read_errors", "retries", "stalls", "checksum_failures",
                  "corruptions_injected"):
            events[k] += w_stats[k]
        events["degraded"] += sum(r.breakdown.degraded_queries for r in want)
        ok = worst <= AGREE_TOL and bad == 0 and same
        log(f"  {mode} with faults (checksums {'on' if i % 2 else 'off'}) "
            f"card vs CPU: max score diff {worst:.3g}, {bad} id "
            f"differences, degraded flags, counters and bills "
            f"{'equal' if same else 'DIFFER'} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{mode} with faults: card disagrees with CPU")
    log(f"  fault events over the faulted modes (CPU side): "
        f"{dict(events)}")
    if not (events["degraded"] and events["corruptions_injected"]
            and events["retries"]):
        failures.append("faulted agreement: some fault kind never fired")
    for mode in ("espn", "bitvec"):
        plain, _ = run(cfg_for(mode), dev, mode)
        traced_cfg = cfg_for(mode)
        traced_cfg.obs = dataclasses.replace(traced_cfg.obs, trace=True)
        traced, _ = run(traced_cfg, dev, mode)
        same = all(same_bits(a, b) for a, b in zip(plain, traced))
        log(f"  {mode} on the card traced vs untraced: "
            f"{'bitwise equal' if same else 'DIFFER'}")
        if not same:
            failures.append(f"{mode}: tracing changed the card's answers")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="agree-", dir=os.path.join(ROOT, "build"))
    try:
        with Pipeline.from_artifacts(cfg_for("cascade"), index=index,
                                     layout=ragged, corpus=corpus,
                                     device=dev, **tables) as card:
            card.save(root)
            with card.with_mode("espn") as espn:
                want = {"cascade": card.search(), "espn": espn.search()}
        for mode in ("cascade", "espn"):
            with Pipeline.load(root, mode=mode, device="cpu") as cpu:
                got = cpu.search()
            worst, swaps, bad = same_ranking(want[mode], got)
            same_bill = (want[mode].breakdown.as_dict()
                         == got.breakdown.as_dict())
            ok = worst <= AGREE_TOL and bad == 0 and same_bill
            log(f"  {mode} saved on the card, loaded on the CPU: max score "
                f"diff {worst:.3g}, {swaps} near-tie swaps, {bad} other id "
                f"differences, bill {'equal' if same_bill else 'DIFFERS'} "
                f"-> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{mode}: card-saved directory answers "
                                "otherwise on the CPU")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def agreement_cluster(dev, failures, base, corpus, index, layout, tables):
    """On the 20,000 docs, the reference's CI cluster settings (ci.yml:
    hedged + cached, faulted, traced) and the faulted agreement's high
    rates on 2 shards x 2 replicas (so retries, failovers, failed shard
    reads and degraded queries occur), two batches of 16 each on the CPU
    and on the card: the same ids (near ties within ``AGREE_TOL`` aside),
    degraded flags, bills, cluster, shard and arena-cache counters, and
    span names."""
    import dataclasses
    from collections import Counter

    from repro_torch.pipeline import Pipeline
    from repro_torch.pipeline.config import ClusterConfig, ObsConfig
    from repro_torch.storage.faults import FaultConfig
    halves = [(corpus.queries_cls[sl], corpus.queries_bow[sl],
               corpus.query_lens[sl]) for sl in (slice(0, 16),
                                                 slice(16, 32))]
    cases = {
        "hedged_cache": ("gds", dict(cluster=ClusterConfig(
            n_shards=4, replication=2, hedge_quantile=0.95,
            jitter_sigma=0.25, replica_mults=[3.0, 1.0],
            arena_cache_mb=8.0))),
        "faults": ("espn", dict(
            cluster=ClusterConfig(n_shards=2, replication=2),
            faults=FaultConfig(read_error_rate=0.02, stall_rate=0.02,
                               corruption_rate=0.02, read_retries=2,
                               checksum=True))),
        "traced": ("espn", dict(cluster=ClusterConfig(n_shards=2),
                                obs=ObsConfig(trace=True))),
        "faults_high": ("espn", dict(
            cluster=ClusterConfig(n_shards=2, replication=2),
            faults=FaultConfig(**AGREE_FAULTS)))}

    def run(cfg, device):
        with Pipeline.from_artifacts(cfg, index=index, layout=layout,
                                     corpus=corpus, device=device,
                                     **tables) as p:
            resps = [p.search(*q) for q in halves]
            spans = (Counter(sp.name for sp in p.tracer.spans())
                     if p.tracer is not None else None)
            return resps, (p.tier.stats, p.tier.per_shard_stats(),
                           p.tier.arena_cache.stats(), spans)

    for name, (mode, sections) in cases.items():
        cfg = dataclasses.replace(base, retrieval=dataclasses.replace(
            base.retrieval, mode=mode), **sections)
        (want, w_counters), (got, g_counters) = run(cfg, "cpu"), \
            run(cfg, dev)
        worst, bad, same = 0.0, 0, w_counters == g_counters
        for w, g in zip(want, got):
            d, _, b = same_ranking(w, g)
            worst, bad = max(worst, d), bad + b
            same &= (w.breakdown.as_dict() == g.breakdown.as_dict()
                     and [r.degraded for r in w.ranked]
                     == [r.degraded for r in g.ranked])
        st = w_counters[0]
        ok = worst <= AGREE_TOL and bad == 0 and same
        log(f"  cluster {name} ({mode}) card vs CPU: max score diff "
            f"{worst:.3g}, {bad} id differences, bills, cluster/shard/cache "
            f"counters and spans {'equal' if same else 'DIFFER'} (hedged "
            f"{st['hedged_reads']}, won {st['hedge_wins']}, cache hits "
            f"{st['cache_hits']}, faults {st['faults_injected']}, failovers "
            f"{st['failovers']}, failed shard reads "
            f"{st['shard_read_failures']}, degraded "
            f"{sum(r.breakdown.degraded_queries for r in want)}) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"cluster {name}: card disagrees with CPU")


def agreement_mutation(dev, failures, base, corpus, index, ragged, fixed,
                       tables):
    """On the 20,000 docs, a churn on a mutable 2 x 2 cluster in every mode,
    the same on the CPU and on the card: ingest 200 fresh docs, tombstone
    300 base docs and ~30% of the new ones, compact, ingest 200 more,
    tombstone again, rebalance; then two batches of 16. The same ids (near
    ties within ``AGREE_TOL`` aside), bills, compaction and rebalance
    reports, and every cluster and mutation counter. Each side starts from
    its own copy of the CPU-built index and tables (the card's FDE table
    on the card, so its appends are the card's)."""
    import dataclasses

    from repro_torch.core.fde import FDETable
    from repro_torch.data.synthetic import make_corpus
    from repro_torch.pipeline import Pipeline
    from repro_torch.pipeline.config import ClusterConfig, MutationConfig
    from repro_torch.storage.layout import BitTable
    halves = [(corpus.queries_cls[sl], corpus.queries_bow[sl],
               corpus.query_lens[sl]) for sl in (slice(0, 16),
                                                 slice(16, 32))]
    new = make_corpus(n_docs=400, n_queries=1, seed=INGEST_SEED)

    def copies(device):
        out = {}
        if "bits" in tables:
            b = tables["bits"]
            out["bits"] = BitTable(packed=b.packed.copy(),
                                   starts=b.starts.copy(), d_bow=b.d_bow)
        if "fde" in tables:
            f = tables["fde"]
            out["fde"] = FDETable(vecs=f.vecs.to(device, copy=True),
                                  cfg=f.cfg)
        return out

    def run(cfg, device, layout):
        rng = np.random.default_rng(5)
        reports = []
        with Pipeline.from_artifacts(cfg, index=index, layout=layout,
                                     corpus=corpus, device=device,
                                     **copies(device)) as p:
            for i, sl in enumerate((slice(0, 200), slice(200, 400))):
                gids = p.ingest(new.cls[sl].astype(np.float32), new.bow[sl])
                dead = np.concatenate([
                    rng.choice(corpus.n_docs, 300, replace=False),
                    gids[rng.random(len(gids)) < 0.3]])
                p.delete(dead[p.tier.alive[dead]])
                reports.append(p.compact() if i == 0 else p.rebalance())
            resps = [p.search(*h) for h in halves]
            alive = p.tier.alive.copy()
            counters = (dict(p.tier.stats), p.tier.per_shard_stats())
        return resps, reports, counters, alive

    modes = ("espn", "gds", "mmap", "swap", "dram", "bitvec", "fde",
             "cascade", "cspn")
    for mode in modes:
        cfg = dataclasses.replace(
            base, retrieval=dataclasses.replace(base.retrieval, mode=mode),
            cluster=ClusterConfig(n_shards=2, replication=2),
            mutation=MutationConfig(enabled=True))
        layout = ragged
        if mode == "cspn":
            layout = fixed
            cfg.storage = dataclasses.replace(
                cfg.storage, layout_mode="fixed_stride", pool_k=POOL_K)
        want, w_rep, w_counters, w_alive = run(cfg, "cpu", layout)
        got, g_rep, g_counters, g_alive = run(cfg, dev, layout)
        worst, bad = 0.0, 0
        same = (w_counters == g_counters and w_rep == g_rep
                and np.array_equal(w_alive, g_alive))
        dead_seen = 0
        for w, g in zip(want, got):
            d, _, b = same_ranking(w, g)
            worst, bad = max(worst, d), bad + b
            same &= w.breakdown.as_dict() == g.breakdown.as_dict()
            dead_seen += sum(int((~g_alive[r.doc_ids]).sum())
                             for r in g.ranked)
        st = w_counters[0]
        ok = worst <= AGREE_TOL and bad == 0 and same and dead_seen == 0
        log(f"  churned {mode} (2x2 mutable) card vs CPU: max score diff "
            f"{worst:.3g}, {bad} id differences, {dead_seen} tombstoned ids "
            f"answered, bills, reports and counters "
            f"{'equal' if same else 'DIFFER'} (ingested "
            f"{st['ingested_docs']}, tombstones {st['tombstones']}, "
            f"compactions {st['compactions']}, migration bytes "
            f"{st['migration_bytes']:,}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"churned {mode}: card disagrees with CPU")


# ---------------------------------------------------------------------------
# phases 13-14: the LM serving path (prefill, then KV-cache decode)
# ---------------------------------------------------------------------------

LM = "smollm-135m"              # full width and depth
DECODE_BATCH, PROMPT_LEN, DECODE_STEPS = 8, 4096, 32
ROUTE_TIE = 1e-6    # card vs CPU in fp32: an MoE expert choice may differ
                    # only where the k-th and (k+1)-th router probabilities
                    # lie within this


def numpy_params(table, rng) -> dict:
    """The reference's init from a numpy generator, in its sorted name
    order over ``table`` (a model's ``param_table``): LeCun-normal dense
    weights, N(0, 0.02) embeddings, ones for the norms, zeros for the
    biases; nested by "/" as the reference's params."""
    out: dict = {}
    for name, (shape, kind) in sorted(table.items()):
        if kind in ("ones", "zeros"):
            a = np.full(shape, kind == "ones", np.float32)
        else:
            std = 0.02 if kind == "embed" else 1 / np.sqrt(shape[-2])
            a = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
        *parents, leaf = name.split("/")
        d = out
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = a
    return out


def greedy(logits, vocab: int):
    """The next tokens (B,): argmax over the true vocab."""
    return logits[:, :vocab].float().argmax(dim=-1)


def lm_model(cfg, dev, rng):
    """Random weights for ``cfg`` drawn on the card: the reference's init
    kinds through ``transformer.init_params`` on a CUDA generator seeded
    from ``rng`` (fast at any size; llama4-scout's ~6.5 B would take long
    on the host)."""
    import torch

    from repro_torch.models import transformer
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(2**31)))
    return transformer.init_params(cfg, gen, dev)


class MoERecorder:
    """Each MoE layer call's aux loss and keep mask, read by wrapping
    ``moe.route`` and ``moe.dispatch`` while it is entered (the port carries
    no instrumentation); the tensors stay on their device until read. With
    ``routes``, also each call's router probabilities (recomputed as
    ``route`` computes them) and experts, copied to the host."""

    def __init__(self, routes=False):
        self.routes = routes

    def __enter__(self):
        import torch

        from repro_torch.models import moe
        self.aux, self.keep, self.probs, self.experts = [], [], [], []
        self._orig = moe.route, moe.dispatch
        route, dispatch = self._orig

        def routed(x, router_w, cfg):
            out = route(x, router_w, cfg)
            self.aux.append(out[2].detach())
            if self.routes:
                self.probs.append(torch.softmax(
                    x.float() @ router_w.float(), dim=-1).detach().cpu())
                self.experts.append(out[1].cpu())
            return out

        def dispatched(*a, **kw):
            out = dispatch(*a, **kw)
            self.keep.append(out[1])
            return out
        moe.route, moe.dispatch = routed, dispatched
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route, moe.dispatch = self._orig


def decode_path(dev, failures, arch=LM, n_layers=None, prompt_len=PROMPT_LEN,
                steps=DECODE_STEPS) -> dict:
    """``arch`` at full width (all its layers, or ``n_layers``) on the card,
    bf16 activations over fp32 masters, random weights drawn on the card
    from seed 0 (``lm_model``): 8 requests of ``prompt_len`` random
    token ids prefilled, then ``steps`` greedy decode steps, as a server
    answering them would. The first half of the steps run as they are
    (their wall is the step time); for the second half ``StageClock`` wraps
    the flash_decode call with synchronisation, to split the step. An MoE
    model's prefill also gives its aux loss and the tokens each layer
    dropped (``MoERecorder``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.moe import capacity
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.scaled(n_layers=n_layers)
    b = DECODE_BATCH
    rng = np.random.default_rng(0)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = lm_model(cfg, dev, rng)
    n_params = sum(p.numel() for p in model.parameters())
    prompts = torch.tensor(rng.integers(0, cfg.vocab_size, (b, prompt_len)),
                           device=dev)
    cache = transformer.init_cache(cfg, b, prompt_len + steps, dev)
    torch.cuda.synchronize()
    cache_bytes = sum(cache[k].numel() * cache[k].element_size()
                      for k in ("k", "v"))
    moe = cfg.moe
    log(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads of "
        f"{cfg.head_dim}, "
        + (f"{moe.n_experts} experts top-{moe.top_k} of d_ff "
           f"{moe.d_ff_expert} + {moe.n_shared_experts} shared, "
           if moe else f"d_ff {cfg.d_ff}, ")
        + f"vocab {cfg.vocab_size}; {n_params:,} fp32 params (drawn "
        f"on the card) on {dev}, {cache_bytes / 1e6:.0f} MB bf16 cache of "
        f"{prompt_len + steps} slots; set up in "
        f"{time.perf_counter() - t0:.1f} s")

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with MoERecorder() as rec:
        logits, cache = transformer.prefill(cfg, model, prompts, cache)
    tok = greedy(logits, cfg.vocab_size)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    clock = StageClock()
    walls, kernel_s = [], []
    try:
        for step in range(steps):
            if step == steps // 2:
                clock.wrap(transformer, "flash_decode", "flash_decode",
                           sync=True)
            clock.s.clear()
            t0 = time.perf_counter()
            pos = torch.full((b,), cache["length"], dtype=torch.int32,
                             device=dev)
            logits, cache = transformer.decode_step(cfg, model, tok[:, None],
                                                    pos, cache)
            tok = greedy(logits, cfg.vocab_size)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            kernel_s.append(clock.s["flash_decode"])
            finite &= bool(torch.isfinite(logits).all())
    finally:
        clock.restore()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    plain = np.array(walls[:steps // 2]) * 1e3
    synced = np.array(walls[steps // 2:]) * 1e3
    kern = np.array(kernel_s[steps // 2:]) * 1e3
    want = cfg.n_layers * steps
    out = {"arch": arch, "n_layers": cfg.n_layers, "n_params": n_params,
           "prefill_s": prefill_s, "step_ms": plain.tolist(),
           "tokens_per_s": b * len(plain) / (plain.sum() / 1e3),
           "synced_step_ms": synced.tolist(),
           "flash_decode_ms_per_step": kern.tolist(),
           "peak_bytes": peak, "launches": launches,
           "length": cache["length"]}
    log(f"  prefill of {b} x {prompt_len} tokens: {prefill_s:.3f} s "
        f"({b * prompt_len / prefill_s:,.0f} tokens/s)")
    if moe:
        cap = capacity(prompt_len, moe)
        dropped = [int((~k).sum()) for k in rec.keep]
        out.update(prefill_aux=float(torch.stack(rec.aux).sum()),
                   capacity=cap, dropped_per_layer=dropped)
        log(f"  prefill MoE: capacity {cap} a group, aux loss "
            f"{out['prefill_aux']:.4f} summed over {len(rec.aux)} layers; "
            f"tokens dropped per layer (of {b * prompt_len * moe.top_k} "
            f"choices) {dropped}")
        if len(rec.keep) != cfg.n_layers or not np.isfinite(
                out["prefill_aux"]):
            failures.append(f"decode {arch}: {len(rec.keep)} MoE layers "
                            f"ran, aux {out['prefill_aux']}")
    log(f"  decode steps 0-{steps // 2 - 1}: wall per step median "
        f"{np.median(plain):.3f} ms (range {plain.min():.3f}-"
        f"{plain.max():.3f}), {out['tokens_per_s']:,.1f} tokens/s at "
        f"batch {b}")
    log(f"  decode steps {steps // 2}-{steps - 1}, each flash_decode launch "
        f"synchronised: wall median {np.median(synced):.3f} ms (range "
        f"{synced.min():.3f}-{synced.max():.3f}), of it the "
        f"{cfg.n_layers} flash_decode launches {np.median(kern):.3f} ms and "
        f"the rest {np.median(synced - kern):.3f} ms")
    log(f"  launches {json.dumps(launches)}; cache length "
        f"{cache['length']}; logits {tuple(logits.shape)} "
        f"{'finite' if finite else 'NOT finite'}; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    if launches["flash_decode"] != want:
        failures.append(f"decode {arch}: flash_decode launched "
                        f"{launches['flash_decode']} times, not {want}")
    if cache["length"] != prompt_len + steps:
        failures.append(f"decode {arch}: cache length {cache['length']}")
    if not finite or tuple(logits.shape) != (
            b, transformer.padded_vocab(cfg.vocab_size)):
        failures.append(f"decode {arch}: logits not finite or misshapen")
    del model, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def decode_agreement(dev, failures, arch=LM, tol=1e-4):
    """``arch`` at full width, 2 layers, in fp32: 2 prompts of 64 tokens,
    then 8 greedy decode steps, on the card (flash_decode) and on the CPU
    (its plain version) from the same numpy weights. Logits within ``tol``
    x max(1, |ref|) (fp32 sums in other orders over 2 layers; SmolLM's
    1e-4, granite's 2e-5), greedy tokens equal.

    An MoE model's routing is recorded on both (``MoERecorder``): an
    expert choice may differ only at a near tie (the CPU's k-th and
    (k+1)-th router probabilities within ``ROUTE_TIE``), each logged by
    name; a request whose routing differed is compared no further, and
    where the routing agrees the keep masks (drops included: 64 tokens
    top-8 over 32 experts of capacity 24 for granite) are equal."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config(arch).scaled(n_layers=2, dtype=torch.float32)
    b, prompt_len, steps = 2, 64, 8
    rng = np.random.default_rng(1)
    params = numpy_params(transformer.param_table(cfg), rng)
    prompt = rng.integers(0, cfg.vocab_size, (b, prompt_len))
    runs, recs = {}, {}
    for where in (dev, torch.device("cpu")):
        model = convert.transformer_params_from_numpy(params, cfg, where)
        cache = transformer.init_cache(cfg, b, prompt_len + steps, where)
        with MoERecorder(routes=True) as recs[where.type]:
            logits, cache = transformer.prefill(
                cfg, model, torch.tensor(prompt, device=where), cache)
            seq = [logits.cpu()]
            for _ in range(steps):
                tok = greedy(logits, cfg.vocab_size)
                pos = torch.full((b,), cache["length"], dtype=torch.int32,
                                 device=where)
                logits, cache = transformer.decode_step(
                    cfg, model, tok[:, None], pos, cache)
                seq.append(logits.cpu())
        runs[where.type] = seq
        del model, cache
    # the step (0: prefill) at which each request's routing first differed
    first_flip = {}
    if cfg.moe:
        card, cpu = recs[dev.type], recs["cpu"]
        k, n_keep_diff, n_dropped = cfg.moe.top_k, 0, 0
        for i, (e_card, e_cpu, p_cpu) in enumerate(zip(
                card.experts, cpu.experts, cpu.probs)):
            step, layer = divmod(i, cfg.n_layers)
            differ = (e_card.sort(-1).values != e_cpu.sort(-1).values).any(-1)
            for g, t in differ.nonzero().tolist():
                p = p_cpu[g, t].sort(descending=True).values
                gap = float(p[k - 1] - p[k])
                near = gap <= ROUTE_TIE
                log(f"  routing differs: {'prefill' if step == 0 else f'step {step}'}"
                    f" layer {layer} request {g} token {t}: card experts "
                    f"{e_card[g, t].tolist()}, CPU {e_cpu[g, t].tolist()}; "
                    f"CPU k-th minus (k+1)-th probability {gap:.3g} -> "
                    f"{'near tie' if near else 'NOT a near tie'}")
                if not near:
                    failures.append(f"decode {arch}: an expert choice "
                                    f"differs away from a tie")
                first_flip[g] = min(first_flip.get(g, step), step)
            for g in range(b):
                if g not in first_flip and not torch.equal(
                        card.keep[i][g].cpu(), cpu.keep[i][g].cpu()):
                    n_keep_diff += 1
            n_dropped += int((~cpu.keep[i]).sum())
        log(f"  {arch} routing, card vs CPU: {len(cpu.experts)} MoE calls, "
            f"{n_dropped} of the CPU's choices dropped, requests whose "
            f"routing differed {sorted(first_flip) or 'none'}; keep masks "
            f"{'equal' if not n_keep_diff else f'DIFFER in {n_keep_diff}'}"
            " where the routing agrees")
        if n_keep_diff or len(card.experts) != len(cpu.experts):
            failures.append(f"decode {arch}: keep masks differ")
    worst, same_tokens, compared = 0.0, True, 0
    for step, (card, cpu) in enumerate(zip(runs[dev.type], runs["cpu"])):
        rows = [g for g in range(b) if first_flip.get(g, steps + 1) > step]
        compared += len(rows)
        if not rows:
            continue
        card, cpu = card[rows], cpu[rows]
        err = float((card - cpu).abs().max())
        worst = max(worst, err / max(1.0, float(cpu.abs().max())))
        same_tokens &= bool(torch.equal(greedy(card, cfg.vocab_size),
                                        greedy(cpu, cfg.vocab_size)))
    ok = worst <= tol and same_tokens and compared > 0
    log(f"  {arch} fp32, 2 layers, {b} x {prompt_len}-token prompts + "
        f"{steps} steps, card vs CPU: max logit diff {worst:.3g} x max(1, "
        f"|ref|) (tol {tol}) over {compared} of {b * (steps + 1)} request "
        f"steps, greedy tokens {'equal' if same_tokens else 'DIFFER'} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"decode {arch}: the card's logits disagree with "
                        f"the CPU's")


def onehot_decode(dev, failures, steps=4):
    """``LM`` at full width and depth (bf16 over fp32 masters drawn on the
    card), ``DECODE_BATCH`` prompts of 64 tokens, then ``steps`` greedy
    decode steps with ``onehot_cache_update`` off and on from the same
    weights: every step's logits and the caches bit for bit, and
    flash_decode launched once a layer a step either way."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config(LM)
    model = lm_model(cfg, dev, np.random.default_rng(2))
    prompt = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (DECODE_BATCH, 64)), device=dev)
    saved, runs = read_counts(), []
    for onehot in (False, True):
        c = cfg.scaled(onehot_cache_update=onehot)
        cache = transformer.init_cache(c, DECODE_BATCH, 64 + steps, dev)
        logits, cache = transformer.prefill(c, model, prompt, cache)
        reset_counts()
        seq = []
        for _ in range(steps):
            pos = torch.full((DECODE_BATCH,), cache["length"],
                             dtype=torch.int32, device=dev)
            logits, cache = transformer.decode_step(
                c, model, greedy(logits, cfg.vocab_size)[:, None], pos,
                cache)
            seq.append(logits)
        runs.append((seq, cache, read_counts()["flash_decode"]))
    restore_counts(saved)
    (off, c_off, n_off), (on, c_on, n_on) = runs
    same = (all(torch.equal(a, b) for a, b in zip(off, on))
            and all(torch.equal(c_off[k], c_on[k])
                    for k in ("k", "v", "slot_pos")))
    want = cfg.n_layers * steps
    ok = same and n_off == n_on == want
    log(f"  {LM} onehot_cache_update off vs on, {DECODE_BATCH} x 64 + "
        f"{steps} steps: logits and caches {'equal' if same else 'DIFFER'} "
        f"bit for bit; flash_decode launches {n_off} / {n_on} (want {want}) "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("decode: onehot_cache_update changes the decode")
    del model, runs
    free_card()


# phase 16 [moe]: arch -> (layers run, None for all; prompt tokens; decode
# steps), each served at DECODE_BATCH, its weights drawn on the card (fast
# at any size)
MOE_LM = "granite-moe-1b-a400m"     # served, trained and held card vs CPU
MOE_DECODES = {
    MOE_LM: (None, PROMPT_LEN, DECODE_STEPS),
    "qwen2-0.5b": (None, PROMPT_LEN, DECODE_STEPS),
    # depth 2 of 48: at full depth ~108 B params (431 GB fp32) fit no card
    "llama4-scout-17b-a16e": (2, 1024, 8),
}
MOE_KERNELS = {f"decode {arch}": ("flash_decode",) for arch in MOE_DECODES}
MOE_AGREE_TOL = 2e-5    # granite fp32 card vs CPU, where routing agrees


def moe_phase(dev, failures) -> dict:
    """The other LM configs on the card, bf16 over fp32 masters: each of
    ``MOE_DECODES`` served by ``decode_path`` (flash_decode once a layer a
    step, or the run fails); granite trained by ``lm_train`` (no kernel may
    launch); granite in fp32 at 2 layers held card vs CPU by
    ``decode_agreement``, routing recorded. TF32 stays off: the routers'
    fp32 logits decide which experts run."""
    from repro_torch.configs import get_config
    tf32_off(failures, "before [moe]")
    out = {}
    for arch, (layers, prompt, steps) in MOE_DECODES.items():
        out[f"decode {arch}"] = decode_path(dev, failures, arch, layers,
                                            prompt, steps)
    reset_counts()
    out["train"] = lm_train(dev, failures, get_config(MOE_LM))
    launched = {k: v for k, v in read_counts().items() if v}
    log(f"  kernel launches in {MOE_LM}'s training: {launched or 'none'}")
    if launched:
        failures.append(f"moe: kernels launched in training {launched}")
    decode_agreement(dev, failures, MOE_LM, MOE_AGREE_TOL)
    tf32_off(failures, "after [moe]")
    return out


# ---------------------------------------------------------------------------
# phases 17-18 [recsys], [gnn]: the RecSys models, ESPN-for-RecSys and
# GatedGCN at their published widths. The reference reaches no Pallas kernel
# on these paths (plain PyTorch here), so none of the six may launch.
# ---------------------------------------------------------------------------

RECSYS_ARCHS = ("fm", "autoint", "dlrm-mlperf", "two-tower-retrieval")
# rows a table holds (a depth cut): dlrm-mlperf's 96.1 GB and
# two-tower-retrieval's 207.2 GB of published fp32 tables fit no card;
# fm's and autoint's 1,000,000-row tables stay whole
SERVE_ROW_CAP = 20_000_000
TRAIN_ROW_CAP = 4_000_000       # params, grads and AdamW's two moments
RECSYS_TRAIN_STEPS = 3
# two-tower trains at 16,384 (its (B, B) fp32 logits and their gradient take
# ~34 GB at train_batch's 65,536)
TWO_TOWER_TRAIN_BATCH = 16_384
SERVE_REPS = {"serve_p99": 10, "serve_bulk": 3}
TOPK_REPS = 5
RECSYS_AGREE_BATCH, RECSYS_AGREE_CANDIDATES = 64, 4096
RECSYS_TOL = 1e-5       # fp32 card vs CPU: scores, logits, loss, grad norm
TOPK_TIE = 1e-6         # retrieval ids may differ only between neighbours
                        # whose CPU scores lie within this
# ESPN-for-RecSys: benchmarks/bench_espn_embedding.py's table and its three
# (overlap budget ms, candidates, hit fraction) settings; a fourth whose
# budget is two-tower's query-tower forward at serve_p99, measured here
ESPN_EMB_ROWS, ESPN_EMB_DIM = 2_000_000, 64
ESPN_EMB_SETTINGS = ((3.0, 1000, 0.9), (3.0, 4000, 0.9), (6.0, 16000, 0.85))
ESPN_EMB_MEASURED = (4000, 0.9)


def capped(cfg, cap: int):
    return cfg.scaled(table_sizes=tuple(min(r, cap) for r in cfg.table_sizes))


def recsys_batch(cfg, b: int, gen, dev, labels=True, n_cand=0) -> dict:
    """``b`` rows drawn on the card from ``gen``: ids uniform over each
    field's rows, dense features N(0, 1), 0/1 labels; two-tower: query and
    item ids, or the query's ``n_cand`` candidates."""
    import torch

    def ids(sizes, n):
        return torch.stack([torch.randint(0, r, (n,), generator=gen,
                                          device=dev) for r in sizes], dim=1)
    if cfg.variant == "two-tower":
        nq = cfg.n_query_fields
        items = "candidate_ids" if n_cand else "item_ids"
        return {"query_ids": ids(cfg.table_sizes[:nq], b),
                items: ids(cfg.table_sizes[nq:], n_cand or b)}
    out = {"sparse_ids": ids(cfg.table_sizes, b)}
    if cfg.n_dense:
        out["dense"] = torch.randn((b, cfg.n_dense), generator=gen,
                                   device=dev)
    if labels:
        out["labels"] = torch.randint(0, 2, (b,), generator=gen,
                                      device=dev).float()
    return out


def bits_digest(tree) -> list[int]:
    """Each fp32 leaf's bit patterns summed in int64 (exact in any order):
    two runs that differ in any one weight differ here."""
    import torch

    from repro_torch.train.optimizer import named_params
    return [int(t.detach().view(torch.int32).sum(dtype=torch.int64))
            for t in named_params(tree).values()]


def tree_to(tree, where):
    """A nested dict of tensors copied to ``where`` (fresh tensors even on
    the same device)."""
    return {k: tree_to(v, where) if isinstance(v, dict)
            else v.to(where, copy=True) for k, v in tree.items()}


def free_card():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def recsys_serve(dev, failures, arch) -> dict:
    """``arch`` at published widths, its tables capped at ``SERVE_ROW_CAP``
    rows, fp32 masters drawn on the card, bf16 compute: one serve_p99 and
    one serve_bulk batch through ``forward`` (ms a batch by events, rows/s,
    the same bits twice), a batch's loss twice; two-tower also the
    retrieval_cand shape (1 query, pad512(1,000,000) candidates, top 100)
    and its query tower alone at serve_p99 (the ESPN budget)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RECSYS_SHAPES, pad512
    from repro_torch.models import recsys
    from repro_torch.models.embedding import padded_rows
    pub = get_config(arch)
    cfg = capped(pub, SERVE_ROW_CAP)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = recsys.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    table_bytes = sum(t.numel() * t.element_size()
                      for t in params["tables"].values())
    pub_bytes = sum(padded_rows(r) * cfg.embed_dim * 4
                    for r in pub.table_sizes)
    res = {"table_bytes": table_bytes, "published_table_bytes": pub_bytes,
           "init_s": init_s}
    log(f"  {arch} ({cfg.variant}): {cfg.n_sparse} tables x embed_dim "
        f"{cfg.embed_dim}, {table_bytes / 1e9:.2f} GB fp32 on the card "
        f"(published {pub_bytes / 1e9:.2f} GB; rows capped at "
        f"{SERVE_ROW_CAP:,}), drawn in {init_s:.2f} s")
    with torch.no_grad():
        for shape in ("serve_p99", "serve_bulk"):
            b = RECSYS_SHAPES[shape].dims["batch"]
            batch = recsys_batch(cfg, b, gen, dev, labels=False)
            out = recsys.forward(cfg, params, batch)
            same = torch.equal(out, recsys.forward(cfg, params, batch))
            ms = time_ms(lambda: recsys.forward(cfg, params, batch),
                         reps=SERVE_REPS[shape], warmup=0)
            ok = (tuple(out.shape) == (b,) and bool(torch.isfinite(out).all())
                  and same)
            res[shape] = {"batch": b, "ms": ms, "rows_per_s": b / ms * 1e3,
                          "same_bits": same}
            log(f"  {arch} {shape} (batch {b:,}): {ms:.3f} ms a batch, "
                f"{b / ms * 1e3:,.0f} rows/s; scores finite, "
                f"{'the same bits twice' if same else 'BITS DIFFER'} -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"recsys {arch} {shape}: scores not finite "
                                f"or not the same twice")
        batch = recsys_batch(cfg, RECSYS_SHAPES["serve_p99"].dims["batch"],
                             gen, dev)
        losses = [recsys.loss_fn(cfg, params, batch)[0] for _ in range(2)]
        ok = bool(torch.isfinite(losses[0])) and torch.equal(*losses)
        res["loss"] = float(losses[0])
        log(f"  {arch} loss of a serve_p99 batch {res['loss']:.6f}, the same "
            f"bits twice: {torch.equal(*losses)} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"recsys {arch}: loss not finite or not the "
                            f"same twice")
        if cfg.variant == "two-tower":
            nc = pad512(RECSYS_SHAPES["retrieval_cand"].dims["n_candidates"])
            batch = recsys_batch(cfg, 1, gen, dev, n_cand=nc)
            v, i = recsys.retrieval_topk(cfg, params, batch, k=100)
            v2, i2 = recsys.retrieval_topk(cfg, params, batch, k=100)
            ms = time_ms(lambda: recsys.retrieval_topk(cfg, params, batch,
                                                       k=100),
                         reps=TOPK_REPS, warmup=0)
            ok = (tuple(i.shape) == (1, 100) and bool(torch.isfinite(v).all())
                  and bool((v[:, :-1] >= v[:, 1:]).all())
                  and int(i.max()) < nc and torch.equal(i, i2)
                  and torch.equal(v, v2))
            res["retrieval_cand"] = {"candidates": nc, "ms": ms,
                                     "top1": float(v[0, 0])}
            log(f"  {arch} retrieval_cand: 1 query x {nc:,} candidates, top "
                f"100 in {ms:.3f} ms; scores {float(v[0, -1]):.4f}.."
                f"{float(v[0, 0]):.4f}, descending, the same bits twice -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"recsys {arch}: retrieval_topk misshapen, "
                                f"unordered or not the same twice")
            q = recsys_batch(cfg, RECSYS_SHAPES["serve_p99"].dims["batch"],
                             gen, dev, labels=False)["query_ids"]
            res["query_tower_ms"] = time_ms(
                lambda: recsys.query_embed(cfg, params, q), reps=20, warmup=2)
            log(f"  {arch} query tower alone at serve_p99: "
                f"{res['query_tower_ms']:.4f} ms (the ESPN-for-RecSys "
                f"overlap budget)")
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    log(f"  {arch} serving peak device memory "
        f"{res['peak_bytes'] / 2**30:.2f} GiB")
    del params, batch
    free_card()
    return res


def recsys_train(dev, failures, arch) -> dict:
    """``arch`` at published widths, tables capped at ``TRAIN_ROW_CAP``
    rows: ``RECSYS_TRAIN_STEPS`` AdamW steps through ``make_train_step``
    from weights drawn on the card (ms a step, peak memory, finite loss
    and grad norm), then the first step again from the same draw: its
    weights the same bits (``bits_digest``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.models import recsys
    from repro_torch.train.optimizer import AdamW, named_params
    from repro_torch.train.trainer import make_train_step
    cfg = capped(get_config(arch), TRAIN_ROW_CAP)
    b = (TWO_TOWER_TRAIN_BATCH if cfg.variant == "two-tower"
         else RECSYS_SHAPES["train_batch"].dims["batch"])
    opt = AdamW()
    step = make_train_step(lambda p, bt: recsys.loss_fn(cfg, p, bt), opt)

    def run(steps):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = recsys.init_params(cfg, gen, dev)
        n = sum(t.numel() for t in named_params(params).values())
        for t in named_params(params).values():
            t.requires_grad_(True)
        state = opt.init(params)
        hist, digest = [], None
        for i in range(steps):
            batch = recsys_batch(cfg, b, gen, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            hist.append({"ms": (time.perf_counter() - t0) * 1e3,
                         "loss": float(m["loss"]),
                         "gnorm": float(m["gnorm"])})
            if i == 0:
                digest = bits_digest(params)
        return hist, digest, n

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    hist, digest, n = run(RECSYS_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    free_card()
    again, digest2, _ = run(1)
    free_card()
    finite = all(np.isfinite([h["loss"], h["gnorm"]]).all() for h in hist)
    same = digest == digest2 and again[0]["loss"] == hist[0]["loss"]
    ms = [h["ms"] for h in hist]
    res = {"batch": b, "n_params": n, "param_bytes": 4 * n,
           "step_ms": ms, "losses": [h["loss"] for h in hist],
           "gnorms": [h["gnorm"] for h in hist], "peak_bytes": peak,
           "rows_per_s": b / float(np.median(ms[1:])) * 1e3,
           "same_bits": same}
    log(f"  {arch} training: {n:,} fp32 params ({4 * n / 1e9:.2f} GB; rows "
        f"capped at {TRAIN_ROW_CAP:,}), {RECSYS_TRAIN_STEPS} AdamW steps of "
        f"{b:,} rows: step ms {[round(x, 1) for x in ms]}, "
        f"{res['rows_per_s']:,.0f} rows/s after the first; peak "
        f"{peak / 2**30:.2f} GiB; loss {[round(x, 5) for x in res['losses']]}"
        f", gnorm {[round(x, 5) for x in res['gnorms']]}; the first step "
        f"again: {'the same bits' if same else 'WEIGHTS DIFFER'} -> "
        f"{'ok' if finite and same else 'FAIL'}")
    if not finite or not same:
        failures.append(f"recsys {arch} training: a loss or grad norm is not "
                        f"finite, or a step is not the same twice")
    return res


def recsys_agreement(dev, failures) -> dict:
    """Each arch's ``smoke_config`` in fp32, the same weights (drawn on the
    CPU) and batch on the card and the CPU: the forward within
    ``RECSYS_TOL`` x max(1, |cpu|); one AdamW step's loss and grad norm
    within ``RECSYS_TOL``; two-tower's top 100 of 4,096 candidates with
    the CPU's ids up to neighbours within ``TOPK_TIE``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import recsys
    from repro_torch.train.optimizer import AdamW, named_params
    from repro_torch.train.trainer import make_train_step
    cpu = torch.device("cpu")
    out = {}
    for arch in RECSYS_ARCHS:
        cfg = recsys.smoke_config(get_config(arch)).scaled(
            dtype=torch.float32)
        gen = torch.Generator()
        gen.manual_seed(1)
        params = recsys.init_params(cfg, gen, cpu)
        batch = recsys_batch(cfg, RECSYS_AGREE_BATCH, gen, cpu)
        cand = recsys_batch(cfg, 1, gen, cpu, n_cand=RECSYS_AGREE_CANDIDATES)
        opt = AdamW(lr=1e-3, warmup_steps=2)
        step = make_train_step(lambda p, b: recsys.loss_fn(cfg, p, b), opt)
        got = {}
        for where in (cpu, dev):
            p, b = tree_to(params, where), tree_to(batch, where)
            top = ()
            with torch.no_grad():
                fwd = recsys.forward(cfg, p, {k: v for k, v in b.items()
                                              if k != "labels"}).cpu()
                if cfg.variant == "two-tower":
                    v, i = recsys.retrieval_topk(cfg, p, tree_to(cand, where),
                                                 k=100)
                    top = (v.cpu(), i.cpu())
            for t in named_params(p).values():
                t.requires_grad_(True)
            _, _, m = step(p, opt.init(p), b)
            got[where.type] = (fwd, float(m["loss"]), float(m["gnorm"]),
                               *top)
        (f0, l0, g0, *top0), (f1, l1, g1, *top1) = got["cpu"], got[dev.type]
        err = float((f1 - f0).abs().max()) / max(1.0, float(f0.abs().max()))
        dl = abs(l1 - l0) / max(1.0, abs(l0))
        dg = abs(g1 - g0) / max(1.0, abs(g0))
        ok = err <= RECSYS_TOL and dl <= RECSYS_TOL and dg <= RECSYS_TOL
        what = (f"forward {err:.3g} x max(1, |cpu|), one step's loss "
                f"{dl:.3g}, grad norm {dg:.3g}")
        if top0:
            v0, i0 = top0
            v1, i1 = top1
            moved = (i0 != i1).nonzero()[:, 1].tolist()
            ties = all(abs(float(v0[0, k]) - float(v1[0, k])) <= TOPK_TIE
                       for k in moved)
            ok &= ties and float((v1 - v0).abs().max()) <= RECSYS_TOL
            what += (f"; top 100 of {RECSYS_AGREE_CANDIDATES:,} ids "
                     f"{'equal' if not moved else f'{len(moved)} swapped'}"
                     f"{'' if ties else ' AWAY FROM A TIE'}")
        out[arch] = {"forward": err, "loss": dl, "gnorm": dg}
        log(f"  {arch} smoke config, fp32, card vs CPU: {what} (tol "
            f"{RECSYS_TOL}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"recsys {arch}: the card disagrees with the "
                            f"CPU at the smoke config")
    return out


def espn_embedding_run(dev, failures, tower_ms: float) -> dict:
    """``ESPNEmbeddingServer`` over a 2,000,000 x 64 fp16 table (drawn on
    the card, held on the host as the storage tier's image) at the
    benchmark's three settings and at the measured query-tower budget: hit
    rate, the simulated critical and direct I/O (the PM983 model's clock,
    not the card's), the gathered rows equal to a direct fetch's."""
    import torch

    from repro_torch.storage.espn_embedding import (EmbeddingBlockStore,
                                                    ESPNEmbeddingServer)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = torch.randn((ESPN_EMB_ROWS, ESPN_EMB_DIM), generator=gen,
                        device=dev, dtype=torch.float16).cpu().numpy()
    store = EmbeddingBlockStore(table=table)
    srv = ESPNEmbeddingServer(store)
    rng = np.random.default_rng(0)
    out = []
    log(f"  ESPN-for-RecSys: {ESPN_EMB_ROWS:,} x {ESPN_EMB_DIM} fp16 "
        f"({store.nbytes / 2**20:.0f} MiB, {store.rows_per_block} rows a "
        f"4 KiB block)")
    for budget_ms, n_cand, hit_frac in (ESPN_EMB_SETTINGS
                                        + ((tower_ms,) + ESPN_EMB_MEASURED,)):
        approx = rng.integers(0, ESPN_EMB_ROWS, int(n_cand / hit_frac))
        final = np.concatenate([
            approx[: int(n_cand * hit_frac)],
            rng.integers(0, ESPN_EMB_ROWS, n_cand - int(n_cand * hit_frac))])
        t0 = time.perf_counter()
        rows_p, st = srv.fetch(approx, final,
                               overlap_budget_s=budget_ms / 1e3)
        rows_d, st_d = srv.fetch_direct(final)
        host_s = time.perf_counter() - t0
        speedup = st_d.critical_io_s / max(st.critical_io_s, 1e-9)
        # (a prefetch longer than its budget leaks into the critical path,
        # where it can cost more than a direct fetch: not a failure)
        ok = np.array_equal(rows_p, rows_d) and st.hit_rate >= hit_frac - 0.01
        out.append({"budget_ms": budget_ms, "candidates": n_cand,
                    "hit_rate": st.hit_rate,
                    "critical_ms": st.critical_io_s * 1e3,
                    "direct_ms": st_d.critical_io_s * 1e3,
                    "prefetch_ms": st.prefetch_io_s * 1e3,
                    "speedup": speedup, "blocks": st.blocks,
                    "host_s": host_s})
        log(f"  budget {budget_ms:.4f} ms, {n_cand:,} candidates: hit "
            f"{st.hit_rate:.4f}, simulated critical I/O "
            f"{st.critical_io_s * 1e3:.4f} ms (prefetch "
            f"{st.prefetch_io_s * 1e3:.4f}, hidden {st.hidden_s * 1e3:.4f})"
            f" vs direct {st_d.critical_io_s * 1e3:.4f} ms: {speedup:.2f}x; "
            f"{st.blocks:,} blocks; host {host_s:.3f} s -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("recsys: an ESPN-for-RecSys fetch gave other rows "
                            "than a direct one, or a hit rate below its "
                            "setting")
    return out


def recsys_phase(dev, failures) -> dict:
    """The four RecSys configs served and trained at published widths
    (``recsys_serve``, ``recsys_train``), ESPN-for-RecSys
    (``espn_embedding_run``) and the smoke configs card vs CPU
    (``recsys_agreement``); no kernel may launch."""
    tf32_off(failures, "before [recsys]")
    free_card()
    reset_counts()
    out = {"serve": {a: recsys_serve(dev, failures, a) for a in RECSYS_ARCHS},
           "train": {a: recsys_train(dev, failures, a) for a in RECSYS_ARCHS}}
    out["espn_embedding"] = espn_embedding_run(
        dev, failures, out["serve"]["two-tower-retrieval"]["query_tower_ms"])
    out["agreement"] = recsys_agreement(dev, failures)
    launched = {k: v for k, v in read_counts().items() if v}
    log(f"  kernel launches in [recsys]: {launched or 'none'}")
    if launched:
        failures.append(f"recsys: kernels launched {launched}")
    return out


GNN_CELLS = ("full_graph_sm", "minibatch_lg", "molecule")
GNN_TRAIN_STEPS = 3
# minibatch_lg's graph: the published node count at average degree 50
# (11.6M edges, not 114.6M: its argsort alone costs the host seconds, and a
# fanout-15-10 block's shape is the same once every degree is >= 15)
MINIBATCH_DEGREE = 50
GNN_AGREE_NODES, GNN_AGREE_EDGES, GNN_AGREE_PADS = 300, 1500, 512


def gnn_batch(shape: str, n_classes: int, gen, dev) -> tuple[dict, dict]:
    """``shape``'s batch on the card (features N(0, 1), random labels) and
    its sizes: full_graph_sm's random edges padded by ``pad512``;
    minibatch_lg's block from ``sample_block`` on ``random_graph`` (host,
    numpy), ``len(node_ids)`` feature rows; molecule's 128 graphs, edges
    within each, padded, with ``graph_ids``."""
    import torch

    from repro_torch.configs.base import GNN_SHAPES, pad512
    from repro_torch.data import sampler
    d = GNN_SHAPES[shape].dims

    def randint(hi, n):
        return torch.randint(0, hi, (n,), generator=gen, device=dev)

    def padded(src, dst, n):
        pads = pad512(len(src)) - len(src)
        return (torch.cat([src, torch.zeros(pads, dtype=src.dtype,
                                            device=dev)]),
                torch.cat([dst, torch.full((pads,), n, dtype=dst.dtype,
                                           device=dev)]))

    info = {}
    if shape == "full_graph_sm":
        n = d["n_nodes"]
        src, dst = padded(randint(n, d["n_edges"]), randint(n, d["n_edges"]),
                          n)
        batch = {"labels": randint(n_classes, n)}
    elif shape == "minibatch_lg":
        t0 = time.perf_counter()
        g = sampler.random_graph(d["n_nodes"], avg_degree=MINIBATCH_DEGREE,
                                 seed=0)
        info["graph_s"] = time.perf_counter() - t0
        rng = np.random.default_rng(0)
        bn, f0, f1 = d["batch_nodes"], d["fanout0"], d["fanout1"]
        t0 = time.perf_counter()
        blk = sampler.sample_block(g, rng.choice(d["n_nodes"], bn,
                                                 replace=False), [f0, f1],
                                   rng, pad_edges_to=pad512(bn * (f0 + f0 * f1)))
        info["sample_s"] = time.perf_counter() - t0
        info["graph_edges"] = int(g.indptr[-1])
        n = len(blk["node_ids"])
        src = torch.from_numpy(blk["edge_src"]).to(dev)
        dst = torch.from_numpy(blk["edge_dst"]).to(dev)
        batch = {"label_nodes": torch.from_numpy(blk["seed_local"]).to(dev),
                 "labels": randint(n_classes, bn)}
    else:
        g_, nn, ne = d["batch"], d["n_nodes"], d["n_edges"]
        n = g_ * nn
        base = torch.arange(g_, device=dev).repeat_interleave(ne) * nn
        src, dst = padded(base + randint(nn, g_ * ne),
                          base + randint(nn, g_ * ne), n)
        batch = {"graph_ids": torch.arange(g_, device=dev)
                 .repeat_interleave(nn), "labels": randint(n_classes, g_)}
    batch.update(node_feats=torch.randn((n, d["d_feat"]), generator=gen,
                                        device=dev),
                 edge_src=src, edge_dst=dst)
    info.update(nodes=n, edges=len(src), pads=int((dst == n).sum()),
                d_feat=d["d_feat"])
    return batch, info


def gnn_train(dev, failures, shape: str) -> dict:
    """gatedgcn at published width (16 layers, d_hidden 70, 47 classes,
    bf16 over fp32 masters drawn on the card) on ``shape``:
    ``GNN_TRAIN_STEPS`` AdamW steps (ms a step, peak memory, finite loss
    and grad norm), then the same forward, loss and first step again from
    the same draw, bit for bit."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import gnn
    from repro_torch.train.optimizer import AdamW, named_params
    from repro_torch.train.trainer import make_train_step
    cfg = get_config("gatedgcn")
    opt = AdamW()
    step = make_train_step(lambda p, b: gnn.loss_fn(cfg, p, b), opt)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    batch, info = gnn_batch(shape, cfg.n_classes, gen, dev)

    def run(steps):
        g = torch.Generator(device=dev)
        g.manual_seed(1)
        params = gnn.init_params(cfg, g, info["d_feat"], dev)
        with torch.no_grad():
            logits = gnn.forward(cfg, params, batch["node_feats"],
                                 batch["edge_src"], batch["edge_dst"])
            loss = gnn.loss_fn(cfg, params, batch)[0]
        for t in named_params(params).values():
            t.requires_grad_(True)
        state = opt.init(params)
        hist, first = [], None
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            hist.append({"ms": (time.perf_counter() - t0) * 1e3,
                         "loss": float(m["loss"]),
                         "gnorm": float(m["gnorm"])})
            if i == 0:
                first = {k: t.detach().clone()
                         for k, t in named_params(params).items()}
        return logits, loss, hist, first

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    logits, loss, hist, first = run(GNN_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    logits2, loss2, again, first2 = run(1)
    same = (torch.equal(logits, logits2) and torch.equal(loss, loss2)
            and all(torch.equal(t, first2[k]) for k, t in first.items()))
    finite = bool(torch.isfinite(logits).all()) and all(
        np.isfinite([h["loss"], h["gnorm"]]).all() for h in hist)
    del logits, logits2, first, first2, batch
    free_card()
    ms = [h["ms"] for h in hist]
    res = {**info, "step_ms": ms, "losses": [h["loss"] for h in hist],
           "gnorms": [h["gnorm"] for h in hist], "peak_bytes": peak,
           "same_bits": same}
    log(f"  gatedgcn {shape}: {info['nodes']:,} nodes x {info['d_feat']} "
        f"features, {info['edges']:,} edges ({info['pads']:,} pads)"
        + (f"; graph of {info['graph_edges']:,} edges built in "
           f"{info['graph_s']:.2f} s, block sampled in {info['sample_s']:.2f}"
           f" s (host)" if "graph_s" in info else "")
        + f"; {GNN_TRAIN_STEPS} AdamW steps: ms {[round(x, 1) for x in ms]},"
        f" peak {peak / 2**30:.2f} GiB; loss "
        f"{[round(x, 5) for x in res['losses']]}, gnorm "
        f"{[round(x, 5) for x in res['gnorms']]}; forward, loss and the "
        f"first step again: {'the same bits' if same else 'BITS DIFFER'} -> "
        f"{'ok' if finite and same else 'FAIL'}")
    if not finite or not same:
        failures.append(f"gnn {shape}: a loss, logit or grad norm is not "
                        f"finite, or a run is not the same twice")
    return res


def gnn_agreement(dev, failures) -> dict:
    """gatedgcn's smoke config in fp32 (300 nodes, 1,500 edges, 24
    features): logits and one AdamW step's loss and grad norm, card vs CPU,
    within ``RECSYS_TOL``; and on the card the batch with 512 pad edges
    appended against it: logits, loss and every gradient within
    ``RECSYS_TOL`` (and whether bit for bit), all finite."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import gnn
    from repro_torch.train.optimizer import AdamW, named_params
    from repro_torch.train.trainer import make_train_step
    cfg = gnn.smoke_config(get_config("gatedgcn")).scaled(dtype=torch.float32)
    cpu = torch.device("cpu")
    gen = torch.Generator()
    gen.manual_seed(3)
    params = gnn.init_params(cfg, gen, 24, cpu)
    n, e = GNN_AGREE_NODES, GNN_AGREE_EDGES
    batch = {"node_feats": torch.randn((n, 24), generator=gen),
             "edge_src": torch.randint(0, n, (e,), generator=gen),
             "edge_dst": torch.randint(0, n, (e,), generator=gen),
             "labels": torch.randint(0, cfg.n_classes, (n,), generator=gen)}
    pads = GNN_AGREE_PADS
    padded = dict(batch,
                  edge_src=torch.cat([batch["edge_src"],
                                      torch.zeros(pads, dtype=torch.int64)]),
                  edge_dst=torch.cat([batch["edge_dst"],
                                      torch.full((pads,), n)]))
    opt = AdamW(lr=1e-3, warmup_steps=2)
    step = make_train_step(lambda p, b: gnn.loss_fn(cfg, p, b), opt)

    def run(where, b):
        p, b = tree_to(params, where), tree_to(b, where)
        with torch.no_grad():
            logits = gnn.forward(cfg, p, b["node_feats"], b["edge_src"],
                                 b["edge_dst"]).cpu()
        named = named_params(p)
        for t in named.values():
            t.requires_grad_(True)
        loss, _ = gnn.loss_fn(cfg, p, b)
        grads = torch.autograd.grad(loss, list(named.values()))
        _, _, m = step(p, opt.init(p), b)
        return (logits, float(loss.detach()), {k: g.cpu() for k, g in
                                      zip(named, grads)}, float(m["gnorm"]))

    (l0, s0, g0, n0), (l1, s1, g1, n1) = run(cpu, batch), run(dev, batch)
    lp, sp, gp, _ = run(dev, padded)

    def rel(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
    err = {"logits": rel(l1, l0), "loss": abs(s1 - s0) / max(1.0, abs(s0)),
           "gnorm": abs(n1 - n0) / max(1.0, abs(n0)),
           "grads": max(rel(g1[k], g0[k]) for k in g0)}
    pad_err = {"logits": rel(lp, l1), "loss": abs(sp - s1) / max(1.0, abs(s1)),
               "grads": max(rel(gp[k], g1[k]) for k in g1)}
    pad_bits = torch.equal(lp, l1) and sp == s1 and all(
        torch.equal(gp[k], g1[k]) for k in g1)
    finite = all(bool(torch.isfinite(t).all()) for t in
                 [lp, *gp.values()]) and np.isfinite(sp)
    ok = (max(err.values()) <= RECSYS_TOL
          and max(pad_err.values()) <= RECSYS_TOL and finite)
    log(f"  gatedgcn smoke config, fp32, card vs CPU: "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in err.items()})}; "
        f"{pads} pad edges on the card vs none: "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in pad_err.items()})}"
        f" ({'bit for bit' if pad_bits else 'not bit for bit'}), all "
        f"{'finite' if finite else 'NOT finite'} (tol {RECSYS_TOL}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("gnn: the smoke config disagrees card vs CPU, or "
                        "pads change the card's result")
    return {"card_vs_cpu": err, "padded_vs_unpadded": pad_err,
            "padded_bits_equal": pad_bits}


def gnn_phase(dev, failures) -> dict:
    """gatedgcn trained on each of ``GNN_CELLS`` (``gnn_train``) and its
    smoke config card vs CPU and padded vs unpadded (``gnn_agreement``);
    no kernel may launch."""
    tf32_off(failures, "before [gnn]")
    free_card()
    reset_counts()
    out = {shape: gnn_train(dev, failures, shape) for shape in GNN_CELLS}
    out["agreement"] = gnn_agreement(dev, failures)
    launched = {k: v for k, v in read_counts().items() if v}
    log(f"  kernel launches in [gnn]: {launched or 'none'}")
    if launched:
        failures.append(f"gnn: kernels launched {launched}")
    return out


# ---------------------------------------------------------------------------
# phase 19 [dryrun]: the multi-pod dry run, and its counts held to a step on
# the card
# ---------------------------------------------------------------------------

# (arch, shape, meshes) run on the fake meshes: one list a subprocess, the
# three run side by side, beside the card's cells
DRYRUN_FAKE_CELLS = ((("colberter", "serve_q32", ("single", "multi")),),
                     (("qwen2-72b", "decode_32k", ("single",)),),
                     (("llama4-scout-17b-a16e", "decode_32k", ("single",)),))
# cells that fit one card whole: counted on a 1x1 mesh and run on the card
DRYRUN_CARD_CELLS = (("colberter", "serve_q32"), ("fm", "serve_p99"),
                     ("gatedgcn", "full_graph_sm"))
# the card's peak above start (the arguments already on the card) within
# this band of the dry run's step bytes (temporaries + outputs - the
# arguments updated in place)
DRYRUN_MEM_BAND = (0.90, 1.10)
DRYRUN_REPS = 20
# SmolLM's [train] step (8 x 4,096 tokens of train_4k) on a 1x1 mesh: its
# dry run (~40 s of host time) in a subprocess, on the card counted once and
# measured once
DRYRUN_LM_CELL = (LM, "train_4k", LM_TRAIN_BATCH)

_DRYRUN_SCRIPT = r"""
import json, sys
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_production_mesh
names = {"single": "single-pod-16x16", "multi": "multi-pod-2x16x16"}
meshes = {}
out = {}
for arch, shape, which in json.loads(sys.argv[1]):
    for m in which:
        if m not in meshes:
            meshes[m] = make_production_mesh(multi_pod=m == "multi")
        manifest = {}
        rec = run_cell(arch, shape, meshes[m], names[m], manifest,
                       verbose=False)
        rec.pop("trace", None)
        out.update(manifest)
print(json.dumps(out))
"""


_DRYRUN_LM_SCRIPT = r"""
import json
import chip_smoke
from repro_torch.launch.dryrun import record_cell
from repro_torch.launch.mesh import make_dev_mesh
mesh = make_dev_mesh()
cell = chip_smoke.dryrun_lm_cell(mesh)
print(json.dumps(chip_smoke.dry_summary(cell, record_cell(cell), mesh)))
"""


def dryrun_lm_cell(mesh):
    """``DRYRUN_LM_CELL``'s cell: the dry run's train_4k step of its arch
    at its global batch, every argument whole on the one-device ``mesh``
    (the same layout as sharded over its dims of one device, in the terms
    that torch 2.11's DTensor can flatten a tensor's dims in)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.launch.partitioning import like_tree, replicated
    from repro_torch.launch.steps import lm_cell
    arch, shape, batch = DRYRUN_LM_CELL
    spec = LM_SHAPES[shape]
    cell = lm_cell(get_config(arch), dataclasses.replace(
        spec, dims=dict(spec.dims, global_batch=batch)), mesh)
    cell.in_shardings = like_tree(cell.in_shardings, replicated(mesh))
    return cell


def dry_summary(cell, record, mesh) -> dict:
    """What the card's step is held to, from a cell's dry-run record."""
    from repro_torch.roofline.analysis import (extract_raw, memory_gb,
                                               roofline_from_raw)
    roof = roofline_from_raw(extract_raw(record), arch=cell.arch,
                             shape=cell.shape, mesh_name="dev-1x1",
                             n_dev=mesh.size(), model_flops=cell.model_flops,
                             mem_gb=memory_gb(record)).row()
    return {"flops": roof["flops_per_dev"],
            "product_flops": roof["product_flops_per_dev"],
            "transcendentals": roof["transcendentals_per_dev"],
            "bytes": roof["bytes_per_dev"],
            "argument_bytes": record.argument_bytes,
            "peak_bytes": record.peak_bytes,
            # what the step allocates above its arguments
            "step_bytes": (record.temp_bytes + record.output_bytes
                           - record.alias_bytes),
            "bound_ms": max(roof["compute_ms"], roof["memory_ms"]),
            "bound_by": roof["bottleneck"]}


def dryrun_lm_start():
    """``_DRYRUN_LM_SCRIPT`` started: the LM cell's dry run on a one-rank
    gloo group (no card: the dry run's tensors are fake ones)."""
    env = {**os.environ, "PYTHONPATH": SRC, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.Popen([sys.executable, "-c", _DRYRUN_LM_SCRIPT],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def dryrun_fake_start() -> list:
    """``DRYRUN_FAKE_CELLS`` through ``run_cell``, one subprocess a list
    (each process joins a fake 512-rank group of its own), started."""
    env = {**os.environ, "PYTHONPATH": SRC}
    return [subprocess.Popen([sys.executable, "-c", _DRYRUN_SCRIPT,
                              json.dumps(cells)], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
            for cells in DRYRUN_FAKE_CELLS]


def dryrun_fake_finish(procs, t0, failures) -> dict:
    """Wait for ``dryrun_fake_start``'s processes; each record must be
    ok."""
    recs = {}
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        if p.returncode != 0:
            failures.append(f"dryrun: fake-mesh subprocess exited "
                            f"{p.returncode}: {stderr[-1500:]}")
            continue
        recs.update(json.loads(stdout.strip().splitlines()[-1]))
    secs = time.perf_counter() - t0
    want = sum(len(m) for cells in DRYRUN_FAKE_CELLS for _, _, m in cells)
    if len(recs) != want:
        failures.append(f"dryrun: {len(recs)} fake-mesh records, not {want}")
    for key, rec in recs.items():
        if rec["status"] != "ok":
            failures.append(f"dryrun: {key} {rec.get('error')}")
            log(f"  {key}: FAIL {rec.get('error')}")
            continue
        roof = rec["roofline"]
        log(f"  {key}: ok, {rec['compile_s']} s, peak/dev "
            f"{rec['memory_analysis']['peak_gb']} GB, terms compute "
            f"{roof['compute_ms']} / memory {roof['memory_ms']} / "
            f"collective {roof['collective_ms']} ms ({roof['bottleneck']}), "
            f"flops/dev {roof['flops_per_dev']:.6g} (products "
            f"{roof['product_flops_per_dev']:.6g}, transcendentals "
            f"{roof['transcendentals_per_dev']:.6g}), collectives "
            f"{roof['counts']}")
    log(f"  fake-mesh cells: {secs:.1f} s in {len(procs)} subprocesses")
    return {"seconds": secs, "records": recs}


def dryrun_cell_args(cell, gen, dev):
    """Tensors of ``cell.args``' shapes and dtypes on the card, drawn from
    ``gen``: floats N(0, 1) x 0.05 (an optimizer's second moment ``v``
    their magnitudes, so that the in-place updates of the repeated steps
    stay finite), and each id in its range (tokens below
    the vocab, doc lengths in 1..max, each field's ids below its table's
    rows, edges among the nodes with ``pad512``'s tail at ``dst = n``,
    labels below the classes, an optimizer step of 0)."""
    import torch

    from repro_torch.configs import get_config
    cfg = get_config(cell.arch)

    def ints(name, shape, dtype):
        def draw(lo, hi, shp=shape):
            return torch.randint(lo, hi, shp, generator=gen, device=dev,
                                 dtype=dtype)
        if name == "query_tokens":
            return draw(0, cfg.vocab_size)
        if name == "doc_lens":
            return draw(1, cfg.max_doc_len + 1)
        if name == "sparse_ids":
            return torch.stack([draw(0, r, shape[:1]) for r in
                                cfg.table_sizes], dim=1)
        if name in ("edge_src", "edge_dst"):
            from repro_torch.configs.base import GNN_SHAPES
            d = GNN_SHAPES[cell.shape].dims
            n, e = d["n_nodes"], d["n_edges"]
            t = draw(0, n)
            if name == "edge_dst":
                t[e:] = n
            return t
        if name in ("tokens", "targets"):
            return draw(0, cfg.vocab_size)
        if name == "labels":
            return draw(0, cfg.n_classes if cfg.family == "gnn" else 2)
        if name == "step":
            return torch.zeros(shape, dtype=dtype, device=dev)
        raise ValueError(f"dryrun: no range for the ids {name!r}")

    def walk(t, name="", second_moment=False):
        if isinstance(t, dict):
            return {k: walk(v, k, second_moment or k == "v")
                    for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(walk(v, name) for v in t)
        if t.dtype.is_floating_point:
            x = torch.randn(t.shape, generator=gen, device=dev) * 0.05
            return (x.abs() if second_moment else x).to(t.dtype)
        return ints(name, tuple(t.shape), t.dtype)
    return walk(cell.args)


def dryrun_card_cell(dev, failures, cell, dry, card,
                     reps=DRYRUN_REPS) -> dict:
    """One cell's step on the card held to its 1x1 dry run ``dry``
    (``dry_summary``): the product FLOPs equal (``FlopCounterMode`` on
    the card counts products only), the peak above the arguments within
    ``DRYRUN_MEM_BAND`` of the dry run's, the step time beside the roofline
    bound. After a warm-up, one run is counted, one measured and ``reps``
    timed (median); with ``reps`` 0 the counted run is the warm-up and the
    measured run is timed."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    what = f"{cell.arch}/{cell.shape}"
    gen = torch.Generator(device=dev).manual_seed(0)
    args = dryrun_cell_args(cell, gen, dev)

    def timed():
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = cell.step_fn(*args)
        b.record()
        b.synchronize()
        return a.elapsed_time(b), out

    if reps:
        cell.step_fn(*args)                          # warm-up
    torch.cuda.synchronize()
    with FlopCounterMode(display=False) as fc:
        cell.step_fn(*args)
    card_flops = fc.get_total_flops()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    ms, out = timed()
    card_peak = torch.cuda.max_memory_allocated() - start
    loss = (out[2].get("loss") if isinstance(out, tuple) and len(out) == 3
            and isinstance(out[2], dict) else None)
    loss = None if loss is None else float(loss)
    del out
    times = [timed()[0] for _ in range(reps)] or [ms]
    step_ms = float(np.median(times))
    dry_step, dry_flops = dry["step_bytes"], dry["product_flops"]
    lo, hi = DRYRUN_MEM_BAND
    res = {"dry_product_flops": dry_flops, "card_flops": card_flops,
           "dry_flops": dry["flops"],
           "dry_transcendentals": dry["transcendentals"],
           "dry_argument_bytes": dry["argument_bytes"],
           "dry_peak_bytes": dry["peak_bytes"], "dry_step_bytes": dry_step,
           "card_peak_above_start": card_peak,
           "card_over_dry": card_peak / dry_step, "dry_bytes": dry["bytes"],
           "step_ms": step_ms, "bound_ms": dry["bound_ms"],
           "bound_by": dry["bound_by"], "share": dry["bound_ms"] / step_ms,
           "loss": loss, "card": card}
    log(f"  {what} 1x1: product FLOPs dry {dry_flops:.6g} card "
        f"{card_flops:.6g} (dry run's whole count {dry['flops']:.6g} FLOPs, "
        f"{dry['transcendentals']:.6g} transcendentals); "
        f"above the arguments ({dry['argument_bytes']} B): dry {dry_step} B "
        f"(temp + out - alias), card peak above start {card_peak} B, "
        f"card/dry {card_peak / dry_step:.4f}; dry peak {dry['peak_bytes']} "
        f"B; step {step_ms:.4f} ms (median of {len(times)}), bound "
        f"{dry['bound_ms']:.4f} ms ({dry['bound_by']}), share "
        f"{dry['bound_ms'] / step_ms:.4f}"
        + ("" if loss is None else f"; loss {loss:.4f}") + f"; {card}")
    if card_flops != dry_flops:
        failures.append(f"dryrun: {what} card FLOPs {card_flops} != dry "
                        f"run's product FLOPs {dry_flops}")
    if not lo * dry_step <= card_peak <= hi * dry_step:
        failures.append(f"dryrun: {what} card peak above start {card_peak} "
                        f"outside {DRYRUN_MEM_BAND} x the dry run's temp + "
                        f"out - alias {dry_step}")
    if loss is not None and not np.isfinite(loss):
        failures.append(f"dryrun: {what} loss {loss}")
    del args
    free_card()
    return res


def dryrun_phase(dev, failures, card) -> dict:
    """The fake-mesh cells and the LM cell's 1x1 dry run in subprocesses
    (``dryrun_fake_start``, ``dryrun_lm_start``), and meanwhile each of
    ``DRYRUN_CARD_CELLS`` counted on a 1x1 mesh here, then every card cell
    on the card (``dryrun_card_cell``); no kernel may launch."""
    from repro_torch.launch.dryrun import record_cell
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.steps import build_cell
    tf32_off(failures, "before [dryrun]")
    free_card()
    reset_counts()
    t0 = time.perf_counter()
    procs = dryrun_fake_start()
    lm_proc = dryrun_lm_start()
    mesh = make_dev_mesh()
    log(f"  dev mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on "
        f"{mesh.device_type}")
    out = {"card": {}}
    for arch, shape in DRYRUN_CARD_CELLS:
        cell = build_cell(arch, shape, mesh)
        try:
            dry = dry_summary(cell, record_cell(cell), mesh)
        except Exception as e:  # noqa: BLE001 — the phase's failure
            failures.append(f"dryrun: {arch}/{shape} on 1x1: "
                            f"{type(e).__name__}: {e}")
            out["card"][f"{arch}/{shape}"] = {"error": str(e)}
            continue
        out["card"][f"{arch}/{shape}"] = dryrun_card_cell(dev, failures,
                                                          cell, dry, card)
    try:
        stdout, stderr = lm_proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        lm_proc.kill()
        stdout, stderr = lm_proc.communicate()
    arch, shape, batch = DRYRUN_LM_CELL
    key = f"{arch}/{shape} at {batch} x {LM_LONG_SEQ}"
    if lm_proc.returncode != 0:
        failures.append(f"dryrun: {key}'s 1x1 dry run exited "
                        f"{lm_proc.returncode}: {stderr[-1500:]}")
    else:
        log(f"  {key}: 1x1 dry run {time.perf_counter() - t0:.1f} s into "
            "the phase")
        out["card"][key] = dryrun_card_cell(
            dev, failures, dryrun_lm_cell(mesh),
            json.loads(stdout.strip().splitlines()[-1]), card, reps=0)
    out["fake"] = dryrun_fake_finish(procs, t0, failures)
    launched = {k: v for k, v in read_counts().items() if v}
    log(f"  kernel launches in [dryrun]: {launched or 'none'}")
    if launched:
        failures.append(f"dryrun: kernels launched {launched}")
    tf32_off(failures, "after [dryrun]")
    return out


def kernel_rows(rows) -> list[dict]:
    """The ``{"kernels": [...]}`` line's rows. Each kernel's launches are
    those of the paths that run it (the retrieval modes, the LM decodes),
    each path's count read around its own run."""
    paths = {**rows["path"], **rows["serving"], "decode": rows["decode"],
             **{p: rows["moe"][p] for p in MOE_KERNELS}}
    by_path = {name: {mode: paths[mode]["launches"][name]
                      for mode, names in {**PATH_KERNELS, **SERVING_KERNELS,
                                          **MOE_KERNELS}.items()
                      if name in names}
               for name in KERNELS}
    # maxsim over the path's calls: each call's device_ms and bound taken
    # at the timed K nearest its own (``PATH_K``)
    sizes = rows["maxsim"]["path_sizes"]
    near = [min(sizes, key=lambda s: abs(s - k))
            for k in rows["path"]["maxsim_k_calls"]]
    extra = {"maxsim": {"path_kernels": rows["path"]["maxsim_kernels"],
                        "path_k": rows["path"]["maxsim_k"]["all"],
                        "path_device_ms_sum": sum(sizes[s]["device_ms"]
                                                  for s in near),
                        "path_bound_ms_sum": sum(sizes[s]["bound_ms"]
                                                 for s in near)}}
    log(f"  maxsim over the path's {len(near)} calls, at the nearest timed "
        f"K: {extra['maxsim']['path_device_ms_sum']:.4f} ms on the device, "
        f"bound {extra['maxsim']['path_bound_ms_sum']:.4f} ms")
    extra["bitsim"] = {"path_kernels": rows["path"]["bitsim_kernels"],
                       "path_k": rows["path"]["bitsim_k"]["all"],
                       **rows["path"]["bitsim_path"]}
    return [{"name": name, "route": "cuda", **meta,
             "launches": sum(by_path[name].values()),
             "launches_by_path": by_path[name], **rows[name],
             "kernel_ms": rows[name]["ms"], **extra.get(name, {})}
            for name, meta in KERNELS.items()]


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
    serving: dict = {}
    rows = {"serving": serving}
    phases = [("kernels", lambda: rows.update(
                  maxsim=check_maxsim(dev, rng, failures),
                  ivf_scan=check_ivf_scan(dev, rng, failures),
                  bitsim=check_bitsim(dev, rng, failures),
                  fdescan=check_fdescan(dev, rng, failures),
                  gather_pack=check_gather_pack(dev, rng, failures),
                  flash_decode=check_flash_decode(dev, rng, failures))),
              ("main path", lambda: rows.update(
                  path=main_path(dev, failures, args.profile))),
              ("persist", lambda: persist_phase(dev, failures, serving)),
              ("serve", lambda: serve_phase(dev, failures, serving)),
              ("encoder", lambda: encoder_phase(dev, failures, serving)),
              ("disk_ivf", lambda: disk_ivf_phase(dev, failures, serving)),
              ("faults", lambda: faults_phase(dev, failures, serving)),
              ("cluster", lambda: cluster_phase(dev, failures, serving)),
              ("mutation", lambda: (mutation_phase(dev, failures, serving),
                                    free_main_path())),
              ("train", lambda: train_phase(dev, failures, serving)),
              ("agreement", lambda: agreement(dev, failures)),
              ("decode path", lambda: rows.update(
                  decode=decode_path(dev, failures))),
              ("decode agreement", lambda: (decode_agreement(dev, failures),
                                            onehot_decode(dev, failures))),
              ("moe", lambda: rows.update(moe=moe_phase(dev, failures))),
              ("recsys", lambda: rows.update(
                  recsys=recsys_phase(dev, failures))),
              ("gnn", lambda: rows.update(gnn=gnn_phase(dev, failures))),
              ("dryrun", lambda: rows.update(
                  dryrun=dryrun_phase(dev, failures, card)))]
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
    kernels = kernel_rows(rows)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
