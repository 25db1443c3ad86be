"""One run of one cell: the registry of cells, configurations, traffic mixes
and per-layer metrics (all found by name), the set-up, the measured window,
the check against the reference and the result line."""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from espnbench import gen, loops, reference
from espnbench.probe import Probe, export_events, read_trace

HERE = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


# ---------------------------------------------------------------------------
# the registry: everything by name
# ---------------------------------------------------------------------------

def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(kind: str, name: str, base: Path = HERE) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_config(name: str, base: Path = HERE) -> dict:
    return _load_json("configs", name, base)


def load_traffic(name: str, base: Path = HERE) -> dict:
    return _load_json("traffic", name, base)


def load_metric(name: str, base: Path = HERE):
    """The reader of per-layer metric ``name``: ``read(record)``, which
    returns a number or None when the run holds nothing to read."""
    path = base / "metrics" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no metric reader named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "espnbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")


def end_to_end_of(bench: dict, workload: str) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def per_layer_of(bench: dict, workload: str) -> list[dict]:
    e2e = {m["name"] for m in end_to_end_of(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    tops = {m.split(".")[0] for m in list(sys.modules if modules is None
                                           else modules)}
    return sorted(tops & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(base.get(k, {}), v) if isinstance(v, dict) else v
    return out


def _sync(device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _instrument(probe: Probe, pipe) -> None:
    """The traced run's wrappers around the layers' entry calls."""
    from repro_torch.core import ivf, prefetcher, rerank
    from repro_torch.pipeline import backends
    backend = pipe.backend
    probe.wrap(backend, "query_batch", "query_batch", keep=True)
    if hasattr(backend, "prefetcher"):
        probe.wrap(prefetcher, "search_two_phase", "ivf_search")
        probe.wrap(backend.prefetcher, "run_batch", "prefetch")
    else:
        probe.wrap(backends, "search", "ivf_search")
    probe.wrap(pipe.tier, "read_batch", "read_batch")
    probe.wrap(backends, "rerank_query", "rerank")
    probe.note_calls(rerank, "maxsim", "maxsim", lambda q, qm, docs, lens: (
        docs.shape[0], q.shape[0], q.shape[1],
        lens.clamp(0, docs.shape[1]).sum(), docs.element_size()))
    probe.note_calls(ivf, "centroid_scores", "ivf_scan", lambda q, c: (
        q.shape[0], c.shape[0], c.shape[1]))


def _pct(xs, p: float) -> float:
    """Nearest-rank percentile."""
    s = sorted(xs)
    return s[max(0, math.ceil(p / 100.0 * len(s)) - 1)]


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, *, device="cuda", t_start: float | None = None,
             config_over: dict | None = None,
             traffic_over: dict | None = None, control: bool = False,
             log=None) -> tuple[dict, list]:
    """Run ``workload`` once. Returns the result object and the compared
    numbers ``[(name, value, limit)]``. ``config_over`` and
    ``traffic_over`` change the cell's files' entries for this run; with
    ``control`` the answers judged are the control's (the reference in
    TF32 in the program's place, on the same queries), not the program's."""
    from repro_torch.pipeline import Pipeline, PipelineConfig
    from repro_torch.serve.scheduler import BatchPolicy

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    device = torch.device(device)
    sync = _sync(device)
    cell = cell_of(bench, workload)
    config = _merge(load_config(cell["config"]), config_over)
    traffic = _merge(load_traffic(cell["traffic"]), traffic_over)
    spec = config["corpus"]

    # the corpus is the deployment's data set, one per configuration; the
    # seed draws the traffic
    corpus = gen.make_corpus(spec, gen.generator(spec["seed"], device),
                             device)
    g = gen.generator(seed, device)
    warm_n = traffic.get("batch") or traffic["max_batch"]
    if traffic["loop"] == "closed":
        n_q = traffic["batch"] * traffic["bank_batches"]
        arrivals = None
    else:
        arrivals = gen.arrival_times(traffic, seconds, g)
        n_q = len(arrivals)
    allq = gen.make_queries(corpus, spec, traffic, n_q + warm_n, g, device)
    queries = gen.Queries(allq.cls[:n_q], allq.bow[:n_q], allq.lens[:n_q],
                          allq.targets[:n_q])
    corpus.release_device()
    t_gen = time.perf_counter()
    cfg = PipelineConfig.from_dict(config["pipeline"])
    pipe = Pipeline.from_embeddings(cfg, corpus.cls, corpus.bow_list(),
                                    device=device)
    sync()
    t_build = time.perf_counter()
    # warm-up: one batch of the cell's own shape
    pipe.search(allq.cls[n_q:], allq.bow[n_q:], allq.lens[n_q:])
    sync()
    log(f"set-up: inputs {t_gen - t_start:.1f} s (from process start), "
        f"Pipeline.from_embeddings {t_build - t_gen:.1f} s, warm batch of "
        f"{warm_n} {time.perf_counter() - t_build:.1f} s; {len(corpus.lens)} "
        f"docs, {len(corpus.tokens)} tokens, index "
        f"{pipe.index.memory_bytes() / 2**30:.3f} GiB, host image "
        f"{pipe.layout.nbytes / 2**30:.3f} GiB")
    server = None
    if traffic["loop"] == "open":
        server = pipe.serve(BatchPolicy(max_batch=traffic["max_batch"],
                                        max_wait_s=traffic["max_wait_s"]))
    probe = prof = None
    if trace:
        probe = Probe()
        _instrument(probe, pipe)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        # the profiler's own start-up (CUPTI) before the window, not in it
        torch.ones(1, device=device).add_(1)
        sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    if trace:
        with torch.profiler.record_function("espnbench::window"):
            t_win = time.perf_counter()
            win = _window(pipe, server, queries, traffic, seconds, arrivals,
                          sync)
    else:
        win = _window(pipe, server, queries, traffic, seconds, arrivals, sync)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    record = None
    if trace:
        prof.__exit__(None, None, None)
        probe.restore()
        record = {"probe": probe,
                  "trace": read_trace(export_events(prof), probe.intervals,
                                      t_win),
                  "window": win, "traffic": traffic, "config": config}
        prof = None
    if server is not None:
        server.shutdown()
    index = reference.IndexState(
        centroids=pipe.index.centroids.detach().to("cpu").clone(),
        cell_ids=pipe.index.cell_ids.to("cpu").numpy().astype(np.int64))
    pipe.close()
    del pipe, server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- the check against the reference --------------------------------
    t_ref = time.perf_counter()
    inp = reference.Inputs(
        cls=torch.as_tensor(corpus.cls, device=device),
        tokens=torch.as_tensor(corpus.tokens, device=device),
        starts=torch.as_tensor(corpus.starts, device=device),
        lens=torch.as_tensor(corpus.lens, device=device),
        nprobe=cfg.retrieval.nprobe, k=cfg.retrieval.k_candidates,
        alpha=cfg.retrieval.alpha, t_max=cfg.storage.t_max)
    index.centroids = index.centroids.to(device)
    rows = np.array(sorted(win.answers), np.int64)
    rng = np.random.default_rng(seed)
    picks = rng.choice(rows, size=min(len(rows), traffic["judge_queries"]),
                       replace=False) if len(rows) else rows
    rule = reference.IndexRule.of(config)
    ref_index = reference.kmeans_index(inp.cls, rule)
    answers = win.answers
    if control:
        index = reference.kmeans_index(inp.cls, rule, control=True)
        answers = reference.control_answers(inp, index, queries, picks)
    got = reference.judge(inp, index, ref_index, queries, answers, picks)
    limits = config["limits"]
    checks = [(name, got[name], limits[name]) for name in reference.NAMES]
    checks.append(("unanswered", float(len(win.failed_rows)), 0.0))
    correct = all(v <= lim for _, v, lim in checks)
    log(f"reference: its index and {len(picks)} answers judged in "
        f"{time.perf_counter() - t_ref:.1f} s")
    if record is not None:
        record["flops"] = _path_flops(inp, ref_index, queries, win)

    # -- the result ------------------------------------------------------
    e2e = {}
    for m in end_to_end_of(bench, workload):
        v = _end_to_end(m["name"], win, setup_s, peak)
        if v is not None:
            e2e[m["name"]] = {"value": v, "unit": m["unit"]}
    metrics = e2e
    breakdown = None
    if record is not None:
        metrics = {}
        for m in per_layer_of(bench, workload):
            v = load_metric(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = {"device_ops": record["trace"].get("device_ops", []),
                     "idle_gaps": record["trace"].get("idle_gaps", [])}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if record is not None:
        dev["busy_s"] = record["trace"].get("busy_s", 0.0)
        dev["window_s"] = record["trace"].get("window_s", win.seconds)
    result = {"correct": bool(correct), "attempted": int(win.attempted),
              "failed": int(len(win.failed_rows)), "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    lat = win.latencies_s
    log(f"window {win.seconds:.3f} s: {win.attempted} attempted, "
        f"{win.answered} answered, {len(win.batch_sizes)} batches"
        + (f"; {len(lat)} latency samples, p50 "
           f"{1e3 * _pct(lat, 50):.1f} ms, max {1e3 * max(lat):.1f} ms, "
           f"{sum(x > 1.0 for x in lat)} over 1 s, generator at most "
           f"{1e3 * win.late_s:.1f} ms late" if lat else ""))
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks


def _window(pipe, server, queries, traffic, seconds, arrivals, sync):
    if traffic["loop"] == "closed":
        return loops.closed(pipe, queries, traffic, seconds, sync)
    return loops.open_loop(server, queries, arrivals, traffic["drain_s"])


def _end_to_end(name: str, win, setup_s: float, peak: int):
    if name == "setup_s":
        return setup_s
    if name == "device_peak_gib":
        return peak / 2**30
    if name == "qps":
        return win.answered / win.seconds if win.seconds > 0 else None
    if name == "p95_ms":
        if not win.attempted:
            return None
        # an unanswered request counts at least the whole wait
        missing = [win.seconds] * (win.attempted - len(win.latencies_s))
        return 1e3 * _pct(list(win.latencies_s) + missing, 95)
    raise KeyError(f"the harness measures no end-to-end metric {name!r}")


def _path_flops(inp, index, queries, win) -> float:
    """FLOPs the answered queries need (``kernel_counts.path_flops``),
    counted from the reference's probe ranking and the answers' docs."""
    from espnbench.kernel_counts import path_flops
    cent = index.centroids.double()
    sizes = torch.as_tensor((index.cell_ids >= 0).sum(1), device=cent.device)
    n_tok = torch.minimum(inp.lens, torch.tensor(inp.t_max,
                                                 device=inp.lens.device))
    total = 0.0
    rows = sorted(win.answers)
    nprobe = min(inp.nprobe, cent.shape[0])
    for i in range(0, len(rows), 256):
        blk = rows[i:i + 256]
        q = torch.as_tensor(queries.cls[blk], device=cent.device).double()
        probed = torch.topk(q @ cent.T, nprobe, dim=1).indices
        scanned = sizes[probed].sum(1)
        for j, row in enumerate(blk):
            ids = torch.as_tensor(win.answers[row][0], device=n_tok.device)
            total += path_flops(cent.shape[0], cent.shape[1],
                                int(scanned[j]), int(queries.lens[row]),
                                queries.bow.shape[2],
                                float(n_tok[ids].sum()))
    # a query answered twice (the bank wraps) did the work twice
    return total * win.answered / max(len(rows), 1)


def result_line(result: dict) -> str:
    return json.dumps(result, separators=(", ", ": "))
