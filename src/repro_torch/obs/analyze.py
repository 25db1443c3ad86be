"""Trace-driven tail diagnosis: attribute SLO violations to stages.

``analyze_trace`` ingests a trace (a path to the exported Chrome JSON, the
raw event list, or a live ``Tracer``) and, for every ``request`` span that
recorded an SLO violation, names the **dominant stage** that ate the slack:

* ``queue``        — wall time between admission and dispatch,
* ``critical_io``  — unhidden device reads on the query's critical path,
* ``rerank``       — MaxSim/bit-filter device compute,
* ``candidate_gen``— encode + ANN search device time,
* ``retry_repair`` — critical I/O dominated AND fault machinery (retries /
                     checksum repairs) fired on the batch,
* ``hedge_loss``   — critical I/O dominated AND hedges fired without a win
                     (pure duplicate-byte overhead),
* ``other``        — residual host time.

The same ``dominant_stage`` function feeds the autoscaler's audit log at
serve time, so an actuation can cite the span evidence that triggered it.

``host_breakdown`` reads the wall clock instead: how much of each
``query_batch`` the host spent in each work span (the ``cat="host"`` spans
and the tier's ``plan`` and ``read_batch``), and how much in none.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

STAGES = ("queue", "critical_io", "rerank", "candidate_gen", "other")

#: the spans that time host work inside a batch: the ``cat="host"`` spans
#: of the backends, the prefetcher, ``rerank_query`` and a read's waits,
#: and the storage tier's ``plan`` and ``read_batch``
WORK_SPANS = ("ivf_search", "hit_masks", "reuse_check", "plan", "read_batch",
              "views", "io_wait", "lookup", "score", "bill")


def dominant_stage(stages_ms: dict, flags: dict | None = None) -> str:
    """Largest stage, refined by fault/hedge evidence when I/O dominates."""
    flags = flags or {}
    best, best_ms = "other", -1.0
    for k in STAGES:
        v = float(stages_ms.get(k, 0.0) or 0.0)
        if v > best_ms:
            best, best_ms = k, v
    if best == "critical_io":
        if flags.get("retries", 0) or flags.get("repairs", 0):
            return "retry_repair"
        if flags.get("hedged", 0) and not flags.get("hedge_wins", 0):
            return "hedge_loss"
    return best


def _load_events(source) -> list[dict]:
    if hasattr(source, "to_events"):              # a live Tracer
        return source.to_events()
    if isinstance(source, str):
        with open(source) as f:
            doc = json.load(f)
        return doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    if isinstance(source, dict):
        return source.get("traceEvents", [])
    return list(source)


def analyze_trace(source) -> dict:
    """Build the tail-diagnosis report from a trace.

    Returns ``{requests, violations, attributed, attribution_rate,
    by_stage, rows}`` where ``rows`` carries one record per violation:
    rid, slo_ms, latency_ms, dominant stage, and the stage breakdown.
    """
    events = _load_events(source)
    requests = [e for e in events
                if e.get("name") == "request" and e.get("ph") == "X"
                and e.get("pid") == 1]
    by_stage: dict[str, int] = {}
    rows = []
    violations = 0
    for e in requests:
        args = e.get("args", {})
        if not args.get("violation"):
            continue
        violations += 1
        stages = args.get("stages_ms", {})
        dom = dominant_stage(stages, args)
        by_stage[dom] = by_stage.get(dom, 0) + 1
        rows.append({
            "rid": args.get("qid"),
            "slo_ms": args.get("slo_ms"),
            "budget_ms": args.get("budget_ms"),
            "latency_ms": args.get("latency_ms"),
            "dominant": dom,
            "stages_ms": stages,
        })
    attributed = sum(by_stage.values())
    return {
        "requests": len(requests),
        "violations": violations,
        "attributed": attributed,
        "attribution_rate": attributed / violations if violations else 1.0,
        "by_stage": by_stage,
        "rows": rows,
    }


def format_report(report: dict) -> str:
    """Human-readable rendering of an ``analyze_trace`` report."""
    lines = [f"requests={report['requests']} "
             f"violations={report['violations']} "
             f"attributed={report['attributed']} "
             f"({report['attribution_rate']:.0%})"]
    for stage, n in sorted(report["by_stage"].items(),
                           key=lambda kv: -kv[1]):
        lines.append(f"  {stage:>14}: {n}")
    for r in report["rows"][:20]:
        lines.append(f"  rid={r['rid']} lat={r['latency_ms']}ms "
                     f"budget={r['budget_ms']}ms -> {r['dominant']}")
    return "\n".join(lines)


def _union_s(intervals) -> float:
    """Seconds covered by the union of ``(t0, t1)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def host_breakdown(source) -> dict:
    """Where the wall time of a traced run's ``query_batch`` spans went.

    ``source`` is a ``Tracer`` or its spans. Only the work spans of the
    thread that ran each batch, and inside it, count. Returns
    ``{n_batches, query_batch_s, work_s, spans, counters, untraced_s}``:
    ``work_s`` the seconds under each work span name (nested spans of one
    name counted once), ``spans`` how many of each there were,
    ``counters`` the sums of each name's numeric ``args``, and
    ``untraced_s`` the batches' seconds under no work span at all.
    """
    spans = source.spans() if hasattr(source, "spans") else list(source)
    batches = [s for s in spans if s.name == "query_batch" and s.closed]
    work = defaultdict(list)                  # tid -> work spans by t0
    for s in spans:
        if s.name in WORK_SPANS and s.closed:
            work[s.tid].append(s)
    starts = {}
    for tid, ws in work.items():
        ws.sort(key=lambda s: s.t0)
        starts[tid] = [s.t0 for s in ws]
    work_s = dict.fromkeys(WORK_SPANS, 0.0)
    n_spans = dict.fromkeys(WORK_SPANS, 0)
    counters: dict = {}
    total = untraced = 0.0
    for qb in batches:
        ws = work.get(qb.tid, [])
        lo = bisect.bisect_left(starts.get(qb.tid, []), qb.t0)
        hi = bisect.bisect_right(starts.get(qb.tid, []), qb.t1)
        inside = [s for s in ws[lo:hi] if s.t1 <= qb.t1]
        by_name = defaultdict(list)
        for s in inside:
            by_name[s.name].append((s.t0, s.t1))
            n_spans[s.name] += 1
            c = counters.setdefault(s.name, {})
            for k, v in s.args.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    c[k] = c.get(k, 0) + v
        for name, iv in by_name.items():
            work_s[name] += _union_s(iv)
        total += qb.wall_s
        untraced += qb.wall_s - _union_s((s.t0, s.t1) for s in inside)
    return {"n_batches": len(batches), "query_batch_s": total,
            "work_s": work_s, "spans": n_spans, "counters": counters,
            "untraced_s": untraced}
