"""The traced run's instruments, all outside the program.

``Probe`` wraps the program's entry calls by name from outside (module
globals or instance attributes), times each on the host clock on whatever
thread calls it, and synchronises the device once at its exit, so a span
holds the device work it launched. It also notes the shapes of each kernel
call, for the rooflines. ``read_trace`` turns a profiler trace into device
time by kernel, busy time, and idle gaps labelled by the wrapped call the
host was in: the host clock is mapped onto the trace's by the window, which
is both a ``record_function`` range and a host-clock interval.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict

import numpy as np
import torch

SPAN_PREFIX = "espnbench::"


class Probe:
    def __init__(self):
        self.spans = defaultdict(list)     # name -> [(wall_s, child_s)]
        self.calls = defaultdict(list)     # kernel -> [shape tuple]
        self.outputs = defaultdict(list)   # name -> outputs kept
        self.intervals = []                # (t0, t1, name), host clock
        self._local = threading.local()
        self._undo = []

    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def wrap(self, owner, attr: str, name: str, keep: bool = False) -> None:
        """Time ``owner.attr`` under span ``name`` (``keep``: and keep
        what each call returns)."""
        fn = getattr(owner, attr)
        probe = self

        def timed(*args, **kw):
            st = probe._stack()
            st.append(0.0)
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            finally:
                t1 = time.perf_counter()
                dt = t1 - t0
                child = st.pop()
                probe.spans[name].append((dt, child))
                probe.intervals.append((t0, t1, name))
                if st:
                    st[-1] += dt
            if keep:
                probe.outputs[name].append(out)
            return out
        self._undo.append((owner, attr, owner.__dict__.get(attr, _MISSING)))
        setattr(owner, attr, timed)

    def note_calls(self, owner, attr: str, kernel: str, shape_of) -> None:
        """Record ``shape_of(*args)`` for every call of ``owner.attr``."""
        fn = getattr(owner, attr)
        calls = self.calls[kernel]

        def noted(*args, **kw):
            calls.append(shape_of(*args, **kw))
            return fn(*args, **kw)
        self._undo.append((owner, attr, owner.__dict__.get(attr, _MISSING)))
        setattr(owner, attr, noted)

    def restore(self) -> None:
        for owner, attr, old in reversed(self._undo):
            if old is _MISSING:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
        self._undo.clear()

    def total(self, name: str) -> float:
        return float(sum(w for w, _ in self.spans.get(name, ())))

    def self_time(self, name: str) -> float:
        return float(sum(w - c for w, c in self.spans.get(name, ())))


_MISSING = object()


def export_events(prof) -> list[dict]:
    """The device's kernels, copies and fills (``cat`` "kernel") and the
    benchmark's ranges (``cat`` "range") from the profiler's results, with
    ``ts`` and ``dur`` in microseconds."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).upper().endswith("CUDA")
        name = e.name()
        ours = name.startswith(SPAN_PREFIX)
        # a range (``record_function``) also has a mirror on the device's
        # track: that is not device work
        if dev and (ours or e.is_user_annotation()):
            continue
        if dev or ours:
            out.append({"cat": "kernel" if dev else "range",
                        "name": name, "ts": e.start_ns() / 1e3,
                        "dur": e.duration_ns() / 1e3})
    return out


def read_trace(events: list[dict], intervals, host_window: float,
               top: int = 10) -> dict:
    """From ``export_events``: device seconds by kernel, copy or fill name
    inside the window range, the device's busy seconds there, the window's
    length, and idle seconds by the innermost wrapped call the host was in
    (``host: outside calls`` elsewhere). ``intervals`` are the probe's
    host-clock spans ``(t0, t1, name)``, placed on the trace's clock by
    ``host_window``, the window's start on the host clock."""
    dev, window = [], None
    for e in events:
        if e["cat"] == "kernel":
            dev.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        elif e["name"] == SPAN_PREFIX + "window":
            window = (e["ts"], e["ts"] + e["dur"])
    if window is None:
        return {}
    w0, w1 = window
    spans = [(w0 + (a - host_window) * 1e6, w0 + (b - host_window) * 1e6,
              name) for a, b, name in intervals]
    by_name = defaultdict(float)
    iv = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            by_name[name] += (b - a) * 1e-6
            iv.append((a, b))
    iv.sort()
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = np.array([(edges[i], edges[i + 1])
                     for i in range(0, len(edges), 2)
                     if edges[i + 1] > edges[i]]).reshape(-1, 2)
    labels = np.full(len(gaps), "host: outside calls", dtype=object)
    if len(gaps):
        mid = gaps.mean(axis=1)
        order = np.argsort(mid)
        mids = mid[order]
        # outermost first, so that inner calls overwrite their parents
        for a, b, name in sorted(spans, key=lambda s: s[0] - s[1]):
            lo, hi = np.searchsorted(mids, [a, b])
            labels[order[lo:hi]] = "host: in " + name
    idle = defaultdict(float)
    for (a, b), lab in zip(gaps, labels):
        idle[lab] += (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "window_s": (w1 - w0) * 1e-6,
            "kernel_s": dict(by_name),
            "device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]]}


def kernel_seconds(trace: dict, pattern: str) -> float:
    """Device seconds of the kernels whose names contain ``pattern``."""
    return float(sum(s for n, s in trace.get("kernel_s", {}).items()
                     if pattern in n))
