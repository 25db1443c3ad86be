"""The two ways a traffic mix drives the program, chosen by its ``loop``.

``closed``: one client sends batches of ``batch`` queries back to back
through ``Pipeline.search`` until the window's seconds have passed; the
window is whole batches, from the first batch's start to the last one's
end.

``open``: requests are due at the mix's arrival times, whatever the server
is doing; each goes in through ``RetrievalServer.query_async`` when due,
and is timed from when it was due to its answer. After the last arrival the
loop waits for the answers, at most ``drain_s`` past the window's close.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Window:
    seconds: float = 0.0              # the measured window's length
    attempted: int = 0
    answered: int = 0
    answers: dict = field(default_factory=dict)   # query row -> (ids, scores)
    latencies_s: list = field(default_factory=list)
    breakdowns: list = field(default_factory=list)
    batch_sizes: list = field(default_factory=list)
    late_s: float = 0.0               # how late the generator ran, at most
    failed_rows: list = field(default_factory=list)


def _keep(resp_ranked, rows, win: Window) -> None:
    """Keep each row's answer; a row with no answer, or a degraded one,
    has failed."""
    ranked = list(resp_ranked)
    ranked += [None] * (len(rows) - len(ranked))
    for row, out in zip(rows, ranked):
        if out is None or getattr(out, "degraded", False):
            win.failed_rows.append(int(row))
            continue
        win.answers[int(row)] = (np.asarray(out.doc_ids),
                                 np.asarray(out.scores))
        win.answered += 1


def closed(pipe, queries, traffic: dict, seconds: float, sync) -> Window:
    b = traffic["batch"]
    n = len(queries.lens)
    win = Window()
    t0 = time.perf_counter()
    i = 0
    while True:
        rows = np.arange(i, i + b) % n
        resp = pipe.search(queries.cls[rows], queries.bow[rows],
                           queries.lens[rows])
        sync()
        win.attempted += b
        win.breakdowns.append(resp.breakdown)
        win.batch_sizes.append(b)
        _keep(resp.ranked, rows, win)
        i += b
        if time.perf_counter() - t0 >= seconds:
            break
    win.seconds = time.perf_counter() - t0
    return win


def open_loop(server, queries, arrivals: np.ndarray, drain_s: float,
              backlog: list | None = None) -> Window:
    """Replay ``arrivals`` (offsets in seconds) into ``server``;
    ``backlog`` gets the count of requests not yet answered at the last
    arrival."""
    win = Window()
    done_at = {}
    on_complete = server.batcher.on_complete

    def stamped(r):
        done_at[r.rid] = time.monotonic()
        if on_complete is not None:
            on_complete(r)
    server.batcher.on_complete = stamped
    reqs = []
    t0 = time.monotonic()
    for row, t in enumerate(arrivals):
        dt = t0 + t - time.monotonic()
        if dt > 0:
            time.sleep(dt)
        else:
            win.late_s = max(win.late_s, -dt)
        reqs.append(server.query_async(queries.cls[row], queries.bow[row],
                                       int(queries.lens[row])))
    close = t0 + (arrivals[-1] if len(arrivals) else 0.0)
    if backlog is not None:
        backlog.append(sum(not r.done.is_set() for r in reqs))
    for r in reqs:
        r.done.wait(max(close + drain_s - time.monotonic(), 0.0))
    win.seconds = time.monotonic() - t0
    win.attempted = len(reqs)
    for row, r in enumerate(reqs):
        if (not r.done.is_set() or r.shed or r.error is not None
                or r.result is None or r.rid not in done_at):
            win.failed_rows.append(row)
            continue
        win.latencies_s.append(done_at[r.rid] - (t0 + arrivals[row]))
        _keep([r.result], [row], win)
    win.batch_sizes = list(server.batcher.batches)
    return win
