"""Deterministic storage fault injection + end-to-end record integrity.

The rerank index lives on SSDs, so the serving path inherits storage
failure modes a DRAM index never sees: transient read errors, tail-latency
stalls, bit-flip corruption on the wire, replicas flapping in and out. This
module supplies the three pieces the read path needs to *survive* them:

* ``FaultConfig`` / ``FaultInjector`` — seeded, stateless fault draws
  (``np.random.default_rng([seed, domain, *key])``, the same keying idiom as
  ``ReplicaClock.draw``) so a fault schedule is a pure function of the
  config seed and the read sequence number. Every injected event is billed
  on the simulated device clock: a stall adds ``stall_ms``, a failed
  attempt bills its full read time plus deterministic exponential backoff,
  a repair bills one extra read of the corrupted record.
* **Integrity** — per-doc-record crc32 checksums over the record's payload
  bytes (``compute_checksums``/``add_checksums``/``verify_checksums``).
  Because every layout copy (sharding, segments, compaction) moves raw
  blocks, a record's checksum survives any number of copies unchanged.
  ``wire_corruption_detected`` performs the *real* detection: it flips a
  byte of a copy of the record (the corrupted wire buffer — the on-disk
  image stays healthy) and checks the recomputed crc against the stored
  one.
* **Failure taxonomy** — ``ReadFaultError`` (a read exhausted its retry
  budget), ``ShardReadError`` (one shard of a cluster batch failed; carries
  the time already billed so the clock stays honest), and
  ``DegradedQueryError`` (a backend was asked to fail hard instead of
  answering from resident scores).

The single ``StorageTier`` draws with shard 0 and replica 0; the storage
cluster keys each draw by its shard and replica, on the caller's thread and
in the reference's order, so both schedules are the reference's draw for
draw.

The all-zeros config is inert by construction: ``Pipeline`` only builds an
injector when ``FaultConfig.active()``, and the cluster's clock only enters
the fault path when an event actually fires for that read — so rankings and
per-query bills stay bitwise-identical to a fault-free run.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

# draw domains: independent stateless RNG streams per event type
_ERR, _STALL, _CORRUPT, _FLAP, _VICTIM, _WIRE = 1, 2, 3, 4, 5, 6

#: stats-dict counters every fault-injecting tier maintains (all zero until
#: an event fires; mirrored into LatencyBreakdown / ServeStats as deltas)
FAULT_STAT_KEYS = ("retries", "read_errors", "stalls", "replica_flaps",
                   "corruptions_injected", "checksum_failures", "repairs",
                   "repair_bytes", "faults_injected", "shard_read_failures")


class ReadFaultError(RuntimeError):
    """A storage read failed after exhausting its retry/failover budget."""


class ShardReadError(ReadFaultError):
    """One shard of a cluster read failed (retry budget exhausted on every
    candidate replica, or no replica alive). Carries the simulated seconds
    the failed attempts already consumed — the caller bills them even
    though no bytes moved — and the fault-event counters to fold into
    stats. ``read_batch`` converts this into a per-shard failure that only
    fails the queries touching this shard."""

    def __init__(self, shard: int, *, elapsed_s: float = 0.0,
                 events: dict | None = None, reason: str = "retry budget"):
        super().__init__(f"shard {shard} read failed ({reason})")
        self.shard = shard
        self.elapsed_s = elapsed_s
        self.events = events or {}


class DegradedQueryError(ReadFaultError):
    """A query's SSD rerank read failed and degraded-mode answering is
    disabled (``FaultConfig.degrade=False``) — the backend fails the query
    instead of answering from resident scores."""


@dataclass
class FaultConfig:
    """Seeded fault-injection knobs (the ``--fault-*`` CLI group).

    Rates are per *replica read attempt* (errors, stalls) or per *shard
    read* (corruption, flaps). ``read_retries`` bounds same-replica
    retries; past the budget the read fails over to the next-healthiest
    alive replica. ``checksum`` enables crc32 record verification +
    repair-from-healthy-replica; ``degrade`` lets backends answer failed
    queries from resident scores instead of raising."""
    read_error_rate: float = 0.0   # P(transient error) per read attempt
    stall_rate: float = 0.0        # P(tail-latency stall) per read attempt
    stall_ms: float = 2.0          # stall duration on the device clock
    corruption_rate: float = 0.0   # P(bit-flip corruption) per shard read
    flap_rate: float = 0.0         # P(replica transiently unreachable)
    read_retries: int = 2          # same-replica retries before failover
    retry_backoff_ms: float = 0.5  # backoff base; attempt k waits base*2^k
    checksum: bool = False         # verify crc32 records, repair corruption
    degrade: bool = True           # answer failed queries from resident
                                   # scores (False = fail the query hard)
    seed: int = 0

    def enabled(self) -> bool:
        """Any fault rate configured — the injector has events to draw."""
        return (self.read_error_rate > 0.0 or self.stall_rate > 0.0
                or self.corruption_rate > 0.0 or self.flap_rate > 0.0)

    def active(self) -> bool:
        """The subsystem participates at all (faults OR integrity)."""
        return self.enabled() or self.checksum


class FaultInjector:
    """Stateless deterministic fault draws for one storage stack.

    Every decision is a pure function of ``(cfg.seed, domain, key...)`` —
    no mutable RNG state — so concurrent reads, retries, and reordered
    shard loops all see the same schedule for the same sequence numbers.
    """

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg

    # -- primitive draws ----------------------------------------------------
    def _u(self, domain: int, *key: int) -> float:
        rng = np.random.default_rng([self.cfg.seed, domain,
                                     *[int(k) for k in key]])
        return float(rng.random())

    def read_error(self, seq: int, shard: int, replica: int,
                   attempt: int) -> bool:
        return (self.cfg.read_error_rate > 0.0
                and self._u(_ERR, seq, shard, replica, attempt)
                < self.cfg.read_error_rate)

    def stall(self, seq: int, shard: int, replica: int,
              attempt: int) -> bool:
        return (self.cfg.stall_rate > 0.0
                and self._u(_STALL, seq, shard, replica, attempt)
                < self.cfg.stall_rate)

    def flap(self, seq: int, shard: int, replica: int) -> bool:
        return (self.cfg.flap_rate > 0.0
                and self._u(_FLAP, seq, shard, replica)
                < self.cfg.flap_rate)

    def corrupt(self, seq: int, shard: int) -> bool:
        return (self.cfg.corruption_rate > 0.0
                and self._u(_CORRUPT, seq, shard) < self.cfg.corruption_rate)

    def victim(self, seq: int, shard: int, n: int) -> int:
        """Which of the ``n`` requested docs the corruption lands on."""
        rng = np.random.default_rng([self.cfg.seed, _VICTIM, int(seq),
                                     int(shard)])
        return int(rng.integers(n))

    def backoff_s(self, attempt: int) -> float:
        """Deterministic exponential backoff billed on the device clock."""
        return self.cfg.retry_backoff_ms * 1e-3 * (2.0 ** attempt)

    # -- composite paths ----------------------------------------------------
    def any_event(self, seq: int, shard: int, primary: int) -> bool:
        """Cheap gate for the read path: does ANY fault fire for this read's
        first attempt on its rotating primary? When false the caller takes
        the exact fault-free code path (bitwise identity); when true the
        fault path re-evaluates the same keyed draws consistently."""
        return (self.flap(seq, shard, primary)
                or self.read_error(seq, shard, primary, 0)
                or self.stall(seq, shard, primary, 0)
                or self.corrupt(seq, shard))

    def attempt_loop(self, seq: int, shard: int, replica: int,
                     base_s: float, events: dict) -> tuple[float, bool]:
        """Run the bounded-retry state machine on ONE replica.

        Returns ``(elapsed_s, ok)``: the simulated seconds all attempts on
        this replica consumed (failed attempts bill their full read time
        plus backoff) and whether any attempt succeeded. ``events`` is
        updated in place with retries/stalls/read_errors/faults_injected.
        """
        total = 0.0
        stall_s = self.cfg.stall_ms * 1e-3
        for attempt in range(self.cfg.read_retries + 1):
            t_att = base_s
            if self.stall(seq, shard, replica, attempt):
                t_att += stall_s
                events["stalls"] += 1
                events["faults_injected"] += 1
            if self.read_error(seq, shard, replica, attempt):
                events["read_errors"] += 1
                events["faults_injected"] += 1
                total += t_att + self.backoff_s(attempt)
                if attempt < self.cfg.read_retries:
                    events["retries"] += 1
                continue
            return total + t_att, True
        return total, False

    def wire_corruption_detected(self, layout, gid: int) -> bool:
        """Real end-to-end detection check for one injected corruption.

        Simulates the corrupted *wire buffer* — a copy of the record with
        one deterministically-chosen byte flipped (the on-disk image stays
        healthy) — and verifies that the recomputed crc32 mismatches the
        checksum stored at pack time. crc32 detects any single-byte flip,
        so this returns True whenever the layout carries checksums.
        """
        if getattr(layout, "checksums", None) is None:
            return False
        raw = doc_payload(layout, gid)
        if len(raw) == 0:
            return False
        wire = np.frombuffer(raw, np.uint8).copy()
        rng = np.random.default_rng([self.cfg.seed, _WIRE, int(gid)])
        pos = int(rng.integers(len(wire)))
        wire[pos] ^= np.uint8(1 << int(rng.integers(8)))
        return zlib.crc32(wire.tobytes()) != int(layout.checksums[gid])


#: fault-event counter -> trace span name: the canonical vocabulary for
#: ``cat="fault"`` child spans under a read (``repro_torch.obs`` taxonomy). Order
#: fixed so traced runs emit children deterministically.
FAULT_SPAN_NAMES = (("retries", "retry"), ("stalls", "stall"),
                    ("repairs", "repair"), ("replica_flaps", "flap"),
                    ("read_errors", "read_error"),
                    ("checksum_failures", "checksum_failure"))


def fault_span_counts(events: dict) -> list[tuple[str, int]]:
    """The nonzero ``(span_name, count)`` pairs for one read's fault-event
    dict — exactly the ``cat="fault"`` child spans a tracer should emit, so
    a child span exists iff its counter fired."""
    return [(name, int(events[key])) for key, name in FAULT_SPAN_NAMES
            if events.get(key)]


def zero_fault_stats() -> dict:
    """Fresh zeroed fault counters for a tier's stats dict."""
    return {k: 0 for k in FAULT_STAT_KEYS}


# -- record integrity (crc32 over block payloads) ----------------------------

def doc_payload(layout, i: int) -> memoryview:
    """The used payload bytes of doc ``i``'s record — exactly the bytes
    ``unpack_doc`` reads (block padding excluded, so the checksum is
    invariant across ragged/fixed re-packs of the same record)."""
    start, _ = layout.offsets[i]
    t = int(layout.n_tokens[i])
    elt = layout.dtype.itemsize
    n = (layout.d_cls + t * layout.d_bow) * elt
    s = int(start) * layout.block
    return memoryview(layout.blob[s:s + n])


def compute_checksums(layout) -> np.ndarray:
    """Per-doc crc32 over record payloads: (N,) uint32."""
    out = np.zeros(layout.n_docs, np.uint32)
    for i in range(layout.n_docs):
        out[i] = zlib.crc32(doc_payload(layout, i))
    return out


def add_checksums(layout):
    """Compute and attach checksums in place; returns the layout."""
    layout.checksums = compute_checksums(layout)
    return layout


def verify_checksums(layout, ids=None) -> np.ndarray:
    """Recompute record crc32s against the stored table. Returns a boolean
    ok-mask over ``ids`` (default: every doc). Raises if the layout was
    packed without checksums."""
    if getattr(layout, "checksums", None) is None:
        raise ValueError("layout carries no checksums; pack with "
                         "checksum=True or call add_checksums first")
    ids = np.arange(layout.n_docs) if ids is None \
        else np.asarray(ids, np.int64).ravel()
    ok = np.zeros(len(ids), bool)
    for j, i in enumerate(ids):
        ok[j] = zlib.crc32(doc_payload(layout, int(i))) \
            == int(layout.checksums[int(i)])
    return ok
