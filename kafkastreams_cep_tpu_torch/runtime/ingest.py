"""Ingestion guard — watermark-driven out-of-order absorption + quarantine.

The engine consumes records in arrival order and reproduces SASE+ run
semantics over that order; real streams are out-of-order in *event time*
and occasionally poisoned per record.  The reference absorbs both at the
Kafka layer (partition logs are arrival-ordered; bad records are a serde
concern); this module is the runtime's front door analog, a copy of the
JAX package's ``kafkastreams_cep_tpu/runtime/ingest.py``:

* **Reorder buffer.**  Admitted records are held in a bounded min-heap
  keyed by event time and released only once the **watermark** — the max
  event timestamp seen, minus ``grace_ms`` — passes them, in timestamp
  order.  For any arrival shuffle whose timestamp inversions are bounded
  by the grace (``|ts(y) - ts(x)| <= grace_ms`` whenever ``y`` arrives
  before ``x`` with ``ts(y) > ts(x)``), the released stream is the
  globally timestamp-sorted stream — identical to what the in-order
  trace releases — so matches, emission order, and loss counters are
  **bit-identical** to the in-order run (``tests/test_ingest.py``, and
  against the JAX package in ``tests/test_torch_ingest.py``).  Records with equal timestamps release in
  arrival order.

* **Quarantine / dead-letter.**  Per-record validation defects (schema,
  lane overflow, timestamp range) and too-late events are diverted to a
  capped dead-letter queue — record + typed reason + batch correlation
  id — instead of rejecting the whole batch; the rest of the batch
  proceeds.  ``on_bad_record="raise"`` preserves the strict batch-level
  :class:`InputRejected` behavior.

* **Loss counters.**  ``late_dropped`` (event time older than the
  watermark at arrival), ``quarantined`` (validation defects),
  ``reorder_evictions`` (buffer-depth overflow force-released a record
  before its watermark), and ``overload_shed`` (admissible records shed
  by a brownout ladder; this package has none yet, so it stays 0).  All
  zero ⇒ the guard was loss-free and the release stream is exactly the
  sorted admitted stream.

The guard is first-class durable state: :func:`IngestGuard.to_state`
round-trips through the checkpoint header (``runtime/checkpoint.py``), in
the JAX package's format, so a snapshot with records held in the buffer
restores into either package.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, Dict, List, NamedTuple, Optional

from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("runtime.ingest")

#: Typed dead-letter reasons (the quarantine policy table, README
#: "Graceful ingestion").  This tuple and :data:`REASON_DOCS` are the
#: SINGLE source of truth for the DLQ reason enum: the Prometheus
#: ``dead_letters_total{reason=...}`` label values (utils/telemetry.py
#: renders the ``dead_letters`` snapshot key), and the README policy
#: table (:func:`policy_table_markdown` — tests assert the README embeds
#: its output verbatim) both derive from here.  Adding a reason means
#: adding it here, once.
REASON_SCHEMA = "schema"
REASON_LANE_OVERFLOW = "lane_overflow"
REASON_TIME_RANGE = "time_range"
REASON_LATE = "late"
REASON_TENANT_QUOTA = "tenant_quota"
REASON_OVERLOAD_SHED = "overload_shed"

REASONS = (
    REASON_SCHEMA,
    REASON_LANE_OVERFLOW,
    REASON_TIME_RANGE,
    REASON_LATE,
    REASON_TENANT_QUOTA,
    REASON_OVERLOAD_SHED,
)

#: reason -> (trigger description, loss counter it lands in).  Drives the
#: README "dead-letter policy" table; keep every member of ``REASONS``
#: present (tests/test_tenant_isolation.py enforces the bijection).
REASON_DOCS: Dict[str, tuple] = {
    REASON_SCHEMA: (
        "value tree shape, or a float in an int field, differs from the "
        "first record",
        "`quarantined`",
    ),
    REASON_LANE_OVERFLOW: (
        "a new key past `num_lanes`",
        "`quarantined`",
    ),
    REASON_TIME_RANGE: (
        "timestamp outside int32 device time from the epoch",
        "`quarantined`",
    ),
    REASON_LATE: (
        "event time behind the watermark (or the release frontier) at "
        "arrival",
        "`late_dropped`",
    ),
    REASON_TENANT_QUOTA: (
        "tenant over its admission token bucket, or traffic for a "
        "quarantined tenant (runtime/tenant.py `AdmissionPolicy`)",
        "`admission_shed` / `admission_quarantined_dropped` (per tenant)",
    ),
    REASON_OVERLOAD_SHED: (
        "brownout ladder at L3+ shedding admissible records at ingest "
        "(runtime/overload.py `OverloadController`); deterministic "
        "within-batch stride, so `offered == admitted + shed + "
        "dead_lettered` reconciles exactly",
        "`overload_shed`",
    ),
}

#: Non-reason rows of the policy table (losses that never produce a dead
#: letter but belong in the same contract).
EXTRA_POLICY_ROWS = (
    (
        "—",
        "depth-cap force-release (the record still reaches the engine, "
        "just early)",
        "`reorder_evictions`",
    ),
)


def policy_table_markdown() -> str:
    """Render the dead-letter policy table (README "Graceful ingestion")
    from :data:`REASON_DOCS` — the one place the reason enum is
    documented.  The README embeds this output verbatim."""
    rows = [("reason", "trigger", "counter"), ("---", "---", "---")]
    for reason in REASONS:
        trigger, counter = REASON_DOCS[reason]
        rows.append((f"`{reason}`", trigger, counter))
    rows.extend(EXTRA_POLICY_ROWS)
    return "\n".join("| " + " | ".join(r) + " |" for r in rows)


class AdmissionLimiter:
    """Per-tenant token buckets for record admission (the front door of
    the `tenant_quota` shed path — ``runtime/tenant.py`` wires it ahead
    of packing/dispatch so a flooding tenant is shed before it costs the
    engine anything).

    ``refill()`` once per batch adds ``rate_per_batch`` tokens to every
    known bucket (capped at ``burst``); ``admit(tenant)`` spends one.
    New tenants start with a full burst.  Pure deterministic host state:
    :meth:`to_state` round-trips through the checkpoint header and
    replays identically from the supervisor journal.

    Under brownout (runtime/overload.py L2+) :meth:`set_pressure`
    tightens every bucket proportionally to the tenant's measured cost
    share: the heaviest tenant's refill rate (and a new tenant's initial
    burst) is multiplied by ``scale``, a zero-share tenant keeps factor
    1.0, and tenants with no measured share get the conservative
    ``scale``.  Pressure is part of :meth:`to_state` so a replayed crash
    admits the same records.
    """

    def __init__(self, rate_per_batch: float, burst: Optional[float] = None):
        if rate_per_batch < 0:
            raise ValueError(
                f"rate_per_batch must be >= 0, got {rate_per_batch}"
            )
        self.rate = float(rate_per_batch)
        self.burst = float(burst) if burst is not None else max(
            1.0, 2.0 * self.rate
        )
        self.tokens: Dict[str, float] = {}
        self.pressure_scale: float = 1.0
        self.pressure_shares: Dict[str, float] = {}

    def set_pressure(
        self, scale: float, shares: Optional[Dict[str, float]] = None
    ) -> None:
        """Apply (or at ``scale=1.0`` clear) overload pressure: the
        supervisor's brownout controller calls this on every transition
        and after every restore/migration, so it must be idempotent."""
        self.pressure_scale = min(1.0, max(0.0, float(scale)))
        self.pressure_shares = {
            str(k): float(v) for k, v in (shares or {}).items()
        }

    def _factor(self, tenant: str) -> float:
        if self.pressure_scale >= 1.0:
            return 1.0
        shares = self.pressure_shares
        if not shares:
            return self.pressure_scale
        share = shares.get(tenant)
        if share is None:
            # Unmeasured tenant: no evidence it is cheap, so it gets the
            # full squeeze rather than a free pass.
            return self.pressure_scale
        max_share = max(shares.values())
        if max_share <= 0:
            return 1.0
        return 1.0 - (1.0 - self.pressure_scale) * (share / max_share)

    def refill(self) -> None:
        for tenant in self.tokens:
            self.tokens[tenant] = min(
                self.burst, self.tokens[tenant] + self.rate * self._factor(
                    tenant
                )
            )

    def admit(self, tenant: str) -> bool:
        bucket = self.tokens.get(tenant)
        if bucket is None:
            bucket = self.burst * self._factor(tenant)
        if bucket < 1.0:
            self.tokens[tenant] = bucket
            return False
        self.tokens[tenant] = bucket - 1.0
        return True

    def to_state(self) -> Dict[str, Any]:
        return {
            "rate": self.rate,
            "burst": self.burst,
            "tokens": dict(self.tokens),
            "pressure_scale": self.pressure_scale,
            "pressure_shares": dict(self.pressure_shares),
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "AdmissionLimiter":
        lim = cls(state["rate"], state["burst"])
        lim.tokens = {str(k): float(v) for k, v in state["tokens"].items()}
        # Pre-overload checkpoints carry no pressure keys: default open.
        lim.pressure_scale = float(state.get("pressure_scale", 1.0))
        lim.pressure_shares = {
            str(k): float(v)
            for k, v in state.get("pressure_shares", {}).items()
        }
        return lim


@dataclasses.dataclass(frozen=True)
class IngestPolicy:
    """How the guard absorbs disorder and disposes of bad records.

    ``grace_ms``       — watermark lag: a record is held until the max
                         seen timestamp exceeds its own by this much
                         (0 = release immediately; arrival order must
                         then already be timestamp order).
    ``reorder_depth``  — max records held across all lanes; overflow
                         force-releases the earliest-timestamp record
                         (counted in ``reorder_evictions`` — bounded
                         memory, degraded ordering).
    ``on_bad_record``  — ``"quarantine"`` (default): divert the record
                         to the dead-letter queue and keep going;
                         ``"raise"``: today's strict batch-level
                         :class:`InputRejected`.
    ``dead_letter_cap``— max retained dead letters; beyond it the oldest
                         is dropped (counted, never silent).
    """

    grace_ms: int = 0
    reorder_depth: int = 4096
    on_bad_record: str = "quarantine"
    dead_letter_cap: int = 1024

    def __post_init__(self):
        if self.on_bad_record not in ("quarantine", "raise"):
            raise ValueError(
                f"on_bad_record={self.on_bad_record!r}: expected "
                "'quarantine' or 'raise'"
            )
        if self.grace_ms < 0 or self.reorder_depth < 1:
            raise ValueError(
                f"IngestPolicy needs grace_ms >= 0 and reorder_depth >= 1, "
                f"got grace_ms={self.grace_ms} reorder_depth="
                f"{self.reorder_depth}"
            )


class DeadLetter(NamedTuple):
    """One quarantined record: what, why (typed), and which ingest batch."""

    record: Any
    reason: str
    detail: str
    corr: str


class Defect(NamedTuple):
    """A per-record validation verdict (``None`` = admissible).

    ``silent=True`` marks drops that are policy, not loss (replay
    duplicates) — they are counted by the caller, never dead-lettered.
    """

    reason: str
    detail: str
    silent: bool = False


class IngestGuard:
    """The reorder buffer + dead-letter queue of one processor.

    Pure host state with no device or engine dependencies; the owning
    :class:`CEPProcessor` drives validation (it owns the schema, lane
    map, and epoch) and feeds admitted records through :meth:`push` /
    :meth:`release`.
    """

    def __init__(self, policy: IngestPolicy, clock=None):
        self.policy = policy
        # Injectable wall clock for the latency ledger's admit stamps
        # (tests pin a fake; stamps must survive process restarts, so the
        # default is time.time, not perf_counter).
        self._clock = clock if clock is not None else time.time
        # Min-heap of (timestamp, admission seq, record, admit_stamp):
        # seq is unique, so comparison never reaches the record and
        # equal-timestamp records pop in arrival order.  The admit stamp
        # is the host wall clock at push — it rides the heap entry (and
        # therefore checkpoint state) so reorder-hold latency survives
        # restore without loss.
        self._heap: List[tuple] = []
        self._evicted: List[tuple] = []  # depth-overflow force-releases
        #: Admit stamps of the records the last release()/drain() emitted,
        #: aligned with the returned list (None entries = stamp unknown,
        #: e.g. entries restored from a pre-stamp checkpoint).
        self.last_release_stamps: List[Optional[float]] = []
        self._seq = 0
        # Event-time bookkeeping (absolute ms): max timestamp admitted,
        # and the release frontier — the highest timestamp already handed
        # to the engine (only ever ahead of the watermark after an
        # eviction; admission behind it would disorder the engine stream).
        self.max_seen: Optional[int] = None
        self.frontier: Optional[int] = None
        # Per-lane source-offset high-water marks (at-least-once dedup at
        # admission: the engine sees auto-assigned offsets in release
        # order, so replay dedup must happen here, on the source offsets).
        self.source_hw: Dict[int, int] = {}
        # Loss counters — all zero ⇒ loss-free (README contract).
        self.late_dropped = 0
        self.quarantined = 0
        self.reorder_evictions = 0
        self.overload_shed = 0
        # Non-loss telemetry.
        self.admitted = 0
        self.released = 0
        self.dead_letter_dropped = 0
        self.reason_counts: Dict[str, int] = {}
        self.dead_letters: List[DeadLetter] = []

    # -- admission ----------------------------------------------------------

    @property
    def watermark(self) -> Optional[int]:
        """Max admitted timestamp minus the grace (None before any)."""
        if self.max_seen is None:
            return None
        return self.max_seen - self.policy.grace_ms

    def late_by(self, ts: int) -> Optional[int]:
        """How many ms ``ts`` is behind the release cutoff (None = on
        time).  Strictly behind: a record AT the watermark (or at an
        already-released timestamp) still admits, behind its equals."""
        cutoff = self.watermark
        if self.frontier is not None:
            cutoff = self.frontier if cutoff is None else max(
                cutoff, self.frontier
            )
        if cutoff is None or ts >= cutoff:
            return None
        return cutoff - ts

    def push(self, record) -> None:
        """Admit one validated record into the buffer (may force-release
        the earliest held record when the depth cap is hit)."""
        ts = int(record.timestamp)
        heapq.heappush(self._heap, (ts, self._seq, record, self._clock()))
        self._seq += 1
        self.admitted += 1
        self.max_seen = ts if self.max_seen is None else max(
            self.max_seen, ts
        )
        if len(self._heap) > self.policy.reorder_depth:
            ent = heapq.heappop(self._heap)
            self._evicted.append(ent)
            self.reorder_evictions += 1
            self.frontier = ent[0] if self.frontier is None else max(
                self.frontier, ent[0]
            )

    def observe_time(self, ts: int) -> None:
        """Advance event time without admitting the record (brownout
        sheds): a shed record's timestamp is still *observed*, so the
        watermark keeps moving, held records keep releasing, and the
        backlog clears even while the door is closed (L4 would otherwise
        deadlock — nothing admits, so nothing ever releases)."""
        ts = int(ts)
        self.max_seen = ts if self.max_seen is None else max(
            self.max_seen, ts
        )

    def quarantine(self, record, reason: str, detail: str, corr: str) -> None:
        """Divert one record to the dead-letter queue with a typed reason."""
        if reason == REASON_LATE:
            self.late_dropped += 1
        elif reason == REASON_OVERLOAD_SHED:
            self.overload_shed += 1
        else:
            self.quarantined += 1
        self.reason_counts[reason] = self.reason_counts.get(reason, 0) + 1
        if len(self.dead_letters) >= self.policy.dead_letter_cap:
            self.dead_letters.pop(0)
            self.dead_letter_dropped += 1
        self.dead_letters.append(DeadLetter(record, reason, detail, corr))
        logger.warning(
            "quarantined record (reason=%s, corr=%s): %s", reason, corr,
            detail,
        )

    # -- release ------------------------------------------------------------

    def release(self) -> List:
        """Records whose timestamps the watermark has passed, in
        (timestamp, arrival) order — plus any depth-cap evictions, which
        always precede them (an eviction popped the then-minimum, and
        later admissions behind it are late-dropped at the door)."""
        out = self._evicted
        self._evicted = []
        wm = self.watermark
        if wm is not None:
            while self._heap and self._heap[0][0] <= wm:
                out.append(heapq.heappop(self._heap))
        return self._emit(out)

    def drain(self) -> List:
        """End-of-stream: release everything held, watermark regardless."""
        out = self._evicted
        self._evicted = []
        while self._heap:
            out.append(heapq.heappop(self._heap))
        return self._emit(out)

    def _emit(self, entries: List[tuple]) -> List:
        if entries:
            self.frontier = entries[-1][0] if self.frontier is None else max(
                self.frontier, entries[-1][0]
            )
            self.released += len(entries)
        # len(e) guard: entries restored from a pre-stamp (3-tuple)
        # checkpoint have no admit stamp — their reorder hold reads 0.
        self.last_release_stamps = [
            e[3] if len(e) > 3 else None for e in entries
        ]
        return [e[2] for e in entries]

    # -- telemetry ----------------------------------------------------------

    @property
    def held(self) -> int:
        return len(self._heap) + len(self._evicted)

    def hold_age_ms(self) -> int:
        """Event-time age of the oldest held record (how long the head of
        the buffer has been waiting relative to the newest admission)."""
        if not self._heap or self.max_seen is None:
            return 0
        return max(0, self.max_seen - self._heap[0][0])

    def loss_counters(self) -> Dict[str, int]:
        """The loss contract: all zero ⇒ nothing dropped or disordered."""
        return {
            "late_dropped": self.late_dropped,
            "quarantined": self.quarantined,
            "reorder_evictions": self.reorder_evictions,
            "overload_shed": self.overload_shed,
        }

    def stats(self) -> Dict[str, int]:
        out = dict(self.loss_counters())
        out.update(
            ingest_held=self.held,
            ingest_hold_age_ms=self.hold_age_ms(),
            ingest_admitted=self.admitted,
            ingest_released=self.released,
            dead_letter_depth=len(self.dead_letters),
            dead_letter_dropped=self.dead_letter_dropped,
        )
        if self.watermark is not None:
            out["ingest_watermark"] = self.watermark
        return out

    # -- durability ---------------------------------------------------------

    def to_state(self) -> Dict[str, Any]:
        """Picklable snapshot (checkpoint header payload).  Records and
        dead letters carry user values — the same pickle contract as the
        processor's host event mirror."""
        return {
            "policy": dataclasses.asdict(self.policy),
            "heap": list(self._heap),
            "evicted": list(self._evicted),
            "seq": self._seq,
            "max_seen": self.max_seen,
            "frontier": self.frontier,
            "source_hw": dict(self.source_hw),
            "late_dropped": self.late_dropped,
            "quarantined": self.quarantined,
            "reorder_evictions": self.reorder_evictions,
            "overload_shed": self.overload_shed,
            "admitted": self.admitted,
            "released": self.released,
            "dead_letter_dropped": self.dead_letter_dropped,
            "reason_counts": dict(self.reason_counts),
            "dead_letters": list(self.dead_letters),
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "IngestGuard":
        guard = cls(IngestPolicy(**state["policy"]))
        # Pre-stamp (3-tuple) checkpoint entries pad with a None admit
        # stamp: restored holds read 0 rather than fabricating a stamp.
        def _pad(e):
            e = tuple(e)
            return e if len(e) > 3 else e + (None,)

        guard._heap = [_pad(e) for e in state["heap"]]
        heapq.heapify(guard._heap)
        guard._evicted = [_pad(e) for e in state["evicted"]]
        guard._seq = int(state["seq"])
        guard.max_seen = state["max_seen"]
        guard.frontier = state["frontier"]
        guard.source_hw = {int(k): int(v) for k, v in state["source_hw"].items()}
        guard.late_dropped = int(state["late_dropped"])
        guard.quarantined = int(state["quarantined"])
        guard.reorder_evictions = int(state["reorder_evictions"])
        # Pre-overload checkpoints carry no shed counter: default zero.
        guard.overload_shed = int(state.get("overload_shed", 0))
        guard.admitted = int(state["admitted"])
        guard.released = int(state["released"])
        guard.dead_letter_dropped = int(state["dead_letter_dropped"])
        guard.reason_counts = dict(state["reason_counts"])
        guard.dead_letters = [DeadLetter(*d) for d in state["dead_letters"]]
        return guard
