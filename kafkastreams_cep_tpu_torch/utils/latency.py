"""Latency attribution — the ingest→emit segment ledger.

A copy of the JAX package's ``kafkastreams_cep_tpu/utils/latency.py`` (the
same classes, state format and snapshot), over this package's
``utils/telemetry.py``.  The runtime trades latency for throughput in three
places — reorder grace (``runtime/ingest.py``), lazy-drain deferral
(``drain_interval``) and micro-batching itself — and this module makes
those trades measurable.  Every record is stamped (host wall clock,
injectable) at the five lifecycle boundaries the runtime owns:

======================  ======================================================
boundary                where the stamp is taken
======================  ======================================================
**admit**               ``IngestGuard.push`` — the stamp rides the guard's
                        heap entry (and therefore its checkpoint state)
**release**             reorder-buffer release (``IngestGuard.release`` /
                        ``drain``); equals *admit* when no guard is armed
**dispatch**            ``CEPProcessor._dispatch`` just before the batch's
                        kernels are enqueued
**complete**            once the device finished the batch: serial mode
                        stamps it after the synchronize that ends the device
                        phase; pipelined mode when the next call waits for
                        the batch's outputs before decoding them (a CUDA
                        launch returns before the card is done, so a stamp
                        at the launch would read a device time of about 0)
**emit**                when the batch's matches are decoded and handed to
                        the caller (for lazy extraction: when the drain that
                        carries the batch's handles is decoded)
======================  ======================================================

The deltas roll into fixed-log-bucket **segment histograms** on the
telemetry ``Histogram`` machinery (identical ``LATENCY_EDGES_S`` edges, so
ledgers merge associatively across bank members):

* ``reorder_hold`` = release − admit   (0 when no guard is armed)
* ``queue``        = dispatch − release (host pack + batching wait)
* ``device``       = complete − dispatch
* ``drain_defer``  = emit − complete   (the lazy-extraction tax)
* ``e2e_total``    = the *sum of the four deltas* per record — conservation
  holds by construction: segment histogram sums reconcile with
  ``e2e_total``'s sum to float tolerance (tested).

Commit is transactional: a batch's stamps live in a :class:`BatchLatency`
bundle that is only folded into the histograms at its emit point
(``commit``).  Lazy batches whose handles are still on device are
``defer``-ed and committed when the drain that emits them decodes; the
deferred list is part of ``to_state`` so the ledger survives
checkpoint→restore/migrate with the same exactly-once discipline as every
other piece of durable state (a rolled-back batch's bundle dies with the
rollback and is re-observed on replay — counts are exactly-once; values
are honest wall clock, so a replayed batch's e2e includes the stall that
rolled it back).

Stall attribution: the supervisor feeds ``recover`` / ``evacuate`` /
``replan`` wall time into per-cause stall histograms tagged with the
``corr`` id of the batch they rolled back, so a latency exemplar always
resolves to a real trace span.

:class:`SLOTracker` turns the ledger into an alerting signal: a declared
target percentile + threshold and a rolling window of per-batch
(over-threshold, total) pairs yield a burn rate — the fraction of records
over threshold divided by the SLO's error budget ``1 − target`` — exported
as the ``cep_slo_burn`` gauge (>1.0 means the SLO is burning faster than
budget).

Everything here is host-side Python: no device work, no extra transfers,
and a disarmed ledger costs one ``None`` check per call site.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from kafkastreams_cep_tpu_torch.utils.telemetry import (
    LATENCY_EDGES_S,
    Histogram,
)

#: Per-record segment names, in lifecycle order.  ``e2e_total`` is kept
#: separate: it is derived (sum of these four), not a fifth boundary.
SEGMENTS: Tuple[str, ...] = ("reorder_hold", "queue", "device", "drain_defer")

E2E = "e2e_total"

#: Recognised stall causes (supervisor lifecycle verbs).  Other causes are
#: accepted — these are just the ones the runtime emits today.
STALL_CAUSES: Tuple[str, ...] = ("recover", "evacuate", "replan")


class BatchLatency:
    """One micro-batch's boundary stamps, awaiting commit.

    ``admit`` is a per-record list of admit stamps aligned with the
    released records (``None`` entries — and a ``None`` list — mean "no
    guard: admit coincides with release").  The other stamps are shared by
    every record in the batch: the runtime packs a batch at one host
    instant, dispatches it at one instant, and emits it at one instant, so
    per-record resolution only exists (and is only paid for) on the
    reorder-hold segment.
    """

    __slots__ = ("corr", "n", "admit", "release", "dispatch", "complete")

    def __init__(
        self,
        corr: str,
        n: int,
        admit: Optional[List[Optional[float]]] = None,
        release: Optional[float] = None,
    ):
        self.corr = corr
        self.n = int(n)
        self.admit = admit
        self.release = release
        self.dispatch: Optional[float] = None
        self.complete: Optional[float] = None

    def to_state(self) -> Dict[str, Any]:
        return {
            "corr": self.corr,
            "n": self.n,
            "admit": None if self.admit is None else list(self.admit),
            "release": self.release,
            "dispatch": self.dispatch,
            "complete": self.complete,
        }

    @staticmethod
    def from_state(state: Dict[str, Any]) -> "BatchLatency":
        b = BatchLatency(
            state["corr"], state["n"], state["admit"], state["release"]
        )
        b.dispatch = state["dispatch"]
        b.complete = state["complete"]
        return b


class SLOTracker:
    """Rolling-window SLO burn rate for the ``e2e_total`` segment.

    Declared contract: ``target`` of records finish within ``threshold_s``
    end to end.  Each committed batch contributes an
    ``(over_threshold, total)`` pair to a bounded window; the burn rate is
    the windowed over-threshold fraction divided by the error budget
    ``1 − target``.  Burn 1.0 = exactly on budget; >1.0 = the SLO will be
    violated if the window is representative.  Same shape as a Prometheus
    multiwindow burn alert, minus the multiwindow.
    """

    __slots__ = ("threshold_s", "target", "window", "_pairs")

    def __init__(
        self, threshold_s: float, target: float = 0.99, window: int = 256
    ):
        if not 0.0 < target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1): {target}")
        if threshold_s <= 0.0:
            raise ValueError(f"SLO threshold must be positive: {threshold_s}")
        self.threshold_s = float(threshold_s)
        self.target = float(target)
        self.window = int(window)
        self._pairs: List[Tuple[int, int]] = []

    def observe(self, over: int, total: int) -> None:
        if total <= 0:
            return
        self._pairs.append((int(over), int(total)))
        if len(self._pairs) > self.window:
            del self._pairs[: len(self._pairs) - self.window]

    def burn_rate(self) -> float:
        total = sum(t for _, t in self._pairs)
        if total == 0:
            return 0.0
        over = sum(o for o, _ in self._pairs)
        return (over / total) / (1.0 - self.target)

    def snapshot(self) -> Dict[str, Any]:
        total = sum(t for _, t in self._pairs)
        over = sum(o for o, _ in self._pairs)
        return {
            "target": self.target,
            "threshold_s": self.threshold_s,
            "window_records": total,
            "window_over": over,
            "burn_rate": round(self.burn_rate(), 6),
        }

    def to_state(self) -> Dict[str, Any]:
        return {
            "threshold_s": self.threshold_s,
            "target": self.target,
            "window": self.window,
            "pairs": list(self._pairs),
        }

    @staticmethod
    def from_state(state: Dict[str, Any]) -> "SLOTracker":
        t = SLOTracker(state["threshold_s"], state["target"], state["window"])
        t._pairs = [tuple(p) for p in state["pairs"]]
        return t


class LatencyLedger:
    """Segment histograms + transactional batch bundles + stall attribution.

    The clock is injectable (tests pin a fake; production uses
    ``time.time`` — wall clock, not ``perf_counter``, because stamps must
    stay comparable across a checkpoint→restore process boundary).

    ``merge`` is associative and non-destructive, mirroring
    ``MetricsRegistry.merge``: bank members / mesh shards each keep a local
    ledger and the reporting layer folds them (in-flight deferred bundles
    are live state, not observations, so they stay with their owner).
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.time,
        slo: Optional[SLOTracker] = None,
        edges: Sequence[float] = LATENCY_EDGES_S,
    ):
        self.clock = clock
        self.slo = slo
        self.edges = tuple(float(e) for e in edges)
        self._hists: Dict[str, Histogram] = {
            name: Histogram(name, self.edges) for name in SEGMENTS + (E2E,)
        }
        self._stalls: Dict[str, Histogram] = {}
        self._per_query: Dict[str, Histogram] = {}
        self._deferred: List[BatchLatency] = []
        #: segment -> {"corr", "seconds"} of the worst observation so far;
        #: the corr id matches the batch's trace span (``corr=`` attr), so
        #: an exemplar always resolves to a real span.
        self.exemplars: Dict[str, Dict[str, Any]] = {}
        self.batches_committed = 0
        self.records_committed = 0

    # -- batch lifecycle ------------------------------------------------------

    def start_batch(
        self,
        corr: str,
        n: int,
        admit: Optional[List[Optional[float]]] = None,
        release: Optional[float] = None,
    ) -> BatchLatency:
        """A new bundle for ``n`` records released at ``release`` (now when
        omitted).  ``admit`` is the guard's per-record admit-stamp list (or
        ``None`` when no guard is armed)."""
        if release is None:
            release = self.clock()
        if admit is not None and len(admit) != n:
            # Admission-path drops (dedup inside pack) can desync the
            # stamp list from the packed count; collapse to the no-guard
            # semantics rather than mis-attribute holds across records.
            admit = None
        return BatchLatency(corr, n, admit, release)

    def defer(self, bundle: BatchLatency) -> None:
        """Park a lazy batch whose match handles are still on device; it
        commits when the drain that emits them decodes."""
        self._deferred.append(bundle)

    def commit_deferred(self, emit: Optional[float] = None) -> int:
        """Commit every parked bundle at ``emit`` (their matches just left
        the device in one drain).  Returns the number committed."""
        if emit is None:
            emit = self.clock()
        parked, self._deferred = self._deferred, []
        for bundle in parked:
            self.commit(bundle, emit)
        return len(parked)

    def commit(self, bundle: BatchLatency, emit: Optional[float] = None) -> None:
        """Fold one batch's deltas into the segment histograms.

        ``e2e_total`` is observed as the per-record *sum of the four
        segment deltas* — conservation by construction, not by hoping two
        clock reads agree."""
        n = bundle.n
        if n <= 0:
            return
        if emit is None:
            emit = self.clock()
        release = bundle.release if bundle.release is not None else emit
        dispatch = bundle.dispatch if bundle.dispatch is not None else release
        complete = bundle.complete if bundle.complete is not None else dispatch
        queue = max(dispatch - release, 0.0)
        device = max(complete - dispatch, 0.0)
        defer = max(emit - complete, 0.0)
        shared = queue + device + defer
        self._hists["queue"].observe_many(queue, n)
        self._hists["device"].observe_many(device, n)
        self._hists["drain_defer"].observe_many(defer, n)
        over = 0
        threshold = self.slo.threshold_s if self.slo is not None else None
        if bundle.admit is None:
            self._hists["reorder_hold"].observe_many(0.0, n)
            self._hists[E2E].observe_many(shared, n)
            max_hold, max_e2e = 0.0, shared
            if threshold is not None and shared > threshold:
                over = n
        else:
            e2e_hist = self._hists[E2E]
            hold_hist = self._hists["reorder_hold"]
            max_hold = max_e2e = 0.0
            for a in bundle.admit:
                hold = max(release - a, 0.0) if a is not None else 0.0
                hold_hist.observe(hold)
                e2e = hold + shared
                e2e_hist.observe(e2e)
                if hold > max_hold:
                    max_hold = hold
                if e2e > max_e2e:
                    max_e2e = e2e
                if threshold is not None and e2e > threshold:
                    over += 1
        if self.slo is not None:
            self.slo.observe(over, n)
        for seg, v in (
            ("reorder_hold", max_hold),
            ("queue", queue),
            ("device", device),
            ("drain_defer", defer),
            (E2E, max_e2e),
        ):
            cur = self.exemplars.get(seg)
            if cur is None or v > cur["seconds"]:
                self.exemplars[seg] = {
                    "corr": bundle.corr,
                    "seconds": round(v, 9),
                }
        self.batches_committed += 1
        self.records_committed += n

    # -- side channels --------------------------------------------------------

    def observe_stall(
        self, cause: str, seconds: float, corr: Optional[str] = None
    ) -> None:
        """Supervisor stall time (recover/evacuate/replan) attributed to the
        batch ``corr`` it rolled back."""
        hist = self._stalls.get(cause)
        if hist is None:
            hist = self._stalls[cause] = Histogram(f"stall.{cause}", self.edges)
        hist.observe(seconds)
        if corr is not None:
            key = f"stall.{cause}"
            cur = self.exemplars.get(key)
            if cur is None or seconds > cur["seconds"]:
                self.exemplars[key] = {
                    "corr": corr,
                    "seconds": round(float(seconds), 9),
                }

    def observe_query(self, query: str, seconds: float) -> None:
        """Per-query e2e latency (tenant-bank path: one label per query)."""
        hist = self._per_query.get(query)
        if hist is None:
            hist = self._per_query[query] = Histogram(
                f"query.{query}", self.edges
            )
        hist.observe(seconds)

    # -- aggregation / durability ---------------------------------------------

    def merge(self, other: "LatencyLedger") -> "LatencyLedger":
        """A NEW ledger holding both operands' committed observations.
        Associative and commutative (tested); deferred bundles and the
        clock stay with their owners — the merged view is for reporting."""
        if self.edges != other.edges:
            raise ValueError("cannot merge ledgers with different edges")
        out = LatencyLedger(clock=self.clock, slo=None, edges=self.edges)
        for name in self._hists:
            out._hists[name] = self._hists[name].merge(other._hists[name])
        for src in (self._stalls, other._stalls):
            for cause, hist in src.items():
                have = out._stalls.get(cause)
                out._stalls[cause] = hist if have is None else have.merge(hist)
        for src in (self._per_query, other._per_query):
            for q, hist in src.items():
                have = out._per_query.get(q)
                out._per_query[q] = hist if have is None else have.merge(hist)
        for src in (self.exemplars, other.exemplars):
            for seg, ex in src.items():
                cur = out.exemplars.get(seg)
                # Ties break on corr so the merge stays commutative.
                if cur is None or ex["seconds"] > cur["seconds"] or (
                    ex["seconds"] == cur["seconds"]
                    and ex["corr"] < cur["corr"]
                ):
                    out.exemplars[seg] = dict(ex)
        if self.slo is not None and other.slo is None:
            out.slo = SLOTracker.from_state(self.slo.to_state())
        elif self.slo is not None and other.slo is not None:
            out.slo = SLOTracker.from_state(self.slo.to_state())
            out.slo._pairs = (self.slo._pairs + other.slo._pairs)[
                -out.slo.window:
            ]
        elif other.slo is not None:
            out.slo = SLOTracker.from_state(other.slo.to_state())
        out.batches_committed = self.batches_committed + other.batches_committed
        out.records_committed = self.records_committed + other.records_committed
        return out

    def _hist_state(self, h: Histogram) -> Dict[str, Any]:
        return {"counts": list(h.counts), "total": h.total, "sum": h.sum}

    def to_state(self) -> Dict[str, Any]:
        """Picklable durable form — everything but the clock (a restored
        ledger runs on wall clock unless the caller re-injects one)."""
        return {
            "edges": list(self.edges),
            "hists": {n: self._hist_state(h) for n, h in self._hists.items()},
            "stalls": {n: self._hist_state(h) for n, h in self._stalls.items()},
            "per_query": {
                n: self._hist_state(h) for n, h in self._per_query.items()
            },
            "deferred": [b.to_state() for b in self._deferred],
            "exemplars": {k: dict(v) for k, v in self.exemplars.items()},
            "slo": None if self.slo is None else self.slo.to_state(),
            "batches_committed": self.batches_committed,
            "records_committed": self.records_committed,
        }

    @staticmethod
    def from_state(
        state: Dict[str, Any], clock: Callable[[], float] = time.time
    ) -> "LatencyLedger":
        slo = (
            SLOTracker.from_state(state["slo"])
            if state.get("slo") is not None
            else None
        )
        out = LatencyLedger(clock=clock, slo=slo, edges=state["edges"])

        def _load(name: str, hs: Dict[str, Any]) -> Histogram:
            h = Histogram(name, out.edges)
            h.counts = list(hs["counts"])
            h.total = hs["total"]
            h.sum = hs["sum"]
            return h

        for name, hs in state["hists"].items():
            out._hists[name] = _load(name, hs)
        for cause, hs in state["stalls"].items():
            out._stalls[cause] = _load(f"stall.{cause}", hs)
        for q, hs in state["per_query"].items():
            out._per_query[q] = _load(f"query.{q}", hs)
        out._deferred = [BatchLatency.from_state(b) for b in state["deferred"]]
        out.exemplars = {k: dict(v) for k, v in state["exemplars"].items()}
        out.batches_committed = state["batches_committed"]
        out.records_committed = state["records_committed"]
        return out

    # -- reporting ------------------------------------------------------------

    def _seg_snapshot(self, h: Histogram) -> Dict[str, Any]:
        snap = h.snapshot()
        snap["p95"] = h.percentile(0.95)
        snap["p999"] = h.percentile(0.999)
        return snap

    def snapshot(self) -> Dict[str, Any]:
        """Deterministic dict form (under a pinned clock, identical runs
        produce identical snapshots — tested).  Segment entries are full
        histogram snapshots plus p95/p999; ``render_prometheus`` turns the
        structure into ``cep_latency_seconds{segment=}``,
        ``cep_stall_seconds{cause=}``, ``cep_latency_query_seconds{query=}``
        and the ``cep_slo_burn`` gauge."""
        out: Dict[str, Any] = {
            "segments": {
                name: self._seg_snapshot(self._hists[name])
                for name in SEGMENTS + (E2E,)
            },
            "batches": self.batches_committed,
            "records": self.records_committed,
            "deferred_batches": len(self._deferred),
        }
        if self._stalls:
            out["stalls"] = {
                cause: self._seg_snapshot(h)
                for cause, h in sorted(self._stalls.items())
            }
        if self._per_query:
            out["per_query"] = {
                q: self._seg_snapshot(h)
                for q, h in sorted(self._per_query.items())
            }
        if self.exemplars:
            out["exemplars"] = {
                k: dict(v) for k, v in sorted(self.exemplars.items())
            }
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        return out
