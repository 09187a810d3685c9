"""Telemetry subsystem — the ``StreamsMetrics`` registry the reference
exposes but never records into (SURVEY §5), rebuilt for this runtime.

Four pillars, each mapped to its Kafka Streams analog:

* **MetricsRegistry** (:class:`MetricsRegistry`) — named counters, gauges,
  and fixed-log-bucket histograms.  The analog of
  ``StreamsMetrics``/``Sensor``: where the reference hands processors a
  registry through ``ProcessorContext.metrics()`` and then records nothing
  (``CEPProcessor.java`` never calls it), every layer here owns or feeds a
  registry and the snapshots are real.  Histogram bucket edges are
  deterministic (log-spaced, computed once), so snapshots of identical
  runs are bit-identical and histograms **merge** across bank members and
  mesh shards (``merge`` is associative — tested).  :func:`positive_delta`
  is the registry-level diffing the supervisor's escalation detector uses
  (replacing its hand-rolled ``_capacity_counters`` subtraction).
* **Span tracing** (:class:`TraceSink` / :meth:`TraceSink.span`) — the
  analog of Kafka Streams' per-node ``process-latency`` sensors, but as
  correlated JSON-lines events: one ``batch`` span per micro-batch (batch
  id, journal seq, lane count) with nested phase spans for
  ``pack → dispatch → device → decode → gc`` and child spans inside them
  (``pack.lanes``, ``decode.wait``, ``gc.sweep``, ...), plus supervisor lifecycle
  spans (``checkpoint`` / ``recover`` / ``escalate``) and armed failpoint
  hits.  A recovery span carries the ``corr`` id of the batch span it
  rolled back, so an operator can walk from a recovery straight to the
  batch that triggered it.
* **Attribution** — per-lane (the partition analog) and per-pattern (bank
  member) engine-counter breakdowns beside the lane-summed view, plus
  watermark / event-time-lag gauges and device-memory gauges
  (``metrics.device_memory_stats``) — the ``*-rate`` /
  ``records-lag`` metrics Kafka Streams derives from the consumer.
* **Export** (:func:`render_prometheus`, :class:`Reporter`) — Prometheus
  text exposition of any snapshot, and a cadence-driven flusher that
  writes metrics snapshots into the same JSONL stream the spans use (the
  JMX-reporter analog, minus JMX).

Nothing here touches the device: all instruments are host-side Python, and
disarmed tracing costs one ``None`` check per call site.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple


# -- histogram bucket edges ---------------------------------------------------

def log_bucket_edges(
    lo: float = 1e-6, hi: float = 100.0, per_decade: int = 4
) -> Tuple[float, ...]:
    """Deterministic log-spaced bucket edges covering ``[lo, hi]``.

    Edges are ``10**(i / per_decade)`` for integer ``i`` — a pure function
    of the arguments, so two registries built anywhere produce identical
    edges and their histograms are mergeable.
    """
    i0 = math.floor(math.log10(lo) * per_decade)
    i1 = math.ceil(math.log10(hi) * per_decade)
    return tuple(10.0 ** (i / per_decade) for i in range(i0, i1 + 1))


#: Default edges for wall-time-in-seconds observations: 1µs .. 100s,
#: 4 buckets per decade.  Every phase/lifecycle histogram in the runtime
#: uses these, so any two are mergeable.
LATENCY_EDGES_S = log_bucket_edges(1e-6, 100.0, 4)


# -- instruments --------------------------------------------------------------

class Counter:
    """A monotonically increasing named value (int or float seconds)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """A set-to-current-value instrument (watermarks, device-memory bytes)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Fixed-log-bucket histogram: deterministic edges, mergeable.

    ``counts[i]`` holds observations ``<= edges[i]``; ``counts[-1]`` is the
    overflow bucket.  Percentiles interpolate to the geometric midpoint of
    the covering bucket — coarse by design (the edges are the resolution
    contract), but deterministic and exact under merge: merging N shards'
    histograms and asking for p99 gives the same answer as one histogram
    fed all N streams.
    """

    __slots__ = ("name", "edges", "counts", "total", "sum")

    def __init__(self, name: str, edges: Sequence[float] = LATENCY_EDGES_S):
        self.name = name
        self.edges = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError(f"histogram edges must be strictly increasing: {edges}")
        self.counts = [0] * (len(self.edges) + 1)
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.total += 1
        self.sum += v
        # Bisect over a couple dozen edges: fine at batch cadence.
        lo, hi = 0, len(self.edges)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.edges[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1

    def observe_many(self, v: float, n: int) -> None:
        """``n`` observations of the same value ``v`` — one bisect, not
        ``n``.  The latency ledger's shared-stamp segments (every record in
        a micro-batch dispatches/completes/emits at one host instant) make
        this the hot path for per-record attribution at batch cadence."""
        if n <= 0:
            return
        v = float(v)
        self.total += n
        self.sum += v * n
        lo, hi = 0, len(self.edges)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.edges[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += n

    def merge(self, other: "Histogram") -> "Histogram":
        """A NEW histogram holding both operands' observations.  Requires
        identical edges (the determinism contract that makes merging across
        bank members / shards exact).  Associative and commutative."""
        if self.edges != other.edges:
            raise ValueError(
                f"cannot merge histograms with different edges: "
                f"{self.name} vs {other.name}"
            )
        out = Histogram(self.name, self.edges)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.total = self.total + other.total
        out.sum = self.sum + other.sum
        return out

    def percentile(self, q: float) -> float:
        """The ``q``-quantile (``0 < q <= 1``) at bucket resolution: the
        geometric midpoint of the first bucket whose cumulative count
        reaches ``q * total`` (0.0 on an empty histogram)."""
        if self.total == 0:
            return 0.0
        target = q * self.total
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                if i == 0:
                    return self.edges[0]
                if i == len(self.edges):
                    return self.edges[-1]
                return math.sqrt(self.edges[i - 1] * self.edges[i])
        return self.edges[-1]

    def snapshot(self) -> Dict[str, Any]:
        """Deterministic dict form: totals, p50/p99, and the non-empty
        buckets as ``(upper_edge, cumulative_count)`` pairs (the overflow
        bucket renders with edge ``inf``)."""
        buckets: List[Tuple[float, int]] = []
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if c:
                edge = self.edges[i] if i < len(self.edges) else math.inf
                buckets.append((edge, cum))
        return {
            "count": self.total,
            "sum": round(self.sum, 9),
            "p50": self.percentile(0.50),
            "p99": self.percentile(0.99),
            "buckets": buckets,
        }


class MetricsRegistry:
    """Named instruments with deterministic snapshots.

    ``counter`` / ``gauge`` / ``histogram`` create-or-fetch by name (a name
    re-used with a different instrument type raises — names are the
    contract downstream dashboards key on).  ``snapshot()`` is sorted by
    name, so two registries that saw the same operations serialize
    identically; ``merge`` is the cross-member/cross-shard aggregation
    (counters and histograms add; gauges take the *other* registry's value
    when both carry one — last-writer, like a re-emitted gauge).
    """

    def __init__(self):
        self._instruments: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *args)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}"
                )
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(
        self, name: str, edges: Sequence[float] = LATENCY_EDGES_S
    ) -> Histogram:
        return self._get(name, Histogram, edges)

    def items(self) -> List[Tuple[str, Any]]:
        """``(name, instrument)`` pairs sorted by name."""
        return sorted(self._instruments.items())

    def snapshot(self) -> Dict[str, Any]:
        """Flat name->value dict (histograms nest their snapshot dict),
        sorted by name — identical runs produce identical snapshots."""
        out: Dict[str, Any] = {}
        for name, inst in self.items():
            out[name] = (
                inst.snapshot() if isinstance(inst, Histogram) else inst.value
            )
        return out

    def delta(self, base: Dict[str, Any]) -> Dict[str, Any]:
        """Positive counter/gauge movement since ``base`` (a prior
        ``snapshot()`` or any name->number dict) — the supervisor's
        capacity-trip detector in registry form."""
        return positive_delta(
            {
                n: i.value
                for n, i in self.items()
                if isinstance(i, (Counter, Gauge))
            },
            base,
        )

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """A NEW registry aggregating both operands (see class docstring
        for per-instrument semantics).  Associative over counter and
        histogram content."""
        out = MetricsRegistry()
        for name, inst in self.items():
            if isinstance(inst, Histogram):
                out._instruments[name] = inst.merge(
                    Histogram(name, inst.edges)
                )
            elif isinstance(inst, Counter):
                out.counter(name).value = inst.value
            else:
                out.gauge(name).value = inst.value
        for name, inst in other.items():
            if isinstance(inst, Histogram):
                mine = out._instruments.get(name)
                out._instruments[name] = (
                    inst.merge(Histogram(name, inst.edges))
                    if mine is None
                    else mine.merge(inst)
                )
            elif isinstance(inst, Counter):
                out.counter(name).value += inst.value
            else:
                out.gauge(name).value = inst.value
        return out


def positive_delta(
    curr: Dict[str, Any], base: Dict[str, Any]
) -> Dict[str, Any]:
    """``{k: curr[k] - base[k]}`` for every key that moved UP — the one
    diffing primitive behind capacity-trip detection (cumulative counters,
    so a trip is a positive per-batch delta)."""
    out = {}
    for k, v in curr.items():
        d = v - base.get(k, 0)
        if d > 0:
            out[k] = d
    return out


def merge_counter_dicts(dicts: Sequence[Dict[str, int]]) -> Dict[str, int]:
    """Key-wise sum of plain counter dicts (bank members, shard reports)."""
    out: Dict[str, int] = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


# -- span tracing -------------------------------------------------------------

class TraceSink:
    """Base sink: correlated span/event emission with parent tracking.

    Span ids are per-sink monotone integers (deterministic given the same
    call sequence); the active-span stack supplies ``parent_id``, so
    phases opened inside a batch span nest under it without any explicit
    plumbing.  Subclasses implement :meth:`write`.
    """

    def __init__(self):
        self._ids = itertools.count(1)
        self._stack: List[int] = []
        self._lock = threading.Lock()

    # subclass hook
    def write(self, event: Dict[str, Any]) -> None:
        raise NotImplementedError

    def emit(self, event: Dict[str, Any]) -> None:
        self.write(event)

    def event(self, name: str, **attrs: Any) -> None:
        """A point event (no duration) — failpoint hits, warnings."""
        with self._lock:
            parent = self._stack[-1] if self._stack else None
        evt = {
            "type": "event",
            "name": name,
            "ts_ms": round(time.time() * 1000.0, 3),
            "parent_id": parent,
        }
        evt.update(attrs)
        self.emit(evt)

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Dict[str, Any]]:
        """Time a region and emit one span record on exit.

        Yields a mutable dict; keys set on it during the span land in the
        emitted record (match counts, replay sizes — facts only known at
        the end).  Exceptions propagate; the span still emits, flagged
        with ``error`` so a trace never silently swallows a failure.
        """
        with self._lock:
            sid = next(self._ids)
            parent = self._stack[-1] if self._stack else None
            self._stack.append(sid)
        extra: Dict[str, Any] = {}
        wall = time.time()
        t0 = time.perf_counter()
        err: Optional[str] = None
        try:
            yield extra
        except BaseException as e:
            err = f"{type(e).__name__}: {e}"
            raise
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                if self._stack and self._stack[-1] == sid:
                    self._stack.pop()
            evt = {
                "type": "span",
                "name": name,
                "span_id": sid,
                "parent_id": parent,
                "ts_ms": round(wall * 1000.0, 3),
                "duration_ms": round(dt * 1000.0, 6),
            }
            evt.update(attrs)
            evt.update(extra)
            if err is not None:
                evt["error"] = err
            self.emit(evt)


class InMemoryTraceSink(TraceSink):
    """Collects events in ``self.events`` — tests and ad-hoc inspection."""

    def __init__(self):
        super().__init__()
        self.events: List[Dict[str, Any]] = []

    def write(self, event: Dict[str, Any]) -> None:
        self.events.append(event)

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [
            e
            for e in self.events
            if e["type"] == "span" and (name is None or e["name"] == name)
        ]


class JsonlTraceSink(TraceSink):
    """JSON-lines sink: one compact JSON object per line to a path or any
    file-like object.  The same stream carries spans, point events,
    Reporter metrics snapshots, and (with
    ``configure_logging(json_lines=True)``) lifecycle logs — one
    machine-parseable firehose.

    Path-owned sinks write each fully-serialized line through ONE
    unbuffered binary write (open ``"ab", buffering=0``): a crash between
    records leaves whole lines only, never a torn tail — the append-side
    twin of the Reporter's atomic ``.prom`` replace (and failpoint-tested
    through ``report.write``).

    ``max_bytes`` / ``max_age_s`` bound a path-owned file: when either is
    exceeded *at a line boundary*, the current file rolls to ``<path>.1``
    (replacing any previous rollover — one retained generation) and a
    fresh file starts.  Long-running supervisors previously grew the
    JSONL without bound.
    """

    def __init__(
        self,
        target,
        max_bytes: Optional[int] = None,
        max_age_s: Optional[float] = None,
    ):
        super().__init__()
        self.max_bytes = max_bytes
        self.max_age_s = max_age_s
        self.rollovers = 0
        if isinstance(target, (str, bytes)):
            self._path = target if isinstance(target, str) else target.decode()
            self._owns = True
            self._open()
        else:
            self._path = None
            self._fh = target
            self._owns = False
            self._size = 0
            self._birth = time.monotonic()

    def _open(self) -> None:
        self._fh = open(self._path, "ab", buffering=0)
        self._size = self._fh.tell()
        self._birth = time.monotonic()

    def _maybe_rotate(self, incoming: int) -> None:
        if self._path is None or not self._size:
            return
        over_size = (
            self.max_bytes is not None
            and self._size + incoming > self.max_bytes
        )
        over_age = (
            self.max_age_s is not None
            and time.monotonic() - self._birth >= self.max_age_s
        )
        if not (over_size or over_age):
            return
        self._fh.close()
        os.replace(self._path, self._path + ".1")
        self.rollovers += 1
        self._open()

    def write(self, event: Dict[str, Any]) -> None:
        data = (json.dumps(event, default=str) + "\n").encode("utf-8")
        if self._owns:
            self._maybe_rotate(len(data))
            self._fh.write(data)  # single unbuffered write: whole lines only
        else:
            self._fh.write(data.decode("utf-8"))
            flush = getattr(self._fh, "flush", None)
            if flush is not None:
                flush()
        self._size += len(data)

    def close(self) -> None:
        if self._owns:
            self._fh.close()


@contextlib.contextmanager
def maybe_span(
    sink: Optional[TraceSink], name: str, **attrs: Any
) -> Iterator[Dict[str, Any]]:
    """``sink.span(...)`` when tracing is on; a throwaway dict when off —
    call sites stay branch-free."""
    if sink is None:
        yield {}
    else:
        with sink.span(name, **attrs) as extra:
            yield extra


@contextlib.contextmanager
def timed_histogram(
    registry: MetricsRegistry,
    name: str,
    edges: Sequence[float] = LATENCY_EDGES_S,
) -> Iterator[None]:
    """Observe the enclosed block's wall seconds into ``registry``'s
    histogram ``name`` (lifecycle latencies: checkpoint/recover/escalate)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        registry.histogram(name, edges).observe(time.perf_counter() - t0)


# Default sink: the hook :mod:`utils.failpoints` reports armed-site hits
# through, so chaos traces show the injected fault next to the recovery
# span it provoked.  Explicitly installed (never implicit) — production
# runs with no sink pay nothing.
_DEFAULT_SINK: Optional[TraceSink] = None


def set_default_sink(sink: Optional[TraceSink]) -> Optional[TraceSink]:
    """Install (or clear, with None) the process-default trace sink;
    returns the previous one so callers can restore it."""
    global _DEFAULT_SINK
    prev = _DEFAULT_SINK
    _DEFAULT_SINK = sink
    return prev


def get_default_sink() -> Optional[TraceSink]:
    return _DEFAULT_SINK


# -- Prometheus export --------------------------------------------------------

def _sanitize(name: str) -> str:
    return "".join(
        c if (c.isalnum() or c in "_:") else "_" for c in name
    ).strip("_")


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return repr(v)
    return str(v)


def _is_hist_snap(v) -> bool:
    return isinstance(v, dict) and {"count", "sum", "buckets"} <= set(v)


#: Entries of ``layers["counters"]`` that are levels, rendered as gauges.
LAYER_LEVELS = ("host_events",)

#: Curated HELP text by unprefixed metric family name.  Families not
#: listed fall back to a deterministic pointer at the README reference —
#: the metrics-guard test (tests/test_metrics_guard.py) only requires that
#: *every* emitted family carries HELP/TYPE, which the fallback guarantees.
METRIC_HELP: Dict[str, str] = {
    "phase_seconds": (
        "Host wall time per processing phase (pack/dispatch/device/decode/"
        "gc and supervisor lifecycle verbs)"
    ),
    "latency_seconds": (
        "Per-record ingest-to-emit latency by lifecycle segment "
        "(reorder_hold/queue/device/drain_defer/e2e_total)"
    ),
    "stall_seconds": (
        "Supervisor stall wall time (recover/evacuate/replan) attributed "
        "to the batch it rolled back"
    ),
    "latency_query_seconds": (
        "Per-query end-to-end latency (multi-tenant bank)"
    ),
    "slo_burn": (
        "SLO burn rate: windowed over-threshold record fraction divided by "
        "the error budget (1 - target); >1 burns faster than budget"
    ),
    "slo_target": "Declared SLO target percentile (fraction in (0,1))",
    "slo_threshold_seconds": "Declared SLO end-to-end latency threshold",
    "dead_letters_total": "Ingestion-guard quarantined records by reason",
    "event_time_lag_ms": (
        "Milliseconds between the host clock and the event-time watermark"
    ),
    "watermark": (
        "Event-time watermark: max packed record timestamp (ms since epoch)"
    ),
    "key_hops_total": "Walk-kernel hop work summed over all keys",
    "key_hops": "Walk-kernel hop work for the top-K heaviest keys",
    "overload_level": (
        "Brownout ladder level (runtime/overload.py): 0 healthy, 1 "
        "telemetry/drain degraded, 2 admission squeezed, 3 shedding, "
        "4 emergency admission stop"
    ),
    "overload_pressure": (
        "Overload pressure scalar: max of the normalized controller "
        "signals (SLO burn, reorder hold depth/age, queue p99, drain "
        "backlog); 1.0 = at the L1 entry reference"
    ),
    "overload_transitions": (
        "Committed brownout ladder transitions (either direction), each "
        "pinned by a checkpoint"
    ),
    "overload_transition_failures": (
        "Aborted ladder transition protocols (failpoint or pin-snapshot "
        "failure); the previous level stayed authoritative"
    ),
    "layer_span_seconds": (
        "Host wall time per child span inside a batch phase (pack.lanes/"
        "pack.columns/pack.copy, dispatch.sweep, device.wait, decode.wait/"
        "decode.build, gc.read/gc.sweep)"
    ),
    "layer_steps_total": "Engine steps dispatched (each batch's padded length)",
    "layer_decode_events_materialized_total": (
        "Events the decode built from packed column rows"
    ),
    "layer_gc_events_materialized_total": (
        "Events the event GC built from packed column rows (still live)"
    ),
    "layer_gc_events_dropped_total": (
        "Host events the event GC dropped (unreachable from device state)"
    ),
    "layer_host_events": "Events the host mirror held after the last event GC",
    "overload_shed": (
        "Admissible records shed at the ingest door under brownout "
        "(L3+), each a typed overload_shed dead letter — offered == "
        "admitted + shed + dead_lettered reconciles exactly"
    ),
}


def render_prometheus(
    snapshot: Dict[str, Any], prefix: str = "cep"
) -> str:
    """A metrics snapshot (``MetricsRegistry.snapshot()`` or any
    ``metrics_snapshot()`` dict in this runtime) as Prometheus text
    exposition, deterministically ordered.

    Structural keys get labels instead of name-mangling:
    ``per_lane``  -> ``{lane="i"}``, ``per_pattern`` -> ``{pattern="name"}``,
    ``per_query`` -> ``{query="name"}`` (the multi-tenant bank),
    ``phases``    -> ``<prefix>_phase_seconds{phase="name"}`` histograms,
    ``latency``   -> ``<prefix>_latency_seconds{segment="name"}`` histograms
    plus stall/per-query histograms and the ``<prefix>_slo_burn`` gauge
    (the latency-attribution ledger, utils/latency.py),
    ``dead_letters`` -> ``<prefix>_dead_letters_total{reason="late"}``,
    ``hbm``       -> ``<prefix>_hbm_<stat>`` gauges,
    ``layers``    -> ``<prefix>_layer_span_seconds{span="name"}`` histograms
    plus ``<prefix>_layer_<count>_total`` counters (``host_events``, a
    level, as the gauge ``<prefix>_layer_host_events``).  Histogram snapshots
    render as cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``.
    ``None`` values are skipped (absent, not zero).

    Every emitted family is preceded (at first occurrence) by ``# HELP`` /
    ``# TYPE`` metadata: curated text from :data:`METRIC_HELP` where
    available, a deterministic README pointer otherwise; type is
    ``histogram`` for histogram families, ``counter`` for ``_total``
    names, ``gauge`` for the rest.
    """
    lines: List[str] = []
    seen_meta: set = set()

    def meta(name: str, mtype: str) -> None:
        if name in seen_meta:
            return
        seen_meta.add(name)
        base = name[len(prefix) + 1:] if name.startswith(f"{prefix}_") else name
        text = METRIC_HELP.get(
            base, "runtime metric (see README metrics reference)"
        )
        lines.append(f"# HELP {name} {text}")
        lines.append(f"# TYPE {name} {mtype}")

    def scalar(name: str, v, labels: str = "") -> None:
        if v is None or isinstance(v, str):
            return
        meta(name, "counter" if name.endswith("_total") else "gauge")
        lines.append(f"{name}{labels} {_fmt(v)}")

    def hist(name: str, snap: Dict[str, Any], labels: Dict[str, str]) -> None:
        meta(name, "histogram")
        base = ",".join(f'{k}="{v}"' for k, v in labels.items())
        pre = f"{base}," if base else ""
        for edge, cum in snap["buckets"]:
            le = "+Inf" if edge == math.inf else repr(edge)
            lines.append(f'{name}_bucket{{{pre}le="{le}"}} {cum}')
        if not snap["buckets"] or snap["buckets"][-1][0] != math.inf:
            lines.append(f'{name}_bucket{{{pre}le="+Inf"}} {snap["count"]}')
        suffix = f"{{{base}}}" if base else ""
        lines.append(f"{name}_sum{suffix} {_fmt(snap['sum'])}")
        lines.append(f"{name}_count{suffix} {snap['count']}")

    for key in sorted(snapshot):
        val = snapshot[key]
        name = f"{prefix}_{_sanitize(key)}"
        if key == "phases" and isinstance(val, dict):
            for phase in sorted(val):
                hist(f"{prefix}_phase_seconds", val[phase], {"phase": phase})
        elif key == "per_lane" and isinstance(val, dict):
            for cname in sorted(val):
                series = val[cname]
                for lane, v in enumerate(series):
                    if v:
                        scalar(
                            f"{prefix}_{_sanitize(cname)}",
                            v,
                            f'{{lane="{lane}"}}',
                        )
        elif key == "dead_letters" and isinstance(val, dict):
            # Ingestion-guard quarantine counts by typed reason
            # (runtime/ingest.py): one labeled series per reason.
            for reason in sorted(val):
                scalar(
                    f"{prefix}_dead_letters_total",
                    val[reason],
                    f'{{reason="{reason}"}}',
                )
        elif key == "per_stage" and isinstance(val, dict):
            # Per-stage selectivity/cost attribution
            # (EngineConfig.stage_attribution): one labeled series per
            # stage per metric.
            for stage in sorted(val):
                sub = val[stage]
                if not isinstance(sub, dict):
                    continue
                for cname in sorted(sub):
                    v = sub[cname]
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        scalar(
                            f"{prefix}_{_sanitize(cname)}",
                            v,
                            f'{{stage="{stage}"}}',
                        )
                    elif cname == "conjuncts" and isinstance(v, dict):
                        # Measured per-conjunct tallies (lazy-chain
                        # ranking input): stage+conjunct labeled series.
                        for ckey in sorted(v):
                            row = v[ckey]
                            if not isinstance(row, dict):
                                continue
                            for mname in sorted(row):
                                mv = row[mname]
                                if isinstance(
                                    mv, (int, float)
                                ) and not isinstance(mv, bool):
                                    scalar(
                                        f"{prefix}_conjunct_"
                                        f"{_sanitize(mname)}",
                                        mv,
                                        f'{{stage="{stage}",'
                                        f'conjunct="{ckey}"}}',
                                    )
        elif key == "per_key" and isinstance(val, dict):
            # Heavy-hitter cost attribution by key (processor
            # ``per_key_cost``): the top-K lanes' walk work as gauges.
            scalar(f"{prefix}_key_hops_total", val.get("total_hops"))
            for ent in val.get("top", []):
                scalar(
                    f"{prefix}_key_hops",
                    ent.get("hops"),
                    f'{{key="{ent.get("key")}",lane="{ent.get("lane")}"}}',
                )
        elif key == "per_pattern" and isinstance(val, dict):
            for pat in sorted(val):
                sub = val[pat]
                if not isinstance(sub, dict):
                    continue
                for cname in sorted(sub):
                    v = sub[cname]
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        scalar(
                            f"{prefix}_{_sanitize(cname)}",
                            v,
                            f'{{pattern="{pat}"}}',
                        )
        elif key == "per_query" and isinstance(val, dict):
            # Multi-tenant bank attribution (parallel/tenantbank.py):
            # per-query engine + tier counters under a ``query`` label,
            # so one scrape distinguishes tenants sharing a dispatch.
            for qname in sorted(val):
                sub = val[qname]
                if not isinstance(sub, dict):
                    continue
                for cname in sorted(sub):
                    v = sub[cname]
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        scalar(
                            f"{prefix}_{_sanitize(cname)}",
                            v,
                            f'{{query="{qname}"}}',
                        )
        elif key == "latency" and isinstance(val, dict):
            # Latency-attribution ledger (utils/latency.py): one histogram
            # per lifecycle segment, per-cause stall histograms, per-query
            # e2e histograms, and the SLO burn gauge.  Exemplars stay in
            # the JSON snapshot (text exposition has no exemplar syntax).
            segs = val.get("segments", {})
            for seg in sorted(segs):
                if _is_hist_snap(segs[seg]):
                    hist(
                        f"{prefix}_latency_seconds", segs[seg],
                        {"segment": seg},
                    )
            stalls = val.get("stalls", {})
            for cause in sorted(stalls):
                if _is_hist_snap(stalls[cause]):
                    hist(
                        f"{prefix}_stall_seconds", stalls[cause],
                        {"cause": cause},
                    )
            pq = val.get("per_query", {})
            for qname in sorted(pq):
                if _is_hist_snap(pq[qname]):
                    hist(
                        f"{prefix}_latency_query_seconds", pq[qname],
                        {"query": qname},
                    )
            slo = val.get("slo")
            if isinstance(slo, dict):
                scalar(f"{prefix}_slo_burn", slo.get("burn_rate"))
                scalar(f"{prefix}_slo_target", slo.get("target"))
                scalar(
                    f"{prefix}_slo_threshold_seconds", slo.get("threshold_s")
                )
            scalar(f"{prefix}_latency_batches_total", val.get("batches"))
            scalar(f"{prefix}_latency_records_total", val.get("records"))
            scalar(
                f"{prefix}_latency_deferred_batches",
                val.get("deferred_batches"),
            )
        elif key == "layers" and isinstance(val, dict):
            # The port's child spans inside the batch phases and the work
            # counts at their boundaries (utils/metrics.py: LAYER_SPANS,
            # LAYER_COUNTERS).
            spans = val.get("spans", {})
            for span in sorted(spans):
                if _is_hist_snap(spans[span]):
                    hist(f"{prefix}_layer_span_seconds", spans[span], {"span": span})
            counts = val.get("counters", {})
            for cname in sorted(counts):
                suffix = "" if cname in LAYER_LEVELS else "_total"
                scalar(f"{prefix}_layer_{_sanitize(cname)}{suffix}", counts[cname])
        elif key == "hbm" and isinstance(val, dict):
            for stat in sorted(val):
                scalar(f"{prefix}_hbm_{_sanitize(stat)}", val[stat])
        elif _is_hist_snap(val):
            hist(name, val, {})
        elif isinstance(val, dict):
            for sub in sorted(val):
                v = val[sub]
                if isinstance(v, (int, float)):
                    scalar(f"{name}_{_sanitize(sub)}", v)
        else:
            scalar(name, val)
    return "\n".join(lines) + "\n"


# -- the Reporter -------------------------------------------------------------

class Reporter:
    """Cadence-driven snapshot flusher — the JMX-reporter analog.

    ``snapshot_fn`` is any zero-arg callable returning a metrics dict
    (``CEPProcessor.metrics_snapshot`` / ``Supervisor.metrics_snapshot``).
    Call :meth:`tick` once per processed batch: every ``every_batches``
    ticks (and/or whenever ``interval_s`` wall seconds elapsed) the
    snapshot is emitted to ``sink`` as a ``{"type": "metrics"}`` JSONL
    record and, when ``prometheus_path`` is set, rendered to that file
    atomically (write-tmp-then-replace, scrape-safe).
    """

    def __init__(
        self,
        snapshot_fn: Callable[[], Dict[str, Any]],
        sink: Optional[TraceSink] = None,
        every_batches: int = 16,
        interval_s: Optional[float] = None,
        prometheus_path: Optional[str] = None,
        prefix: str = "cep",
    ):
        self.snapshot_fn = snapshot_fn
        self.sink = sink
        self.every_batches = max(int(every_batches), 1)
        self.interval_s = interval_s
        self.prometheus_path = prometheus_path
        self.prefix = prefix
        self.ticks = 0
        self.flushes = 0
        self._last_flush = time.perf_counter()

    def tick(self) -> Optional[Dict[str, Any]]:
        """One batch processed; flush if the cadence says so.  Returns the
        snapshot when a flush happened, else None."""
        self.ticks += 1
        due = self.ticks % self.every_batches == 0
        if not due and self.interval_s is not None:
            due = time.perf_counter() - self._last_flush >= self.interval_s
        return self.flush() if due else None

    def flush(self) -> Dict[str, Any]:
        """Snapshot and emit unconditionally.

        The JSONL record is serialized *before* anything is written and
        lands through the sink's single-write append — a crash anywhere
        in this method leaves either the complete record or nothing,
        exactly like the ``.prom`` write's tmp-then-replace.  The
        ``report.write`` failpoint sits in the serialized-but-unwritten
        window (armed by the torn-line test in tests/test_telemetry.py).
        """
        from kafkastreams_cep_tpu_torch.utils.failpoints import fire as _failpoint

        snap = self.snapshot_fn()
        self.flushes += 1
        self._last_flush = time.perf_counter()
        if self.sink is not None:
            record = {
                "type": "metrics",
                "ts_ms": round(time.time() * 1000.0, 3),
                "tick": self.ticks,
                "snapshot": snap,
            }
            json.dumps(record, default=str)  # serialization failures fire here
            # Fault site: the record exists only in memory; a crash here
            # must leave the JSONL stream without any partial line.
            _failpoint("report.write")
            self.sink.emit(record)
        if self.prometheus_path is not None:
            tmp = self.prometheus_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(render_prometheus(snap, self.prefix))
            os.replace(tmp, self.prometheus_path)
        return snap
