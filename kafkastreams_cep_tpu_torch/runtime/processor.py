"""The stream processor: micro-batched host-to-device record pump.

Reference: ``CEPProcessor.java:88-163``, which steps one NFA per record and
forwards matches.  Here a micro-batch of records is grouped by key into
device lanes (the partition analog), padded to a rectangular ``[K, T]``
batch, scanned step by step on the device, and the completed matches are
decoded and emitted in exact arrival order — the order the reference would
have forwarded them.

Each key owns one lane's run queue, slab and fold state for the
processor's lifetime (``CEPProcessor.java:117-134``); checkpoints
externalize those tensors (``runtime/checkpoint.py``).

Time is int32 on the device.  Epoch-millisecond timestamps do not fit, so
the processor subtracts a fixed ``epoch`` (default: the first record's
timestamp) from every record; windows compare time differences, which
rebasing preserves exactly.  Predicates therefore see rebased timestamps —
pass ``epoch=0`` if a predicate matches on absolute time.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Hashable, List, NamedTuple, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from kafkastreams_cep_tpu_torch import native
from kafkastreams_cep_tpu_torch.convert import state_arrays, state_from_arrays, to_numpy
from kafkastreams_cep_tpu_torch.engine.matcher import (
    OFFSET_LIMIT,
    TIER_COUNTER_NAMES,
    EngineConfig,
    EventBatch,
)
from kafkastreams_cep_tpu_torch.engine.tiered import engine_view
from kafkastreams_cep_tpu_torch.ops.decode import compact_drained, compact_matches
from kafkastreams_cep_tpu_torch.parallel.batch import BatchMatcher
from kafkastreams_cep_tpu_torch.parallel.sharding import ShardedMatcher
from kafkastreams_cep_tpu_torch.parallel.tiered import TieredBatchMatcher
from kafkastreams_cep_tpu_torch.runtime.ingest import (
    REASON_LANE_OVERFLOW,
    REASON_LATE,
    REASON_OVERLOAD_SHED,
    REASON_SCHEMA,
    REASON_TIME_RANGE,
    Defect,
    IngestGuard,
    IngestPolicy,
)
from kafkastreams_cep_tpu_torch.runtime.overload import shed_keep
from kafkastreams_cep_tpu_torch.utils import tracecache
from kafkastreams_cep_tpu_torch.utils.events import Event, Sequence
from kafkastreams_cep_tpu_torch.utils.latency import LatencyLedger
from kafkastreams_cep_tpu_torch.utils.logging import get_logger
from kafkastreams_cep_tpu_torch.utils.failpoints import fire as _failpoint
from kafkastreams_cep_tpu_torch.utils.metrics import Metrics, device_memory_stats
from kafkastreams_cep_tpu_torch.utils.telemetry import TraceSink, maybe_span

logger = get_logger("runtime")

_I32 = np.iinfo(np.int32)


class InputRejected(ValueError):
    """A batch refused by validation, before any lane bookkeeping or device
    state changed (batch validation is atomic)."""


class Record(NamedTuple):
    """One input record, the host analog of a Kafka ``(key, value, ts)``.

    ``offset`` is the record's log position within its key's lane: pass the
    source offset to enable replay dedup, or leave ``None`` for
    auto-assignment."""

    key: Hashable
    value: Any
    timestamp: int
    offset: Optional[int] = None


def _bucket(t: int) -> int:
    """Round a batch length up to the next power of two, so step shapes
    repeat across batches."""
    n = 1
    while n < t:
        n *= 2
    return n


def tree_flatten(value) -> Tuple[list, Any]:
    """An event value's leaves and structure (dict keys sorted, like the
    JAX package's pytrees, so schemas and checkpoints agree)."""
    if isinstance(value, dict):
        keys = sorted(value)
        leaves, defs = _flatten_items([value[k] for k in keys])
        return leaves, ("dict", tuple(keys), defs)
    if isinstance(value, (list, tuple)):
        leaves, defs = _flatten_items(value)
        return leaves, (type(value).__name__, len(value), defs)
    return [value], None


def _flatten_items(items) -> Tuple[list, tuple]:
    """``tree_flatten`` of each item, concatenated: ``(leaves, defs)``
    (a leaf, the common case of a record's value, without a call)."""
    leaves, defs = [], []
    for v in items:
        if isinstance(v, (dict, list, tuple)):
            sub, d = tree_flatten(v)
            leaves += sub
            defs.append(d)
        else:
            leaves.append(v)
            defs.append(None)
    return leaves, tuple(defs)


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, subs = d
        if kind == "dict":
            return {k: build(s) for k, s in zip(keys, subs)}
        items = [build(s) for s in subs]
        return tuple(items) if kind == "tuple" else items

    return build(treedef)


def _is_float(leaf) -> bool:
    """Whether a value leaf is a float as numpy types it (``int`` and
    ``float`` leaves, the common case, without an array)."""
    t = type(leaf)
    if t is int or t is bool:
        return False
    if t is float:
        return True
    return bool(np.issubdtype(np.asarray(leaf).dtype, np.floating))


def _schema_dtype(leaf) -> np.dtype:
    if np.issubdtype(np.asarray(leaf).dtype, np.floating):
        return np.dtype(np.float32)
    return np.dtype(np.int32)


def treedef_str(treedef) -> str:
    """A value structure as the JAX package prints its pytree definitions
    (``PyTreeDef({'price': *, 'volume': *})``), so dead-letter details read
    the same in both packages."""
    def render(d):
        if d is None:
            return "*"
        kind, keys, subs = d
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {render(s)}" for k, s in zip(keys, subs)) + "}"
        items = [render(s) for s in subs]
        if kind == "tuple":
            return "(" + ", ".join(items) + ("," if len(items) == 1 else "") + ")"
        return "[" + ", ".join(items) + "]"

    return f"PyTreeDef({render(treedef)})"


class CEPProcessor:
    """Micro-batching processor: records in, :class:`Sequence` matches out.

    ``num_lanes`` bounds the number of distinct keys; a new key claims a
    free lane and keeps it.  Values share one numeric pytree structure
    (scalars or nested dicts of scalars); the first record fixes the
    schema, and a later float in an int field is rejected.  Predicates
    receive the key as a number: an int32-range integer key as itself, any
    other key as its lane index.

    **Replay dedup.**  Each lane keeps a high-water mark of explicit
    offsets; a record below it is dropped (``metrics.duplicates_dropped``).
    ``dedup=False`` keeps the reference's replay behaviour.

    ``process(records)`` returns ``(key, Sequence)`` pairs in the order the
    reference's per-record loop would forward them
    (``CEPProcessor.java:154-163``): by arrival of the completing record,
    then run-queue order.  With ``pipeline=True`` it returns the previous
    batch's matches (the device works on batch N while the host decodes
    N-1); ``flush()`` drains the last one.

    **Lazy extraction** (``EngineConfig.lazy_extraction``): completed
    matches wait on the device as handles until the batched drain pass
    walks them, every ``drain_interval`` batches (1 = each batch's matches
    leave with it); ``flush()`` drains whatever is still pending.  The
    emission order is the eager engine's.

    **Tiering** (``EngineConfig.tiering``): the engine is a
    :class:`~kafkastreams_cep_tpu_torch.parallel.tiered.TieredBatchMatcher`,
    which screens each batch with the query's strict prefix first; the
    emitted stream is the untiered one.  ``profile`` (a measured
    ``per_stage`` snapshot) orders its conjuncts; it is ignored untiered.

    **Columnar ingestion** (:meth:`process_columns`): ``[N]`` key, value and
    timestamp arrays instead of :class:`Record` objects, validated and
    packed with array ops (the native packer, ``native/``); events stay
    packed ``[K, T]`` columns until a decode or the event GC touches them.

    **Ingestion guard** (``ingest=IngestPolicy(...)``, ``runtime/ingest.py``):
    records are validated one by one (defects dead-lettered with a typed
    reason, or raised under ``on_bad_record="raise"``), held in a reorder
    buffer until the watermark passes them, and released to the engine in
    timestamp order; :meth:`drain_ingest` releases the rest at the end of
    a stream.  ``clock`` (default ``time.time``) stamps the guard's admits
    and the event-time-lag gauge; ``name`` labels the processor in
    ``per_pattern`` and in dead-letter correlation ids.

    **Latency ledger** (``latency=True`` or a ``utils/latency.py:
    LatencyLedger``): every batch is stamped at release, dispatch, device
    completion and emit on ``clock``, and the deltas fold into per-segment
    histograms (``metrics_snapshot()["latency"]``) that ride checkpoints.

    ``device`` is where the engine runs: ``"cuda"`` by default (raises when
    there is no GPU), ``"cpu"`` for the plain PyTorch path.

    **Mesh** (``mesh=key_mesh(...)``, ``parallel/sharding.py``): the lane
    axis splits into contiguous blocks, one a mesh device, each stepped by
    its own shard of a :class:`~kafkastreams_cep_tpu_torch.parallel.sharding.
    ShardedMatcher` (the mesh names the devices; ``device`` is then
    unused).  Every lane's state lives on one shard for the processor's
    lifetime (``CEPProcessor.java:117-134``); checkpoints gather it to host
    arrays in logical lane order, so a restore may place it onto another
    mesh.  A mesh refuses tiering, as in the JAX package.
    """

    def __init__(
        self,
        pattern,
        num_lanes: int,
        config: Optional[EngineConfig] = None,
        topic: str = "stream",
        epoch: Optional[int] = None,
        gc_events: bool = True,
        dedup: bool = True,
        gc_interval: int = 16,
        gc_events_interval: int = 8,
        decode_budget: int = 131072,
        pipeline: bool = False,
        drain_interval: int = 1,
        profile=None,
        name: Optional[str] = None,
        ingest: Optional[IngestPolicy] = None,
        clock=None,
        device="cuda",
        trace_sink: Optional[TraceSink] = None,
        flight=None,
        mesh=None,
        latency=None,
    ):
        self.mesh = mesh
        if mesh is not None:
            if config is not None and config.tiering:
                # The tiered matcher's per-batch host gate is single-device;
                # refusing beats restoring a tiered checkpoint into an
                # untiered shape.
                raise ValueError(
                    "EngineConfig.tiering is single-chip: construct the "
                    "processor without a mesh (or without tiering)"
                )
            self.batch = ShardedMatcher(pattern, num_lanes, mesh, config)
        elif config is not None and config.tiering:
            self.batch = TieredBatchMatcher(pattern, num_lanes, config,
                                            profile=profile, device=device)
        else:
            self.batch = BatchMatcher(pattern, num_lanes, config, device)
        self.device = self.batch.device
        self.topic = topic
        self.num_lanes = int(num_lanes)
        # Maintenance sweep every N batches (0 = off): frees slab entries
        # no future walk can reach and renormalizes Dewey versions.
        self.gc_interval = int(gc_interval)
        # Host-event GC cadence, in batches.
        self.gc_events_interval = max(int(gc_events_interval), 1)
        # Compacted match rows the decode pulls per batch (0 = always pull
        # the raw [K, T, R, W] grid); more matches fall back to the full
        # pull, counted in ``metrics.decode_fallbacks``.
        self.decode_budget = int(decode_budget)
        self.pipeline = bool(pipeline)
        self._pending: Optional[tuple] = None
        # (start, end) CUDA timing events of the batches whose card time is
        # not yet read (_read_card_times).
        self._card_times: List[tuple] = []
        self.lazy = bool(self.batch.matcher.config.lazy_extraction)
        self.drain_interval = max(int(drain_interval), 1)
        self.state = self.batch.init_state()
        # Steps scanned so far; restored from ``step_seq`` on resume.
        self._step_base = 0
        self.epoch = epoch
        self.gc_events = gc_events
        self.dedup = dedup
        self._lane_of: Dict[Hashable, int] = {}
        self._key_of: Dict[int, Hashable] = {}
        self._next_offset = np.zeros(self.num_lanes, dtype=np.int64)
        # Per-lane offset base: the engine sees offsets rebased to log
        # positions (< 2^24); the first record of a lane fixes its base.
        self._off_base = np.full(self.num_lanes, -1, dtype=np.int64)
        # Host event mirror, keyed by device (rebased) offset per lane.
        self._events: List[Dict[int, Event]] = [dict() for _ in range(self.num_lanes)]
        # Columnar batches (process_columns) whose events are not yet
        # materialized: (start [K], count [K], abs_ts [K, T], value leaves).
        self._col_batches: List[tuple] = []
        self._value_proto = None
        self.metrics = Metrics()
        self.name = name or topic
        self._batch_seq = 0
        # Event-time watermark: the largest record timestamp ingested
        # (absolute ms), for the watermark and event-time-lag gauges.
        self._watermark: Optional[int] = None
        self._clock = clock if clock is not None else time.time
        # Latency-attribution ledger (utils/latency.py): ``True`` builds one
        # on this processor's clock, a ledger is adopted as it is (a
        # supervisor's restore, bank members sharing one), None or False
        # leaves it off: one ``None`` check a call site, no device work.
        if latency is True:
            self.ledger: Optional[LatencyLedger] = LatencyLedger(clock=self._clock)
        else:
            self.ledger = latency or None
        self._guard = IngestGuard(ingest, clock=self._clock) if ingest is not None else None
        # Telemetry (utils/telemetry.py): an optional span sink; every batch
        # emits one "batch" span with nested phase spans (pack, dispatch,
        # drain, device, decode, gc).  None costs one check a phase.
        self.trace = trace_sink
        # Flight recorder (runtime/flight.py): a bounded ring of per-batch
        # records, appended at the end of every batch and dumped as JSONL on
        # a crash, recovery, escalation or quarantine burst.  None costs one
        # check a batch.
        self.flight = flight
        self._dlq_base = 0  # dead-letter total at the last batch (burst detection)
        # Brownout actuators, set by the supervisor's OverloadController
        # (runtime/overload.py), never by callers: ``overload_admit_fraction``
        # None is the open door, else the fraction of admissible records the
        # ingest door keeps (a deterministic within-batch stride; 0.0 at L4
        # refuses all); ``telemetry_defer`` skips the per-lane and per-key
        # device gathers of metrics_snapshot while browned out.
        self.overload_admit_fraction: Optional[float] = None
        self.telemetry_defer = False

    def set_clock(self, clock) -> None:
        """Re-inject the host clock wherever it is read (the lag gauge, the
        guard's admit stamps and the latency ledger's stamps).  Clocks are
        not durable state: a restored processor runs on ``time.time`` until
        one is set."""
        self._clock = clock
        if self._guard is not None:
            self._guard._clock = clock
        if self.ledger is not None:
            self.ledger.clock = clock

    def place(self, state):
        """A host tree of this processor's engine state in logical lane
        order (what ``runtime/migrate.py`` returns) as tensors on its
        device, or on its mesh's shards, every leaf checked against the
        engine's shape and dtype."""
        return self.place_arrays(state_arrays(state))

    def place_arrays(self, arrays: Dict[str, np.ndarray]):
        """:meth:`place` of ``state_arrays`` output (a checkpoint's
        arrays)."""
        if self.mesh is not None:
            return self.batch.place_arrays(arrays, like=self.state)
        return state_from_arrays(arrays, self.state)

    def host_state(self):
        """The engine state as one host tree (numpy leaves) in logical lane
        order: a meshed processor's shards gathered
        (``ShardedMatcher.gather``), else the state's leaves pulled to the
        host.  Checkpoints and migrations read the state through it."""
        if self.mesh is not None:
            return self.batch.gather(self.state)
        return to_numpy(self.state)

    def engine_arrays(self, pick) -> Tuple[np.ndarray, ...]:
        """``pick(engine_state)``'s tensors as host arrays in logical lane
        order, without gathering the other leaves (a tiered state's engine
        half; a meshed processor's shards concatenated)."""
        if self.mesh is not None:
            return self.batch.gather_leaves(self.state, pick)
        return tuple(x.cpu().numpy() for x in pick(engine_view(self.state)))

    def lane_shards(self) -> Optional[List[int]]:
        """The live lane-to-shard assignment (contiguous blocks over the
        mesh), or None unmeshed; checkpoint headers record it."""
        if self.mesh is None:
            return None
        per = self.num_lanes // self.mesh.size
        return [k // per for k in range(self.num_lanes)]

    def _synchronize(self) -> None:
        """Wait for the engine's CUDA work: its device, or every distinct
        card of its mesh."""
        devs = [self.device] if self.mesh is None else self.mesh.devices
        for d in dict.fromkeys(d for d in devs if d.type == "cuda"):
            torch.cuda.synchronize(d)

    @property
    def uses_scan_kernel(self) -> bool:
        """Whether scans run the whole-scan kernel (``CEP_SCAN_KERNEL``;
        False again once a pattern fell back to the per-step path)."""
        return self.batch.uses_scan_kernel

    # -- key -> lane assignment (partition-assignment analog) ---------------

    def lane(self, key: Hashable) -> int:
        """The lane of ``key``, assigning the next free one to a new key."""
        existing = self._lane_of.get(key)
        if existing is not None:
            return existing
        lane = len(self._lane_of)
        if lane >= self.num_lanes:
            raise InputRejected(
                f"key {key!r}: more than num_lanes={self.num_lanes} distinct "
                "keys; size the processor for the key cardinality it serves"
            )
        self._lane_of[key] = lane
        self._key_of[lane] = key
        logger.info("assigned key %r to lane %d", key, lane)
        return lane

    def _key_code(self, key: Hashable, lane: int) -> int:
        if isinstance(key, (int, np.integer)) and _I32.min <= key <= _I32.max:
            return int(key)
        return lane

    def _rebased_ts(self, timestamp: int, rank: int, key) -> int:
        rel = int(timestamp) - self.epoch
        if not (_I32.min <= rel <= _I32.max):
            raise InputRejected(
                f"record {rank} (key {key!r}): timestamp {timestamp} is {rel} "
                f"ms from the processor epoch {self.epoch}, outside int32 "
                "device time (~±24.8 days); construct the processor with an "
                "epoch near your stream's timestamps"
            )
        return rel

    # -- the per-batch hot path --------------------------------------------

    @contextlib.contextmanager
    def _traced(self, label: str, **attrs):
        """A nested trace span named ``label`` and, while a profiler runs, a
        ``record_function`` range of the same name, which puts it on the
        profiler's timeline beside the card's work (the span's ``ts_ms``
        and the trace's ``baseTimeNanoseconds + ts`` are both Unix time).
        Yields the span's attribute dict."""
        rng = (torch.profiler.record_function(label) if torch.autograd._profiler_enabled()
               else contextlib.nullcontext())
        with rng, maybe_span(self.trace, label, **attrs) as sp:
            yield sp

    @contextlib.contextmanager
    def _phase(self, name: str):
        """One batch phase: a nested trace span and profiler range
        ``phase.{name}``, the ``{name}_seconds`` accumulator and the
        ``phases[name]`` latency histogram."""
        with self._traced(f"phase.{name}"), self.metrics.timed(f"{name}_seconds"):
            yield

    @contextlib.contextmanager
    def _layer(self, name: str):
        """A child span inside a phase (``utils/metrics.py: LAYER_SPANS``):
        a nested trace span and profiler range ``name`` and the
        ``layers["spans"][name]`` latency histogram."""
        with self._traced(name), self.metrics.timed_span(name):
            yield

    def process(self, records: Seq[Record]) -> List[Tuple[Hashable, Sequence]]:
        if not records:
            return []
        self._batch_seq += 1
        with self._traced("batch", path="records", batch=self._batch_seq,
                          records=len(records)) as sp:
            # The ledger's release stamp: batch entry (the guard releases
            # mid-pack, so validation counts as queue time).
            lat_t0 = self._clock() if self.ledger is not None else None
            with self._phase("pack"):
                if self._guard is not None:
                    released = self._ingest(list(records), f"{self.name}-{self._batch_seq}")
                    sp["released"] = len(released)
                    packed = self._pack_records(released) if released else None
                else:
                    packed = self._pack_records(records)
            if packed is None:
                # Nothing released this batch: still a flight tick (a
                # quarantine burst can empty a batch).
                self._flight_tick()
                return []
            sp["lanes"] = len(self._lane_of)
            lat = self._lat_start(packed[2], lat_t0)
            matches = self._dispatch(*packed, lat)
            sp["matches"] = len(matches)
            return matches

    def _lat_start(self, n: int, release):
        """A ledger bundle for a batch of ``n`` released records (None
        without a ledger); the guard's admit stamps ride along."""
        if self.ledger is None:
            return None
        return self.ledger.start_batch(
            f"{self.name}-{self._batch_seq}", n,
            admit=self._guard.last_release_stamps if self._guard is not None else None,
            release=release,
        )

    # -- the ingestion guard (runtime/ingest.py) ---------------------------

    def _ingest(self, records: List[Record], corr: str) -> List[Record]:
        """Admit one raw batch through the guard; returns the released
        (watermark-passed, timestamp-ordered) records with their offsets
        reset to auto: release order is the engine's log order, and the
        source offsets already did their job (dedup at admission).  While
        the brownout door is throttled (``overload_admit_fraction``), the
        admissible records the stride drops are dead-lettered as
        ``overload_shed``."""
        guard = self._guard
        # Fault site: before any guard or lane bookkeeping changes, so the
        # batch is refused whole, nothing half-admitted.
        _failpoint("ingest.admit")
        strict = guard.policy.on_bad_record == "raise"
        admit_frac = self.overload_admit_fraction
        n_admissible = 0
        for idx, rec in enumerate(records):
            defect = self._record_defect(rec)
            if defect is None:
                # The brownout shed (L3+) comes after validation and replay
                # dedup (a re-submitted shed record dedups silently), and
                # its stride counts admissible records only, so a replayed
                # batch sheds the same records.
                keep = admit_frac is None or shed_keep(n_admissible, admit_frac)
                n_admissible += 1
                if not keep:
                    # Fault site: the shed is decided but not recorded; the
                    # recovery replays the batch and sheds the same records.
                    _failpoint("overload.shed")
                    guard.quarantine(rec, REASON_OVERLOAD_SHED,
                                     f"brownout admit fraction {admit_frac}", corr)
                    # Its event time still counts: the watermark advances and
                    # the held backlog drains while the door is shut.
                    guard.observe_time(rec.timestamp)
                    continue
                guard.push(rec)
            elif defect.silent:
                self.metrics.duplicates_dropped += 1
            elif strict:
                raise InputRejected(
                    f"record {idx} (key {rec.key!r}): {defect.reason}: {defect.detail}"
                )
            else:
                guard.quarantine(rec, defect.reason, defect.detail, corr)
        released = guard.release()
        # Fault site: the buffer moved (records admitted, releases popped)
        # but the engine never saw them; recovery restores the buffer from
        # the snapshot and re-admits from the journal.
        _failpoint("ingest.release")
        return [r._replace(offset=None) if r.offset is not None else r for r in released]

    def _record_defect(self, rec: Record) -> Optional[Defect]:
        """Validate one record against the schema, lane and time contracts
        the batch path enforces atomically; commits the schema, the epoch
        and the key's lane on first sight (the guard admits per record, so
        there is no batch to reject).  None when admissible."""
        guard = self._guard
        if self._value_proto is None:
            leaves0, treedef0 = tree_flatten(rec.value)
            self._value_proto = tree_unflatten(treedef0, [_schema_dtype(l) for l in leaves0])
        dtypes, treedef = tree_flatten(self._value_proto)
        leaves, rec_def = tree_flatten(rec.value)
        if rec_def != treedef:
            return Defect(
                REASON_SCHEMA,
                f"value structure {treedef_str(rec_def)} differs from the schema "
                f"{treedef_str(treedef)} fixed by the first record",
            )
        for field_i, (leaf, dt) in enumerate(zip(leaves, dtypes)):
            if not np.issubdtype(dt, np.floating) and _is_float(leaf):
                return Defect(
                    REASON_SCHEMA,
                    f"field #{field_i}: float value {leaf!r} in a field the "
                    "schema (fixed by the first record) typed as int",
                )
        lane = self._lane_of.get(rec.key)
        if lane is None:
            if len(self._lane_of) >= self.num_lanes:
                return Defect(
                    REASON_LANE_OVERFLOW,
                    f"key {rec.key!r} would exceed num_lanes={self.num_lanes}; "
                    "size the processor for the key cardinality it serves",
                )
            lane = self.lane(rec.key)
        if self.epoch is None:
            self.epoch = int(rec.timestamp)
        rel = int(rec.timestamp) - self.epoch
        if not (_I32.min <= rel <= _I32.max):
            return Defect(
                REASON_TIME_RANGE,
                f"timestamp {rec.timestamp} is {rel} ms from the processor "
                f"epoch {self.epoch}, outside int32 device time (~±24.8 days)",
            )
        if rec.offset is not None:
            hw = guard.source_hw.get(lane, 0)
            if self.dedup and rec.offset < hw:
                return Defect("duplicate", "", silent=True)
            guard.source_hw[lane] = max(hw, int(rec.offset) + 1)
        behind = guard.late_by(int(rec.timestamp))
        if behind is not None:
            return Defect(
                REASON_LATE,
                f"timestamp {rec.timestamp} is {behind} ms behind the watermark "
                f"{guard.watermark} (grace {guard.policy.grace_ms} ms)",
            )
        return None

    def drain_ingest(self) -> List[Tuple[Hashable, Sequence]]:
        """End of stream: release every record the guard holds, watermark
        regardless, and run them through the engine.  A no-op without a
        guard or with an empty buffer; call :meth:`flush` afterwards for
        pipelined or lazy processors."""
        if self._guard is None:
            return []
        lat_t0 = self._clock() if self.ledger is not None else None
        released = self._guard.drain()
        if not released:
            return []
        released = [r._replace(offset=None) if r.offset is not None else r
                    for r in released]
        self._batch_seq += 1
        with self._traced("batch", path="ingest-drain", batch=self._batch_seq,
                          records=len(released)) as sp:
            with self._phase("pack"):
                packed = self._pack_records(released)
            if packed is None:
                return []
            matches = self._dispatch(*packed, self._lat_start(packed[2], lat_t0))
            sp["matches"] = len(matches)
            return matches

    def _pack_records(self, records: Seq[Record]):
        """Validate, lane-assign and pad one record batch to ``[K, T]``
        device columns; None when every record was a replay duplicate."""
        K = self.num_lanes
        if self.epoch is None:
            self.epoch = int(records[0].timestamp)
        if self._value_proto is None:
            leaves0, treedef0 = tree_flatten(records[0].value)
            self._value_proto = tree_unflatten(
                treedef0, [_schema_dtype(l) for l in leaves0]
            )
        dtypes, treedef = tree_flatten(self._value_proto)

        # Validate the whole batch before any bookkeeping moves: lane
        # assignment and offsets are simulated, then committed.
        lane_sim = dict(self._lane_of)
        lanes = []
        for rank, rec in enumerate(records):
            lane = lane_sim.get(rec.key)
            if lane is None:
                lane = len(lane_sim)
                if lane >= K:
                    raise InputRejected(
                        f"record {rank} (key {rec.key!r}): more than "
                        f"num_lanes={K} distinct keys; size the processor "
                        "for the key cardinality it serves"
                    )
                lane_sim[rec.key] = lane
            lanes.append(lane)
        rel_ts = [
            self._rebased_ts(rec.timestamp, rank, rec.key)
            for rank, rec in enumerate(records)
        ]
        next_sim = self._next_offset.copy()
        base_sim = self._off_base.copy()
        offsets: List[Optional[int]] = []
        batch_leaves = []
        int_fields = [i for i, dt in enumerate(dtypes) if not np.issubdtype(dt, np.floating)]
        for rank, rec in enumerate(records):
            leaves, rec_def = tree_flatten(rec.value)
            if rec_def != treedef:
                raise InputRejected(
                    f"record {rank} (key {rec.key!r}): value structure "
                    "differs from the schema fixed by the first record"
                )
            for field_i in int_fields:
                leaf = leaves[field_i]
                if _is_float(leaf):
                    raise InputRejected(
                        f"record {rank} (key {rec.key!r}): field #{field_i} "
                        f"float value {leaf!r} in a field the schema (fixed "
                        "by the first record) typed as int"
                    )
            batch_leaves.append(leaves)
            lane = lanes[rank]
            off = rec.offset if rec.offset is not None else int(next_sim[lane])
            if self.dedup and off < next_sim[lane]:
                offsets.append(None)  # duplicate: below the high-water mark
                continue
            if base_sim[lane] < 0:
                base_sim[lane] = off  # the first record fixes the lane base
            dev = off - int(base_sim[lane])
            if dev < 0:
                raise InputRejected(
                    f"record {rank} (key {rec.key!r}): offset {off} is below "
                    f"lane {lane}'s base {int(base_sim[lane])} (out-of-order "
                    "replay below the first seen offset needs dedup=True)"
                )
            if dev >= OFFSET_LIMIT:
                raise InputRejected(
                    f"record {rank} (key {rec.key!r}): offset {off} is {dev} "
                    f"past lane {lane}'s base — per-lane log positions must "
                    "stay below 2^24"
                )
            offsets.append(off)
            next_sim[lane] = max(next_sim[lane], off + 1)

        for key in lane_sim:  # in simulated order: each takes its simulated lane
            self.lane(key)

        # Host-event mirror: events keep their source offsets, keyed by
        # device offset.
        self._off_base = base_sim
        # The simulated high-water marks are the kept records' maxima.
        self._next_offset[:] = next_sim
        base = base_sim.tolist()
        dropped = 0
        for rank, rec in enumerate(records):
            off = offsets[rank]
            if off is None:
                dropped += 1
                continue
            lane = lanes[rank]
            event = Event(rec.key, rec.value, int(rec.timestamp), self.topic, lane, off)
            self._events[lane][off - base[lane]] = event
        self.metrics.duplicates_dropped += dropped
        if dropped:
            logger.info("dropped %d replayed records (high-water mark)", dropped)
        wm = max(int(rec.timestamp) for rec in records)
        self._watermark = wm if self._watermark is None else max(self._watermark, wm)
        if all(off is None for off in offsets):
            return None

        n = len(records)
        lanes_arr = np.asarray(lanes, dtype=np.int32)
        keep = np.fromiter((o is not None for o in offsets), dtype=np.uint8, count=n)
        pos, _qlen, max_len = native.queue_positions(lanes_arr, keep, K)
        T = _bucket(max_len)
        key_col = np.fromiter(
            (self._key_code(rec.key, lanes[r]) for r, rec in enumerate(records)),
            dtype=np.int32, count=n,
        )
        off_col = np.fromiter(
            (
                o - base[lanes[r]] if o is not None else 0
                for r, o in enumerate(offsets)
            ),
            dtype=np.int32, count=n,
        )
        # Padding slots carry valid=False and leave lane state untouched.
        key_arr = np.zeros((K, T), dtype=np.int32)
        ts = np.zeros((K, T), dtype=np.int32)
        off = np.zeros((K, T), dtype=np.int32)
        valid = np.zeros((K, T), dtype=bool)
        rank_of = np.full((K, T), -1, dtype=np.int64)
        native.pack_column(key_arr, key_col, lanes_arr, pos, keep)
        native.pack_column(ts, np.asarray(rel_ts, dtype=np.int32), lanes_arr, pos, keep)
        native.pack_column(off, off_col, lanes_arr, pos, keep)
        native.pack_column(rank_of, np.arange(n, dtype=np.int64), lanes_arr, pos, keep)
        native.pack_valid(valid, lanes_arr, pos, keep)
        val_leaves = []
        for i, dt in enumerate(dtypes):
            col = np.zeros((K, T), dtype=dt)
            native.pack_column(col, np.asarray([lv[i] for lv in batch_leaves], dtype=dt),
                               lanes_arr, pos, keep)
            val_leaves.append(col)
        return self._device_batch(key_arr, val_leaves, treedef, ts, off, valid), rank_of, n - dropped

    def _device_batch(self, key_arr, val_leaves, treedef, ts, off, valid) -> EventBatch:
        """The packed ``[K, T]`` host columns as an ``EventBatch`` on the
        engine's device."""
        def dev(a):
            return torch.as_tensor(a, device=self.device)

        with self._layer("pack.copy"):
            return EventBatch(
                key=dev(key_arr),
                value=tree_unflatten(treedef, [dev(v) for v in val_leaves]),
                ts=dev(ts),
                off=dev(off),
                valid=dev(valid),
            )

    def process_columns(self, keys, values, timestamps) -> List[Tuple[Hashable, Sequence]]:
        """Columnar ingestion: ``[N]`` arrays instead of :class:`Record`
        objects.

        :meth:`process` spends microseconds of Python a record (validation,
        Event construction); this path validates and packs with array ops
        and builds an Event only when a match (or the event GC) touches it,
        so match-sparse streams never pay for it: the packed columns are
        the event mirror until then.

        ``keys`` is an ``[N]`` array (numeric keys vectorize; object keys
        take a Python mapping pass), ``values`` a tree of ``[N]`` arrays
        with the schema's structure, ``timestamps`` ``[N]`` ints.  Offsets
        are always auto-assigned (replay dedup needs the per-record path).
        Emitted Events carry values rebuilt from the packed columns in the
        schema's dtypes.  Refused when an ingestion guard is set."""
        if self._guard is not None:
            raise ValueError(
                "the ingestion guard runs on the per-record path only; "
                "process_columns bypasses per-record validation and the "
                "reorder buffer (construct the processor without ingest=... "
                "to use the columnar path)"
            )
        self._batch_seq += 1
        with self._traced("batch", path="columns", batch=self._batch_seq) as sp:
            lat_t0 = self._clock() if self.ledger is not None else None
            with self._phase("pack"):
                packed = self._pack_columns(keys, values, timestamps)
            if packed is None:
                return []
            sp["records"] = packed[2]
            sp["lanes"] = len(self._lane_of)
            matches = self._dispatch(*packed, self._lat_start(packed[2], lat_t0))
            sp["matches"] = len(matches)
            return matches

    def _pack_columns(self, keys, values, timestamps):
        keys_arr = np.asarray(keys)
        if keys_arr.ndim != 1:
            raise InputRejected(f"keys must be a 1-D column, got shape {keys_arr.shape}")
        ts_arr = np.asarray(timestamps, dtype=np.int64)
        n = int(keys_arr.shape[0])
        # One timestamp per record, checked before the native packer reads
        # n elements of every column.
        if ts_arr.shape != (n,):
            raise InputRejected(
                f"timestamps shape {ts_arr.shape} != ({n},); pass exactly one "
                "timestamp per record"
            )
        if n == 0:
            return None
        K = self.num_lanes
        if self.epoch is None:
            self.epoch = int(ts_arr[0])
        leaves_in, treedef_in = tree_flatten(values)
        leaves_in = [np.asarray(l) for l in leaves_in]
        if self._value_proto is None:
            self._value_proto = tree_unflatten(
                treedef_in, [_schema_dtype(l) for l in leaves_in])
        dtypes, treedef = tree_flatten(self._value_proto)
        if treedef_in != treedef:
            raise InputRejected(
                "value columns structure differs from the schema fixed by the "
                "first batch"
            )
        for field_i, (l, dt) in enumerate(zip(leaves_in, dtypes)):
            if l.shape != (n,):
                raise InputRejected(f"field #{field_i}: value column shape {l.shape} != ({n},)")
            if np.issubdtype(l.dtype, np.floating) and not np.issubdtype(dt, np.floating):
                raise InputRejected(
                    f"field #{field_i}: float column in a field the schema typed as int"
                )

        # Lane mapping, committed only after the overflow check.
        with self._layer("pack.lanes"):
            if keys_arr.dtype == object:
                uniq = list(dict.fromkeys(keys_arr.tolist()))
            else:
                vals, first = np.unique(keys_arr, return_index=True)
                uniq = [v.item() for v in vals[np.argsort(first)]]
            new = [k for k in uniq if k not in self._lane_of]
            if len(self._lane_of) + len(new) > K:
                raise InputRejected(
                    f"more than num_lanes={K} distinct keys (first overflowing key: "
                    f"{new[K - len(self._lane_of)]!r}); size the processor for the "
                    "key cardinality it serves"
                )
            for k in new:
                self.lane(k)
            if keys_arr.dtype == object:
                lanes_arr = np.fromiter((self._lane_of[k] for k in keys_arr.tolist()),
                                        dtype=np.int32, count=n)
            else:
                ku = np.fromiter(self._lane_of.keys(), dtype=keys_arr.dtype)
                lv = np.fromiter(self._lane_of.values(), dtype=np.int32)
                order = np.argsort(ku)
                lanes_arr = lv[order][np.searchsorted(ku[order], keys_arr)].astype(np.int32)

        rel = ts_arr - self.epoch
        if rel.min() < _I32.min or rel.max() > _I32.max:
            bad = int(np.argmax((rel < _I32.min) | (rel > _I32.max)))
            raise InputRejected(
                f"record {bad} (key {keys_arr[bad]!r}): timestamp {int(ts_arr[bad])} "
                f"outside int32 device time relative to the processor epoch {self.epoch}"
            )
        wm = int(ts_arr.max())
        self._watermark = wm if self._watermark is None else max(self._watermark, wm)

        with self._layer("pack.columns"):
            keep = np.ones(n, dtype=np.uint8)
            pos, qlen, max_len = native.queue_positions(lanes_arr, keep, K)
            # Auto offsets: a lane's rows take consecutive log positions from
            # its high-water mark; a fresh lane's base pins to it.
            fresh = (self._off_base < 0) & (qlen > 0)
            self._off_base[fresh] = self._next_offset[fresh]
            start_dev = self._next_offset - self._off_base  # [K] first device offset
            dev_off = (start_dev[lanes_arr] + pos).astype(np.int64)
            if dev_off.max() >= OFFSET_LIMIT:
                raise InputRejected(
                    "per-lane log positions past 2^24 (the slab's f32 pointer "
                    "packing); rotate the processor through checkpoint/restore"
                )
            self._next_offset += qlen

            T = _bucket(max_len)
            # Key codes as _key_code gives them on the record path: an int32
            # integer key passes through, anything else is its lane index.
            if np.issubdtype(keys_arr.dtype, np.integer):
                in_range = (keys_arr >= _I32.min) & (keys_arr <= _I32.max)
                key_codes = np.where(in_range, keys_arr.astype(np.int64),
                                     lanes_arr.astype(np.int64)).astype(np.int32)
            elif keys_arr.dtype == object:
                key_codes = np.fromiter(
                    (self._key_code(k, int(lanes_arr[i]))
                     for i, k in enumerate(keys_arr.tolist())),
                    dtype=np.int32, count=n,
                )
            else:
                key_codes = lanes_arr.astype(np.int32)
            key_arr = np.zeros((K, T), dtype=np.int32)
            ts = np.zeros((K, T), dtype=np.int32)
            off = np.zeros((K, T), dtype=np.int32)
            valid = np.zeros((K, T), dtype=bool)
            rank_of = np.full((K, T), -1, dtype=np.int64)
            abs_ts = np.zeros((K, T), dtype=np.int64)
            native.pack_column(key_arr, key_codes, lanes_arr, pos, keep)
            native.pack_column(ts, rel.astype(np.int32), lanes_arr, pos, keep)
            native.pack_column(off, dev_off.astype(np.int32), lanes_arr, pos, keep)
            native.pack_column(rank_of, np.arange(n, dtype=np.int64), lanes_arr, pos, keep)
            native.pack_column(abs_ts, ts_arr, lanes_arr, pos, keep)
            native.pack_valid(valid, lanes_arr, pos, keep)
            val_leaves = [np.zeros((K, T), dtype=dt) for dt in dtypes]
            for i, dt in enumerate(dtypes):
                native.pack_column(val_leaves[i], leaves_in[i].astype(dt), lanes_arr, pos, keep)

            # The packed columns are the event mirror until a match or the GC
            # touches a row.
            col_start = np.where(qlen > 0, start_dev, -1).astype(np.int64)
            self._col_batches.append((col_start, qlen.astype(np.int64), abs_ts, val_leaves))
        return self._device_batch(key_arr, val_leaves, treedef, ts, off, valid), rank_of, n

    def _dispatch(self, events, rank_of, n_records, lat=None):
        # Fault sites (utils/failpoints.py; no-ops unless armed):
        # ``device.dispatch`` fails before the scan, the state untouched;
        # ``device.result`` after the state advanced but before the batch's
        # matches reach the caller, the window the supervisor's restore and
        # replay must cover.
        _failpoint("device.dispatch")
        steps = int(events.ts.shape[1])
        if self.mesh is not None:
            # Shard fault site: the host-to-mesh transfer, where a dead
            # device first surfaces on the sharded path; the state is
            # untouched, so the supervisor's evacuation restores and
            # replays onto the surviving sub-mesh (arm it with ShardLost).
            _failpoint("shard.dispatch")
            events = self.batch.shard_events(events)
        base = self._step_base
        if lat is not None:
            lat.dispatch = self._clock()
        start = self._card_event()
        with self._phase("dispatch"):
            self.state, out = self.batch.scan(self.state, events)
            self._step_base += steps
            self.metrics.steps += steps
            if self.gc_interval and (self.metrics.batches + 1) % self.gc_interval == 0:
                # Pending handles are sweep roots (parallel/batch.py).
                with self._layer("dispatch.sweep"):
                    self.state = self.batch.sweep(self.state)
        drain_out = None
        if self.lazy and (self.metrics.batches + 1) % self.drain_interval == 0:
            with self._phase("drain"):
                self.state, drain_out = self.batch.drain(self.state)
        # On the card the device phase's seconds are the card's: from an event
        # before the batch's first launch to one after its last, read once a
        # wait has covered them (_read_card_times).  The end event is also
        # the ledger's: a pipelined batch takes its complete stamp there.
        done = None
        if start is not None:
            done = self._card_event()
            self._card_times.append((start, done))
        cuda = self.device.type == "cuda"
        with self._traced("phase.device") if done is not None else self._phase("device"):
            if not self.pipeline and cuda:
                with self._layer("device.wait"):
                    self._synchronize()
            elif lat is not None and cuda and done is None:
                # Pipelined on a mesh: the batch's outputs are waited for at
                # its decode, one call later; this event marks their end.
                done = torch.cuda.Event()
                done.record()
        if not self.pipeline:
            self._read_card_times()
            if lat is not None:
                # Serial mode just synchronized: the device is done.  A
                # pipelined batch takes its stamp at its decode (_decode).
                lat.complete = self._clock()
        _failpoint("device.result")
        gc_due = self.gc_events and (
            (self.metrics.batches + 1) % self.gc_events_interval == 0
        )
        self.metrics.records_in += n_records
        self.metrics.batches += 1
        with self._phase("decode"):
            if self.pipeline:
                prev, self._pending = (self._pending,
                                       (out, rank_of, drain_out, base, lat, done))
                matches = self._decode_pending(prev) if prev is not None else []
                if gc_due:
                    # The event GC must not prune events the pending
                    # decode still references: drain first.
                    pend, self._pending = self._pending, None
                    matches += self._decode_pending(pend)
            else:
                matches = self._decode(out, rank_of, drain_out, base)
                self._lat_finish(lat, (not self.lazy) or drain_out is not None)
        if gc_due:
            with self._phase("gc"):
                self._gc_events()
        self.metrics.matches_out += len(matches)
        self._flight_tick()
        return matches

    def _card_event(self) -> Optional[torch.cuda.Event]:
        """A timing event recorded on the engine's card (None off a card
        and on a mesh, whose device phase keeps the host's wall time)."""
        if self.mesh is not None or self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _read_card_times(self) -> None:
        """Add the card time of each batch whose end event has completed,
        oldest first, to ``device_seconds`` and ``phases["device"]``.
        Called after a wait, so the query never waits itself: a batch not
        yet waited for (lazy, no drain due) is read after a later one."""
        times = self._card_times
        while times and times[0][1].query():
            start, end = times.pop(0)
            self.metrics.observe("device_seconds", start.elapsed_time(end) * 1e-3)

    def _decode_pending(self, pend) -> List[Tuple[Hashable, Sequence]]:
        """Decode a pipelined batch ``(out, rank_of, drain_out, base, lat,
        done)``; its latency bundle commits or parks at the decode's end."""
        out, rank_of, drain_out, base, lat, done = pend
        matches = self._decode(out, rank_of, drain_out, base, lat, done)
        self._lat_finish(lat, (not self.lazy) or drain_out is not None)
        return matches

    def _lat_finish(self, lat, emitted: bool) -> None:
        """Commit or park one batch's latency bundle at its decode.

        ``emitted`` means the batch's matches just left the device (an
        eager decode, or a drain that carried its handles): the bundle,
        and every parked earlier bundle whose handles rode the same drain,
        commit at one emit stamp.  Otherwise (lazy, no drain due) it parks
        until the drain that emits it.  A bundle whose batch failed dies
        with the rollback and is re-observed on replay: exactly-once
        counts, honest wall clock."""
        if lat is None or self.ledger is None:
            return
        if emitted:
            emit = self._clock()
            self.ledger.commit_deferred(emit)
            self.ledger.commit(lat, emit)
        else:
            self.ledger.defer(lat)

    def _flight_tick(self) -> None:
        """Record this batch in the flight ring (runtime/flight.py), and
        dump it when the guard dead-lettered a burst's worth of records in
        one batch.  One ``None`` check without a recorder."""
        if self.flight is None:
            return
        corr = f"{self.name}-{self._batch_seq}"
        self.flight.observe(self, corr=corr)
        if self._guard is not None:
            total = int(sum(self._guard.reason_counts.values()))
            if total - self._dlq_base >= self.flight.quarantine_burst:
                self.flight.dump("quarantine_burst", corr=corr)
            self._dlq_base = total

    def flush(self) -> List[Tuple[Hashable, Sequence]]:
        """Decode the pipelined in-flight batch (a no-op in serial mode or
        when nothing is pending) and, under lazy extraction, drain the
        handles still pending on the device.  Call before checkpointing a
        pipelined processor."""
        matches: List[Tuple[Hashable, Sequence]] = []
        if self._pending is not None:
            pend, self._pending = self._pending, None
            with self._phase("decode"):
                matches = self._decode_pending(pend)
        if self.lazy:
            with self._phase("drain"):
                self.state, dout = self.batch.drain(self.state)
            with self._phase("decode"):
                # Everything pending predates "now": ordered by (completion
                # step, lane, run row).
                matches += self._decode(None, None, dout, self._step_base)
            if self.ledger is not None:
                # This drain emitted every parked batch's matches.
                self.ledger.commit_deferred(self._clock())
        self.metrics.matches_out += len(matches)
        return matches

    def _decode(self, out, rank_of, drain_out, base: int, lat=None,
                done=None) -> List[Tuple[Hashable, Sequence]]:
        """One batch's matches: the eager ``StepOutput`` grid, or under lazy
        extraction the drained handles when a drain ran.

        ``decode.wait`` runs from the decode's start to the hit count on
        the host: a pipelined batch's ledger bundle ``lat`` takes its
        complete stamp once its outputs are ready (``done``, the end event
        of its launches; on the CPU the scan ran synchronously), then the
        hit rows compact on the device and their count is read, which waits
        for the card.  The rows then come to the host and ``decode.build``
        makes their Events."""
        with self._layer("decode.wait"):
            if lat is not None:
                if done is not None:
                    done.synchronize()
                lat.complete = self._clock()
            if not self.lazy:
                hits = self._hits(out, compact_matches)
            elif drain_out is not None:
                hits = self._hits(drain_out, compact_drained)
        self._read_card_times()
        if not self.lazy:
            return self._decode_eager(out, hits, rank_of)
        if drain_out is None:
            return []
        return self._decode_drained(drain_out, hits, rank_of, base)

    def _hits(self, grid, compact):
        """``(n, rows)``: the hit rows of ``grid`` (a ``StepOutput``, or a
        drain's output) compacted on the device into ``decode_budget`` rows
        by ``compact`` (``ops/decode.py``) and their number, so the host
        pulls rows in proportion to the match count; past the budget
        (counted in ``decode_fallbacks``) ``(None, count)``, the raw count
        grid on the host."""
        if self.decode_budget:
            rows = compact(grid, self.decode_budget)
            n = int(rows[6])
            if n <= min(self.decode_budget, grid.count.numel()):
                return n, rows
            self.metrics.decode_fallbacks += 1
        return None, grid.count.cpu().numpy()

    def _decode_drained(self, dout, hits, rank_of, base: int):
        """Drained handles -> (key, Sequence) in the eager emission order.

        Handles completed in this batch (``seq >= base``) order as the
        eager decode does: by arrival rank of the completing record, then
        run-queue row.  Handles deferred from earlier batches (a
        ``drain_interval > 1``, or a restore) come first, by (completion
        step, lane, run row)."""
        n, rows = hits
        if n is not None:
            if n == 0:
                return []
            c_stage, c_off, c_count, c_seq, c_row, c_k = rows[:6]
            cnts, stages, offs, seqs, rows, ks = (
                x[:n].cpu().numpy()
                for x in (c_count, c_stage, c_off, c_seq, c_row, c_k)
            )
            return self._emit_drained(ks, cnts, stages, offs, seqs, rows,
                                      rank_of, base)
        count = rows
        ks, hs = np.nonzero(count)
        if ks.size == 0:
            return []
        stage, off, seqa, rowa = (
            x.cpu().numpy() for x in (dout.stage, dout.off, dout.seq, dout.row)
        )
        return self._emit_drained(ks, count[ks, hs], stage[ks, hs], off[ks, hs],
                                  seqa[ks, hs], rowa[ks, hs], rank_of, base)

    def _emit_drained(self, ks, cnts, stages, offs, seqs, rows, rank_of, base):
        if rank_of is not None:
            cur = seqs >= base
            t_idx = np.clip(seqs - base, 0, rank_of.shape[1] - 1)
            key2 = np.where(cur, rank_of[ks, t_idx], seqs)
        else:
            cur = np.zeros(ks.shape, bool)
            key2 = seqs
        order = np.lexsort((rows, np.where(cur, 0, ks), key2, cur.astype(np.int8)))
        return self._build_matches(ks[order], cnts[order], stages[order], offs[order])

    def _decode_eager(self, out, hits, rank_of) -> List[Tuple[Hashable, Sequence]]:
        """Device walk outputs -> (key, Sequence), in arrival order, from
        their :meth:`_hits`."""
        n, rows = hits
        if n is not None:
            if n == 0:
                return []
            c_stage, c_off, c_count, c_k, c_t, c_r = rows[:6]
            count, stage, off, k_arr, t_arr, r_arr = (
                x[:n].cpu().numpy()
                for x in (c_count, c_stage, c_off, c_k, c_t, c_r)
            )
            return self._emit(k_arr, t_arr, r_arr, count, stage, off, rank_of)
        count = rows
        ks, ts, rs = np.nonzero(count)
        if ks.size == 0:
            return []
        stage = out.stage.cpu().numpy()
        off = out.off.cpu().numpy()
        return self._emit(
            ks, ts, rs, count[ks, ts, rs], stage[ks, ts, rs], off[ks, ts, rs],
            rank_of,
        )

    def _emit(self, ks, ts, rs, cnts, stages, offs, rank_of):
        """Hit rows -> (key, Sequence) in arrival order (rank of the
        completing record), then run-queue order."""
        order = np.lexsort((rs, rank_of[ks, ts]))
        return self._build_matches(ks[order], cnts[order], stages[order], offs[order])

    def _build_matches(self, ks, cnts, stages, offs):
        """Ordered hit rows -> ``(key, Sequence)`` pairs, each Event from
        the materialized mirror or else built from its column row (counted
        in ``decode_events_materialized``)."""
        names, mirror = self.batch.names, self._events
        matches: List[Tuple[Hashable, Sequence]] = []
        built = 0
        with self._layer("decode.build"):
            for k, n, st, of in zip(ks, cnts, stages, offs):
                k = int(k)
                seq = Sequence()
                for w in range(int(n)):
                    off = int(of[w])
                    ev = mirror[k].get(off)
                    if ev is None:
                        ev = self._column_event(k, off)
                        built += 1
                    seq.add(names[int(st[w])], ev)
                matches.append((self._key_of[k], seq))
        self.metrics.decode_events_materialized += built
        return matches

    def _column_event(self, lane: int, off: int) -> Event:
        """The event at (lane, device offset) from the column batches
        (newest first), kept in the materialized mirror."""
        for start, cnt, abs_ts, leaves in reversed(self._col_batches):
            s = int(start[lane])
            if s >= 0 and s <= off < s + int(cnt[lane]):
                ev = self._materialize(lane, off, s, abs_ts, leaves)
                self._events[lane][off] = ev
                return ev
        raise KeyError(f"lane {lane} has no event at device offset {off}")

    def _materialize(self, lane, off, start, abs_ts, leaves) -> Event:
        """The Event of one packed column row, its value in the schema's
        dtypes (``.item()``: int32 -> int, float32 -> float)."""
        t = off - start
        _, treedef = tree_flatten(self._value_proto)
        value = tree_unflatten(treedef, [l[lane, t].item() for l in leaves])
        return Event(self._key_of[lane], value, int(abs_ts[lane, t]), self.topic,
                     lane, off + int(self._off_base[lane]))

    def _gc_events(self) -> None:
        """Drop host events no longer reachable from device state: only
        events still in a lane's slab or pointed at by a live run can
        appear in a future match; under tiering, also the events of a
        partial prefix held in the stencil carry.  Live rows still in column
        batches materialize first; the batches then drop.  ``gc.read`` is
        the device state's read to the host, ``gc.sweep`` the loop over the
        lanes; the Events built and dropped and the mirror's size after are
        counted in ``layers``."""
        with self._layer("gc.read"):
            slab_stage, slab_off, run_alive, run_off = self.engine_arrays(
                lambda st: (st.slab.stage, st.slab.off, st.alive, st.event_off))
            carry = getattr(self.state, "carry", None)
            carry_off = None if carry is None else carry.offs.cpu().numpy()
        built = dropped = held = 0
        with self._layer("gc.sweep"):
            for k in range(self.num_lanes):
                live = set(slab_off[k][slab_stage[k] >= 0].tolist())
                live.update(run_off[k][run_alive[k]].tolist())
                if carry_off is not None:
                    live.update(carry_off[k][carry_off[k] >= 0].tolist())
                store = self._events[k]
                for start, cnt, abs_ts, leaves in self._col_batches:
                    s = int(start[k])
                    if s < 0:
                        continue
                    hi = s + int(cnt[k])
                    for o in live:
                        if s <= o < hi and o not in store:
                            store[o] = self._materialize(k, o, s, abs_ts, leaves)
                            built += 1
                dead = [o for o in store if o not in live]
                for o in dead:
                    del store[o]
                dropped += len(dead)
                held += len(store)
            self._col_batches.clear()
        self.metrics.gc_events_materialized += built
        self.metrics.gc_events_dropped += dropped
        self.metrics.host_events = held

    # -- diagnostics --------------------------------------------------------

    def counters(self) -> Dict[str, int]:
        """Lane-summed overflow/drop counters (all zero in healthy runs)."""
        return self.batch.counters(self.state)

    def hot_counters(self) -> Dict[str, int]:
        """Lane-summed two-tier residency counters (not loss indicators)."""
        return self.batch.hot_counters(self.state)

    def walk_counters(self) -> Dict[str, int]:
        """Lane-summed walk-cost counters (not loss indicators)."""
        return self.batch.walk_counters(self.state)

    def tier_counters(self) -> Dict[str, int]:
        """Compiler-tiering counters (events the stencil prefix screened,
        prefix completions, promotions); structural zeros untiered."""
        fn = getattr(self.batch, "tier_counters", None)
        if fn is None:
            return {n: 0 for n in TIER_COUNTER_NAMES}
        return fn(self.state)

    def metrics_snapshot(self, per_lane: bool = True) -> Dict[str, Any]:
        """Runtime counters and phase seconds, the engine's loss, hot-tier,
        walk and tier counters, the event-time ``watermark`` and
        ``event_time_lag_ms`` (on the processor's clock), the guard's
        ``stats()`` and ``dead_letters`` by reason (guarded processors
        only), ``per_pattern`` (this processor under its ``name``), the
        tiering plan (``tier_plan``, tiered processors only), ``per_stage``
        under attribution, ``per_lane`` and ``per_key`` (skipped with
        ``per_lane=False`` or while ``telemetry_defer`` is set: one more
        device read), ``phases`` (each batch phase's latency histogram:
        count, sum, p50, p99), ``latency`` (the ledger's snapshot, with
        ``latency=`` only), ``hbm`` (the card's memory byte gauges, ``{}`` on
        the CPU) and ``trace_cache`` (``utils/tracecache.py: stats()``)."""
        snap: Dict[str, Any] = self.metrics.snapshot(self.counters())
        hot = self.hot_counters()
        snap.update(hot)
        snap.update(self.walk_counters())
        tier = self.tier_counters()
        snap.update(tier)
        snap["watermark"] = self._watermark
        snap["event_time_lag_ms"] = (
            int(self._clock() * 1000) - self._watermark
            if self._watermark is not None else None
        )
        if self._guard is not None:
            snap.update(self._guard.stats())
            snap["dead_letters"] = dict(self._guard.reason_counts)
        snap["per_pattern"] = {
            self.name: {
                **self.counters(), **hot, **tier,
                "records_in": self.metrics.records_in,
                "matches_out": self.metrics.matches_out,
            }
        }
        plan = getattr(self.batch, "plan", None)
        if plan is not None:
            snap["tier_plan"] = plan.describe()
        per_stage = self.batch.stage_counters(self.state)
        if per_stage:
            snap["per_stage"] = per_stage
        # Brownout L1+ defers the per-lane and per-key gathers: the one part
        # of the snapshot that reads the device.
        if per_lane and not self.telemetry_defer:
            snap["per_lane"] = self.batch.per_lane_counters(self.state)
            snap["per_key"] = self.per_key_cost(per_lane_arrays=snap["per_lane"])
        if self.ledger is not None:
            # Segment, stall and per-query histograms, exemplars and the SLO
            # burn (rendered as cep_latency_seconds{segment=} and the rest).
            snap["latency"] = self.ledger.snapshot()
        snap["hbm"] = device_memory_stats(self.device)
        # The built-program cache (utils/tracecache.py): entries against
        # capacity and the hit, miss and eviction totals; an eviction storm
        # is rebuild thrash.
        snap["trace_cache"] = tracecache.stats()
        return snap

    def per_key_cost(self, top_k: int = 8, per_lane_arrays=None) -> Dict[str, Any]:
        """The ``top_k`` keys by device walk work (walk + extract + drain
        hops of their lane), each with its lane, hops and share of the
        total: the hot-key signal."""
        arrays = (per_lane_arrays if per_lane_arrays is not None
                  else self.batch.per_lane_counters(self.state))
        hops = (
            np.asarray(arrays["walk_hops"], dtype=np.int64)
            + np.asarray(arrays["extract_hops"], dtype=np.int64)
            + np.asarray(arrays["drain_hops"], dtype=np.int64)
        ).reshape(-1)
        total = int(hops.sum())
        order = np.argsort(hops, kind="stable")[::-1][: max(int(top_k), 1)]
        top = []
        for lane in order:
            lane = int(lane)
            if hops[lane] <= 0 or lane not in self._key_of:
                continue
            top.append({
                "key": str(self._key_of[lane]),
                "lane": lane,
                "hops": int(hops[lane]),
                "share": round(float(hops[lane]) / total, 4) if total else 0.0,
            })
        return {"total_hops": total, "top": top}
