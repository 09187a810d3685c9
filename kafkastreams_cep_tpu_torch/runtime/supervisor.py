"""Failure detection and recovery: the rebalance and changelog-restore
analog, over the port's :class:`CEPProcessor`.

The reference leaves fault tolerance to Kafka Streams: every store is
changelog-backed, so a reassigned task replays the changelog to rebuild its
run queue, buffer and aggregates (``CEPProcessor.java:117-134,144-149``).
Here the same contract is split in two:

* **checkpoint**, the changelog snapshot: the supervisor persists the
  processor's full state (``runtime/checkpoint.py``) every
  ``checkpoint_every`` batches, with the gap covered by a record journal;
* **journal and replay**, the changelog tail: the batches since the last
  checkpoint are kept on the host (and, with ``journal_path``, in a
  CRC-framed file, ``native/journal.py``); on a failure the supervisor
  restores the checkpoint and replays them, which is deterministic (the
  engine is a pure function of state and records), so the processor lands
  in exactly the state it had before the failure.

Any exception out of a batch's dispatch but :class:`InputRejected` (a bad
batch, not a bad device) triggers the recovery, on the same device; matches
the replay re-derives are suppressed, so the caller sees every match once.
With ``auto_escalate`` a batch that trips a capacity counter is rolled back,
the live state migrated onto a wider config (``runtime/migrate.py``) and the
batch re-processed there.  :meth:`Supervisor.health` reports the loss
counters and state-validity probes.

With a latency ledger on the processor (the ``latency=`` processor
keyword), recover and replan wall time land in its stall histograms,
tagged with the batch's correlation id, and an SLO burn rate first
crossing 1.0 dumps the flight recorder.

With ``overload_policy`` the supervisor runs the brownout ladder
(``runtime/overload.py``): one controller tick a batch on host signals
(SLO burn, reorder hold depth and age, queue p99, deferred drains), and a
transition protocol that fires the ``overload.enter``/``overload.exit``
failpoints, applies the level's actuators (drain cadence, telemetry
deferral, the admission squeeze of :meth:`Supervisor.attach_admission`,
the ingest door's shed) and pins the level with a checkpoint; the level
rides ``extra["overload"]``, so a recovery, a resume and a replay land in
it.

On a meshed processor (the ``mesh=`` processor keyword) the same
machinery covers shard failure: a dead device (:class:`~kafkastreams_cep_tpu_torch.
parallel.sharding.ShardLost` out of the dispatch, or a ``shard_probe``
report beside any other dispatch error) triggers an evacuation: restore
the last checkpoint and replay the journal onto the surviving sub-mesh
(``parallel.sharding.surviving_mesh``), pin the new assignment with a
snapshot and retry the batch, degraded but exactly once.  Straggler
watermarks (:meth:`Supervisor.observe_shard_latency`) declare a lagging
shard and evacuate it at the next batch boundary, and at checkpoint
boundaries the per-lane hop counters drive hot-key rebalancing, a pure
lane relabeling (``runtime.migrate.move_lanes``) with no dropped or
duplicated match (:class:`ShardPolicy` keeps both from thrashing).

This is the JAX package's supervisor (``kafkastreams_cep_tpu/runtime/
supervisor.py``).  Checkpoints and journals are the JAX package's formats,
so either package resumes the other's.
"""

from __future__ import annotations

import itertools
import os
import pickle
import tempfile
import time
from dataclasses import dataclass, field
from typing import Hashable, List, Optional, Sequence as Seq, Tuple

import numpy as np

from kafkastreams_cep_tpu_torch.engine import sizing
from kafkastreams_cep_tpu_torch.engine.matcher import EngineConfig
from kafkastreams_cep_tpu_torch.engine.sizing import EscalationPolicy
from kafkastreams_cep_tpu_torch.native.journal import Journal
from kafkastreams_cep_tpu_torch.parallel.sharding import ShardLost, surviving_mesh
from kafkastreams_cep_tpu_torch.runtime import checkpoint as ckpt_mod
from kafkastreams_cep_tpu_torch.runtime import migrate as migrate_mod
from kafkastreams_cep_tpu_torch.runtime.overload import MAX_LEVEL as _OVERLOAD_MAX_LEVEL
from kafkastreams_cep_tpu_torch.runtime.overload import OverloadController
from kafkastreams_cep_tpu_torch.runtime.processor import CEPProcessor, InputRejected, Record
from kafkastreams_cep_tpu_torch.utils.events import Sequence
from kafkastreams_cep_tpu_torch.utils.failpoints import fire as _failpoint
from kafkastreams_cep_tpu_torch.utils.logging import get_logger
from kafkastreams_cep_tpu_torch.utils.telemetry import (
    MetricsRegistry,
    maybe_span,
    positive_delta,
    timed_histogram,
)

logger = get_logger("runtime.supervisor")


@dataclass
class HealthReport:
    """One health probe of a live processor."""

    healthy: bool
    warnings: List[str] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)
    counters: dict = field(default_factory=dict)


def check_health(processor: CEPProcessor) -> HealthReport:
    """Probe a processor's engine state for capacity loss and corruption.

    *Warnings* are capacity events (bounded-shape drops: runs, slab
    entries, pointer lists, Dewey width, walk length): matching may have
    lost branches, which the reference (an unbounded heap) never does;
    *errors* are states no healthy run reaches (NaN fold state, negative
    refcounts) and mean corruption."""
    counters = processor.counters()
    warnings = [f"{name}={val} capacity drops" for name, val in counters.items() if val]
    errors = []
    # Fold state is typed-encoded int32 (float32 states as bit patterns);
    # only float-typed columns can hold NaN.
    agg, refs = processor.engine_arrays(lambda eng: (eng.agg, eng.slab.refs))
    dtypes = processor.batch.matcher.tables.state_dtypes
    flt = [i for i, d in enumerate(dtypes) if d == "float32"]
    if flt and np.isnan(np.ascontiguousarray(agg[..., flt]).view(np.float32)).any():
        errors.append("NaN in fold-aggregate state")
    if bool((refs < 0).any()):
        errors.append("negative slab refcount")
    return HealthReport(healthy=not errors, warnings=warnings, errors=errors,
                        counters=counters)


@dataclass
class ShardPolicy:
    """When a meshed supervisor declares a shard sick and when it moves
    lanes; both sides are hysteretic, because an evacuation or a move costs
    a restore or a rebuild plus a pinning snapshot.

    Stragglers (fed by :meth:`Supervisor.observe_shard_latency`): a shard
    whose step-latency watermark (the max of its last ``straggler_window``
    observations) exceeds ``straggler_factor`` times the median of the
    other shards' watermarks on ``straggler_streak`` consecutive
    observations is declared lagging; with ``evacuate_stragglers`` it is
    evacuated at the next batch boundary, like a dead shard.

    Skew (checked at checkpoint boundaries from the per-lane hop deltas
    behind ``CEPProcessor.per_key_cost``): a boundary trips when the window
    saw at least ``rebalance_min_hops`` hops and the hottest shard carried
    more than ``rebalance_skew`` times the mean shard load.  After
    ``rebalance_streak`` tripping boundaries in a row (and more than
    ``rebalance_cooldown`` boundaries since the last move), hot lanes are
    spread greedily (``runtime.migrate.plan_rebalance``) and moved with
    ``runtime.migrate.move_lanes``."""

    straggler_factor: float = 3.0
    straggler_window: int = 8
    straggler_streak: int = 3
    evacuate_stragglers: bool = True
    rebalance_skew: float = 2.0
    rebalance_min_hops: int = 64
    rebalance_streak: int = 2
    rebalance_cooldown: int = 1


@dataclass
class AdaptPolicy:
    """When the supervisor re-derives the execution plan from measured
    selectivity (adaptive recompilation).

    The lazy-chain conjunct order and tier split (``compiler/tiering.py``)
    are derived once; a stream whose selectivity drifts leaves that plan
    stale (correct, but doing the expensive conjunct's work first).  At
    every checkpoint boundary the supervisor compares the windowed
    per-stage (and per-conjunct, under ``stage_attribution``) accept
    fraction with the one the live plan was derived from; sustained drift
    triggers ``runtime.migrate.replan_processor``, which swaps the
    processor in place with the state transferred verbatim, so matches,
    emission order and loss counters are invariant to the swap point.

    A boundary *trips* when a tracked selectivity with at least
    ``min_evals`` windowed evaluations moved more than ``drift_threshold``
    (absolute) from its plan-time value; ``replan_streak`` consecutive
    tripping boundaries (``cooldown`` boundaries after the last swap) fire
    the replan.  A swap that fails (the ``replan.swap`` fault site) keeps
    the old processor and plan and counts in ``replan_failures``."""

    drift_threshold: float = 0.25
    min_evals: int = 256
    replan_streak: int = 2
    cooldown: int = 1


class Supervisor:
    """A checkpointing, health-probing, auto-recovering processor wrapper.

    ``pattern`` must be re-compilable user code (predicates and folds live
    in code, never in checkpoints); the supervisor owns the processor it
    creates, on ``device`` (a processor keyword, ``"cuda"`` by default).

    ``process(records)`` behaves like :meth:`CEPProcessor.process`, and:

    * every ``checkpoint_every`` batches the full state is checkpointed
      (atomic rename, so a crash mid-write keeps the previous snapshot);
    * if the processor raises, the supervisor restores the latest
      checkpoint on the same device, replays the journaled batches since
      it (suppressing their already-emitted matches), retries the failing
      batch (``max_retries`` times, after a backoff) and counts the
      recovery in ``recoveries``;
    * with ``journal_path`` every batch is also appended to a CRC-framed
      on-disk journal (``native/journal.py``, C++ write path), so
      :meth:`Supervisor.resume` recovers from a process crash;
      ``journal_sync=True`` fsyncs each append;
    * with ``auto_escalate`` (``True`` for the default
      :class:`~kafkastreams_cep_tpu_torch.engine.sizing.EscalationPolicy`,
      or a policy), a batch that trips a capacity counter is rolled back,
      the state migrated onto a strictly wider config and the batch
      re-processed there (``escalations``); a snapshot right after pins the
      wide config for later recoveries and resumes;
    * with ``adapt_policy`` (``True`` or an :class:`AdaptPolicy`) a tiered
      processor under ``stage_attribution`` is replanned at checkpoint
      boundaries when its measured selectivity drifts (``replans``);
    * with ``overload_policy`` (``True`` for the default
      :class:`~kafkastreams_cep_tpu_torch.runtime.overload.OverloadPolicy`,
      or a policy) the brownout ladder runs (module docstring);
    * with a ``mesh`` (a processor keyword), a :class:`ShardPolicy` is on
      by default (``shard_policy=False`` turns it off): a lost shard is
      evacuated (``evacuations``), a lagging one too (``stragglers``), and
      hot lanes are rebalanced (``rebalances``, ``lanes_moved``,
      ``rebalance_failures``); ``shard_probe``, a callable returning the
      shard indices a deployment believes dead, turns a generic dispatch
      error into an evacuation.
    """

    _instance_ids = itertools.count()

    def __init__(
        self,
        pattern,
        num_lanes: int,
        config: Optional[EngineConfig] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 16,
        max_retries: int = 1,
        journal_path: Optional[str] = None,
        journal_sync: bool = False,
        auto_escalate=False,
        retry_backoff_ms: float = 50.0,
        retry_backoff_cap_ms: float = 5000.0,
        processor: Optional[CEPProcessor] = None,
        shard_policy=None,
        shard_probe=None,
        adapt_policy=None,
        overload_policy=None,
        _resuming: bool = False,
        **proc_kwargs,
    ):
        if auto_escalate is True:
            self._policy: Optional[EscalationPolicy] = EscalationPolicy()
        elif auto_escalate:
            self._policy = auto_escalate
        else:
            self._policy = None
        self._pattern = pattern
        self._proc_kwargs = dict(proc_kwargs)
        self.device = self._proc_kwargs.get("device", "cuda")
        # ``processor`` lets resume() hand over a restored processor.
        self.processor = processor or CEPProcessor(pattern, num_lanes, config,
                                                   **self._proc_kwargs)
        # Per-instance default path: two supervisors in one process never
        # clobber each other's snapshots.
        self.checkpoint_path = checkpoint_path or os.path.join(
            tempfile.gettempdir(),
            f"cep_supervisor_{os.getpid()}_{next(self._instance_ids)}.ckpt",
        )
        self.checkpoint_every = int(checkpoint_every)
        self.max_retries = int(max_retries)
        # Exponential retry backoff with deterministic jitter: a fault that
        # survives the instant retry is usually environmental, and retrying
        # back to back turns one fault into a train.  The jitter derives
        # from (seq, attempt), so a retry always waits the same time.
        # Tests patch ``self._sleep``.
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.retry_backoff_cap_ms = float(retry_backoff_cap_ms)
        self.retry_backoff_ms_total = 0.0
        self._sleep = time.sleep
        self._journal: List[List[Record]] = []  # batches since the last checkpoint
        self._disk_journal = Journal(journal_path, sync=journal_sync) if journal_path else None
        if not _resuming:
            # A fresh supervisor over a previous run's files: that history
            # would leak into a later resume() (its checkpoint, with a
            # higher seq, restored and the new run's frames skipped).
            # Starting fresh declares it abandoned: remove both, loudly.
            if (self._disk_journal is not None and os.path.exists(journal_path)
                    and os.path.getsize(journal_path) > 0):
                logger.warning(
                    "journal %s holds frames from a previous run; truncating "
                    "(use Supervisor.resume to continue that history)", journal_path)
                self._disk_journal.truncate()
            if self._disk_journal is not None and os.path.exists(journal_path + ".prev"):
                os.remove(journal_path + ".prev")
            if os.path.exists(self.checkpoint_path):
                logger.warning(
                    "checkpoint %s belongs to a previous run; removing (use "
                    "Supervisor.resume to continue that history)", self.checkpoint_path)
                os.remove(self.checkpoint_path)
            if os.path.exists(self.checkpoint_path + ".prev"):
                os.remove(self.checkpoint_path + ".prev")
        self._has_checkpoint = False
        self._batches_since_ckpt = 0
        # Monotone batch sequence number, stamped into journal frames and
        # the checkpoint header, so resume() can tell which frames a
        # snapshot already holds.
        self._seq = 0
        self.recoveries = 0
        self.checkpoints = 0
        self.checkpoint_failures = 0
        self.journal_failures = 0
        self.escalations = 0
        self.ingest_escalations = 0
        # Escalation baselines: the loss counters are cumulative, so a trip
        # is a positive delta against the snapshot after the last batch.
        self._ingest_base: Optional[dict] = None
        self._counter_base: Optional[dict] = None
        self._trip_streak = 0
        # Matches a checkpoint flushed out of a pipelined processor but not
        # yet returned (drained at the end of process(); kept across a
        # failed snapshot so nothing is lost).
        self._unclaimed: List[Tuple[Hashable, Sequence]] = []
        # Mesh fault tolerance: on whenever the processor is meshed (a dead
        # shard with no policy would crash, which is worse than running
        # degraded); ``shard_policy=False`` turns it off.
        if shard_policy is False:
            self._shard_policy: Optional[ShardPolicy] = None
        elif shard_policy is not None:
            self._shard_policy = shard_policy
        else:
            self._shard_policy = ShardPolicy() if self._mesh() is not None else None
        # A zero-argument callable returning the shard indices an outside
        # health source believes dead, consulted when a dispatch fails with
        # a generic error (a ShardLost names its shard itself).
        self._shard_probe = shard_probe
        self.evacuations = 0
        self.rebalances = 0
        self.rebalance_failures = 0
        self.lanes_moved = 0
        self.stragglers = 0
        # Straggler bookkeeping by shard index: recent step latencies,
        # consecutive over-watermark counts and the shards declared lagging;
        # all cleared by an evacuation, which renumbers the shards.
        self._shard_lat: dict = {}
        self._lag_streak: dict = {}
        self._lagging: set = set()
        # Rebalance hysteresis: the per-lane hop baseline of the windowed
        # delta, tripping boundaries in a row, boundaries since the last move.
        self._hops_base: Optional[np.ndarray] = None
        self._rebalance_streak = 0
        self._boundaries_since_move = 10**9  # no cooldown before the first
        if adapt_policy is True:
            self._adapt_policy: Optional[AdaptPolicy] = AdaptPolicy()
        elif adapt_policy:
            self._adapt_policy = adapt_policy
        else:
            self._adapt_policy = None
        self.replans = 0
        self.replan_failures = 0
        # Selectivity the live plan was derived from, and the cumulative
        # (evals, accepts) at the previous boundary; both reset on every
        # rollback rebuild (_restore_tail).
        self._plan_sel: Optional[dict] = None
        self._sel_prev: Optional[dict] = None
        self._replan_streak = 0
        self._boundaries_since_replan = 10**9  # no cooldown before the first
        # After a failed append the on-disk journal is no longer a complete
        # history; journaling waits for the next checkpoint's clean base.
        self._journal_suspended = False
        # Telemetry: the supervisor shares the processor's trace sink (the
        # ``trace_sink=`` processor keyword) and owns the lifecycle latency
        # histograms (checkpoint, recover, escalate, evacuate, rebalance,
        # replan).
        self.trace = self._proc_kwargs.get("trace_sink")
        self.telemetry = MetricsRegistry()
        for n in ("checkpoint", "recover", "escalate", "evacuate", "rebalance", "replan"):
            self.telemetry.histogram(f"phase.{n}")
        # Flight recorder (the ``flight=`` processor keyword): the
        # supervisor dumps it on a crash, a recovery and an escalation, and
        # re-attaches it to every rebuilt processor (checkpoints carry no
        # telemetry wiring).
        self.flight = self._proc_kwargs.get("flight")
        if self.flight is not None:
            self.processor.flight = self.flight
        # The SLO burn latch (_slo_tick): one flight dump per excursion
        # over burn 1.0, not one a batch while burning.
        self._slo_burning = False
        # The brownout ladder: ``True`` takes the default OverloadPolicy, a
        # policy tunes it, None or False leaves it off.  The controller is
        # durable supervisor state: its level rides the checkpoint header
        # (``extra["overload"]``) and every transition pins a snapshot, so
        # a recovery, a resume or a replay lands in the same level.
        if overload_policy is True:
            self._overload: Optional[OverloadController] = OverloadController()
        elif overload_policy:
            self._overload = OverloadController(overload_policy)
        else:
            self._overload = None
        # The caller's admission front door (runtime/tenant.py
        # TenantAdmission, or a bare AdmissionLimiter) that L2 squeezes; see
        # attach_admission().
        self._admission = None
        if self._overload is not None:
            self._overload.base_drain = self.processor.drain_interval
            self._overload_wire()

    @classmethod
    def resume(
        cls,
        pattern,
        num_lanes: int,
        config: Optional[EngineConfig] = None,
        checkpoint_path: Optional[str] = None,
        journal_path: Optional[str] = None,
        **kwargs,
    ) -> "Supervisor":
        """Rebuild a supervisor after a process crash.

        Restores ``checkpoint_path`` where it exists (else starts fresh) on
        ``device`` (a keyword, ``"cuda"`` by default) or on ``mesh`` (a
        keyword; it may differ from the mesh that wrote the snapshot), then
        replays the
        on-disk journal chain's intact prefix, suppressing the replayed
        matches (the crashed process emitted them).  Frames at or below the
        checkpoint's sequence number are skipped, so a crash between a
        snapshot and the journal's rotation cannot replay a batch twice.  A
        snapshot that fails its integrity check falls back to the ``.prev``
        snapshot (or a fresh processor), and the journal chain (``.prev``
        frames, then the live ones) replays the whole gap."""
        proc = None
        base_seq = 0
        overload_state = None
        candidates = []
        if checkpoint_path:
            candidates = [p for p in (checkpoint_path, checkpoint_path + ".prev")
                          if os.path.exists(p)]
        for path in candidates:
            try:
                ckpt = ckpt_mod.load_checkpoint(path)
                proc = ckpt_mod.restore_processor(pattern, path, ckpt=ckpt,
                                                  device=kwargs.get("device", "cuda"),
                                                  mesh=kwargs.get("mesh"))
                extra = ckpt["header"].get("extra", {})
                base_seq = int(extra.get("seq", 0))
                overload_state = extra.get("overload")
                break
            except ckpt_mod.CheckpointCorrupt:
                logger.exception("checkpoint %s is corrupt; falling back (the journal "
                                 "chain's replay covers the gap)", path)
        sup = cls(pattern, num_lanes, config, checkpoint_path=checkpoint_path,
                  journal_path=journal_path, processor=proc, _resuming=True, **kwargs)
        sup._has_checkpoint = proc is not None
        sup._seq = base_seq
        # A restored processor carries no telemetry wiring, and no clock.
        sup.processor.trace = sup.trace
        sup.processor.flight = sup.flight
        clock = sup._proc_kwargs.get("clock")
        if clock is not None:
            sup.processor.set_clock(clock)
        # The pinned brownout level before the replay: every journaled batch
        # ran at it (a transition snapshots and truncates the journal), so
        # the replay sheds under the same actuators.
        if sup._overload is not None and overload_state:
            sup._overload.load_state(overload_state)
        sup._overload_wire()
        replayed = skipped = 0
        if sup._disk_journal is not None:
            gap = False
            for jr in (Journal(journal_path + ".prev"), sup._disk_journal):
                for payload in jr.replay():
                    seq, batch = pickle.loads(payload)
                    if seq <= base_seq:
                        skipped += 1  # already inside the snapshot
                        continue
                    if seq != sup._seq + 1:
                        # A seq gap: the journal is not a complete history
                        # (a failed append suspends journaling, so this
                        # should not happen); stop at the last contiguous
                        # frame rather than build a state that never saw
                        # the missing batches.
                        logger.error("journal seq gap (%d -> %d); stopping replay at "
                                     "the last contiguous frame", sup._seq, seq)
                        gap = True
                        break
                    sup.processor.process(batch)  # matches already emitted
                    sup._overload_replay_tick()
                    sup._journal.append(batch)
                    sup._batches_since_ckpt += 1
                    sup._seq = seq
                    replayed += len(batch)
                if gap:
                    break
        # A pipelined replay leaves its last batch undecoded: drain it
        # (suppressed) so it cannot leak out of the next process() call.
        sup.processor.flush()
        if sup._policy is not None:
            sup._counter_base = sup._capacity_counters()
            sup._ingest_base = sup._ingest_loss_counters()
        logger.info("resumed from %s + %s: %d journaled records replayed (%d "
                    "pre-snapshot frames skipped)", checkpoint_path, journal_path,
                    replayed, skipped)
        return sup

    # -- checkpointing ------------------------------------------------------

    def checkpoint(self) -> List[Tuple[Hashable, Sequence]]:
        """Snapshot now (atomically) and rotate the journals.

        A pipelined processor is flushed first (a snapshot cannot carry an
        undecoded batch); the flushed matches are returned, or, when the
        snapshot fails, kept and returned by the next :meth:`process`."""
        with maybe_span(self.trace, "checkpoint", seq=self._seq), \
                timed_histogram(self.telemetry, "phase.checkpoint"):
            if self.processor.pipeline:
                self._unclaimed.extend(self.processor.flush())
            tmp = self.checkpoint_path + ".tmp"
            extra = {"seq": self._seq}
            if self._overload is not None:
                extra["overload"] = self._overload.to_state()
            ckpt_mod.save_checkpoint(self.processor, tmp, extra=extra)
            # Fault site: between writing the snapshot and installing it.
            _failpoint("checkpoint.rename")
            # One generation kept: the outgoing snapshot as ``.prev`` and
            # its journal as ``.prev`` frames, so a snapshot that later
            # fails its digest falls back with the chain covering the gap.
            if os.path.exists(self.checkpoint_path):
                os.replace(self.checkpoint_path, self.checkpoint_path + ".prev")
            os.replace(tmp, self.checkpoint_path)
            self._has_checkpoint = True
            self._journal.clear()
            if self._disk_journal is not None:
                self._rotate_journal()
                self._journal_suspended = False  # a clean base again
            self._batches_since_ckpt = 0
            self.checkpoints += 1
        return self._drain_unclaimed()

    def _rotate_journal(self) -> None:
        """Retire the journal's frames (all inside the snapshot just
        installed) into ``.prev`` and start the live journal empty."""
        jr = self._disk_journal.path
        if os.path.exists(jr):
            os.replace(jr, jr + ".prev")
        else:
            # Nothing to retire, but a ``.prev`` from two checkpoints ago
            # must not outlive its snapshot.
            try:
                os.remove(jr + ".prev")
            except FileNotFoundError:
                pass

    def _drain_unclaimed(self) -> List[Tuple[Hashable, Sequence]]:
        out, self._unclaimed = self._unclaimed, []
        return out

    def drain_ingest(self) -> List[Tuple[Hashable, Sequence]]:
        """End-of-stream drain of the ingestion guard's reorder buffer,
        made durable: the drain is not journaled (no input batch replays
        it), so the state after it is pinned by an immediate snapshot.
        Terminal by convention."""
        matches = self.processor.drain_ingest()
        matches += self.processor.flush()
        try:
            matches = matches + self.checkpoint()
        except Exception:
            self.checkpoint_failures += 1
            logger.exception("post-drain checkpoint failed; a resume will re-drain (the "
                             "drained matches were already emitted)")
        return matches

    # -- the supervised hot path -------------------------------------------

    def process(self, records: Seq[Record]) -> List[Tuple[Hashable, Sequence]]:
        records = list(records)
        # Correlation id: the journal seq this batch gets on success; the
        # recovery and escalation spans of this batch carry it too.
        corr = f"batch-{self._seq + 1}"
        with maybe_span(self.trace, "supervisor.batch", corr=corr, seq=self._seq + 1,
                        records=len(records)) as sp:
            matches = self._process_supervised(records, corr)
            sp["matches"] = len(matches)
            return matches

    def _process_supervised(self, records: List[Record],
                            corr: str) -> List[Tuple[Hashable, Sequence]]:
        # Shards declared lagging are evacuated at the batch boundary,
        # before the dispatch: nothing is in flight there.
        if (self._lagging and self._shard_policy is not None
                and self._shard_policy.evacuate_stragglers):
            mesh = self._mesh()
            if mesh is not None and mesh.size > 1:
                lagging = sorted(self._lagging)
                logger.warning("evacuating lagging shard(s) %s at the batch boundary", lagging)
                self._evacuate(lagging, corr)
        for attempt in range(self.max_retries + 1):
            try:
                # Per attempt (a recovery resets the pipeline): whether the
                # previous batch is still undecoded, which an escalation
                # then recomputes too.
                had_pending = getattr(self.processor, "_pending", None) is not None
                matches = self.processor.process(records)
                break
            except InputRejected:
                # A bad batch, not a bad device: replay cannot help, and the
                # processor's validation left the state untouched.
                raise
            except ShardLost as e:
                # The device is gone: a recovery onto the same mesh would
                # dispatch into it again, so evacuate onto the survivors.
                # Unmeshed or on one device there is nowhere to go: crash.
                mesh = self._mesh()
                if mesh is None or mesh.size < 2 or attempt >= self.max_retries:
                    if self.flight is not None:
                        self.flight.dump("crash", corr=corr)
                    raise
                logger.exception("shard %d lost on a %d-record batch; evacuating onto the "
                                 "surviving sub-mesh", e.shard, len(records))
                self._evacuate([e.shard], corr)
                self._backoff(attempt)
            except Exception:
                if attempt >= self.max_retries:
                    # Retries exhausted: ship the last batches' context first.
                    if self.flight is not None:
                        self.flight.dump("crash", corr=corr)
                    raise
                # A generic error does not say which device failed: ask the
                # probe before recovering onto the same mesh.
                dead = self._probe_dead_shards()
                if dead:
                    logger.exception("processor failed and the shard probe reports shard(s) "
                                     "%s dead; evacuating", sorted(dead))
                    self._evacuate(dead, corr)
                else:
                    logger.exception("processor failed on a %d-record batch; recovering",
                                     len(records))
                    self._recover(corr)
                self._backoff(attempt)
        if self._policy is not None:
            matches = self._maybe_escalate(records, matches, had_pending, corr)
        self._journal.append(records)
        self._seq += 1
        if self._disk_journal is not None and not self._journal_suspended:
            # Journal after success, before returning matches.  A failed
            # append (disk full) must not raise: the state already advanced
            # and a caller's retry would apply the batch twice.  Count it
            # and suspend journaling until the next checkpoint (a later
            # frame after a missing seq would replay into a wrong state).
            try:
                self._disk_journal.append(pickle.dumps((self._seq, records)))
            except Exception:
                self.journal_failures += 1
                self._journal_suspended = True
                logger.exception("journal append failed; journaling suspended until the "
                                 "next checkpoint (batch %d+ not crash-durable)", self._seq)
        self._batches_since_ckpt += 1
        # The SLO and overload observations before the cadence snapshot, so
        # the batch's tick is pinned together with the batch (a snapshot
        # one tick behind would resume streaks an uncrashed run never had,
        # and the batch inside it is never replayed to catch up).  A
        # transition here pins its own snapshot.
        self._slo_tick(corr)
        self._overload_tick(corr)
        # A suspended journal leaves acknowledged batches out of the crash
        # history: snapshot now rather than at the cadence.
        if self._journal_suspended or self._batches_since_ckpt >= self.checkpoint_every:
            # A rebalance or a replan here is pinned by the snapshot right
            # after it, so every recovery and resume replays under it.
            if self._shard_policy is not None:
                self._maybe_rebalance()
            if self._adapt_policy is not None:
                self._maybe_replan(corr)
            # A failed snapshot must not lose the batch's matches: the
            # journal still covers everything since the last good one.
            try:
                matches = matches + self.checkpoint()
            except Exception:
                self.checkpoint_failures += 1
                logger.exception("checkpoint failed; journal retained")
        if self._policy is not None:
            self._maybe_escalate_ingest()
        if self._unclaimed:
            matches = matches + self._drain_unclaimed()
        return matches

    def _backoff(self, attempt: int) -> None:
        """Sleep before re-dispatching a faulted batch: exponential in the
        attempt, capped, with jitter seeded by ``(seq, attempt)``.
        ``retry_backoff_ms=0`` retries at once."""
        if self.retry_backoff_ms <= 0:
            return
        delay_ms = min(self.retry_backoff_cap_ms, self.retry_backoff_ms * (2.0 ** attempt))
        rng = np.random.default_rng((self._seq + 1, attempt))
        delay_ms *= 0.5 + 0.5 * float(rng.random())  # jitter in [0.5, 1.0)
        self.retry_backoff_ms_total += delay_ms
        logger.info("retry backoff: %.1f ms before attempt %d", delay_ms, attempt + 2)
        self._sleep(delay_ms / 1000.0)

    def _rewire(self) -> None:
        """Attach the supervisor's trace sink, flight recorder and clock to
        a rebuilt processor (checkpoints and migrations carry none), and
        re-apply the pinned brownout level's actuators."""
        self.processor.trace = self.trace
        self.processor.flight = self.flight
        clock = self._proc_kwargs.get("clock")
        if clock is not None:
            self.processor.set_clock(clock)
        self._overload_wire()

    def _restore_tail(self) -> int:
        """Restore the last checkpoint on the same device and replay the
        journal since it, dropping the replayed matches (already emitted).
        With no checkpoint yet the journal is the whole history, replayed
        from a fresh processor.  Shared by recovery and escalation."""
        mesh = self._proc_kwargs.get("mesh")
        if self._has_checkpoint:
            try:
                self.processor = ckpt_mod.restore_processor(
                    self._pattern, self.checkpoint_path, device=self.device, mesh=mesh)
            except ckpt_mod.CheckpointCorrupt:
                # resume()'s fallback: the previous-good snapshot, whose
                # journal the in-memory one then covers.
                logger.exception("checkpoint %s is corrupt during recovery; restoring "
                                 "the previous-good snapshot", self.checkpoint_path)
                self.processor = ckpt_mod.restore_processor(
                    self._pattern, self.checkpoint_path + ".prev", device=self.device,
                    mesh=mesh)
            self._rewire()
        else:
            self.processor = CEPProcessor(self._pattern, self.processor.num_lanes,
                                          self.processor.batch.matcher.config,
                                          **self._proc_kwargs)
            # Every journaled batch ran at the pinned level: the replay
            # sheds under the same actuators.
            self._overload_wire()
        replayed = 0
        for batch in self._journal:
            self.processor.process(batch)  # matches already emitted
            replayed += len(batch)
        # A pipelined replay leaves its last batch undecoded: drain it here
        # (suppressed) or it would come out of the next process() again.
        self.processor.flush()
        # The restored processor carries the default plan and reverted
        # attribution counters: the replanner's baselines are stale.
        self._plan_sel = None
        self._sel_prev = None
        self._replan_streak = 0
        return replayed

    def _recover(self, corr: Optional[str] = None) -> None:
        if self.flight is not None:
            # Before the rollback: the ring still holds the faulted batch.
            self.flight.dump("recover", corr=corr)
        t0 = time.perf_counter()
        with maybe_span(self.trace, "recover", corr=corr, seq=self._seq) as sp, \
                timed_histogram(self.telemetry, "phase.recover"):
            replayed = self._restore_tail()
            sp["replayed_records"] = replayed
            sp["from_checkpoint"] = self._has_checkpoint
        self._observe_stall("recover", time.perf_counter() - t0, corr)
        self.recoveries += 1
        # The counters reverted with the state: re-take the escalation
        # baselines before the retry re-runs the failing batch.
        if self._policy is not None:
            self._counter_base = self._capacity_counters()
            self._ingest_base = self._ingest_loss_counters()
        logger.info("recovered: checkpoint=%s, %d journaled records replayed",
                    self._has_checkpoint, replayed)
        # The rebalance baseline indexes the live processor's lanes, and the
        # rollback may precede the last move: measure it again.
        self._hops_base = None

    # -- mesh fault tolerance ------------------------------------------------

    def _mesh(self):
        """The mesh the next (re)built processor lands on: the ``mesh``
        processor keyword, which an evacuation rewrites, else the live
        processor's (a resumed one handed in)."""
        mesh = self._proc_kwargs.get("mesh")
        if mesh is None:
            mesh = getattr(self.processor, "mesh", None)
        return mesh

    def _probe_dead_shards(self) -> set:
        if self._shard_probe is None or self._shard_policy is None:
            return set()
        mesh = self._mesh()
        if mesh is None or mesh.size < 2:
            return set()
        try:
            return {int(s) for s in (self._shard_probe() or ())}
        except Exception:
            logger.exception("shard probe failed; treating as no report")
            return set()

    def _evacuate(self, dead, corr: Optional[str] = None) -> None:
        """Move the lost shards' lanes onto the surviving sub-mesh.

        The spine of :meth:`_recover` (restore the last checkpoint, replay
        the journal, matches suppressed) onto ``surviving_mesh(mesh,
        dead)``: the ``mesh`` keyword is rewritten first, so this and every
        later rebuild lands there (``checkpoint.restore_processor`` places
        the lanes in the new blocks).  An immediate snapshot pins the shrunk
        assignment, so no recovery or resume places lanes on the dead
        device again."""
        mesh = self._mesh()
        dead = sorted({int(d) for d in dead})
        new_mesh = surviving_mesh(mesh, dead, self.processor.num_lanes)
        if self.flight is not None:
            self.flight.note(evacuation=self.evacuations + 1, dead_shards=dead)
            self.flight.dump("evacuate", corr=corr)
        t0 = time.perf_counter()
        with maybe_span(self.trace, "evacuate", corr=corr, seq=self._seq, dead_shards=dead,
                        survivors=new_mesh.size) as sp, \
                timed_histogram(self.telemetry, "phase.evacuate"):
            self._proc_kwargs["mesh"] = new_mesh
            replayed = self._restore_tail()
            sp["replayed_records"] = replayed
            sp["from_checkpoint"] = self._has_checkpoint
            try:
                self._unclaimed.extend(self.checkpoint())
            except Exception:
                self.checkpoint_failures += 1
                logger.exception("post-evacuation checkpoint failed; a resume before the "
                                 "next good snapshot places the lanes itself "
                                 "(restore_processor repartitions on a mesh-size change)")
        self._observe_stall("evacuate", time.perf_counter() - t0, corr)
        self.evacuations += 1
        # The shrink renumbers the shards: the straggler and skew
        # bookkeeping of the old numbering means nothing now.
        self._shard_lat.clear()
        self._lag_streak.clear()
        self._lagging.clear()
        self._hops_base = None
        if self._policy is not None:
            self._counter_base = self._capacity_counters()
            self._ingest_base = self._ingest_loss_counters()
        logger.warning("shard(s) %s evacuated: %d lanes now on %d device(s), %d journaled "
                       "records replayed (degraded but exactly once)", dead,
                       self.processor.num_lanes, new_mesh.size, replayed)

    def observe_shard_latency(self, shard: int, seconds: float) -> bool:
        """Feed one shard's step latency (a per-host heartbeat in a
        deployment).  Returns True while ``shard`` is declared lagging (see
        :class:`ShardPolicy`); with ``evacuate_stragglers`` a declared shard
        is evacuated at the next batch boundary."""
        policy = self._shard_policy
        if policy is None:
            return False
        shard = int(shard)
        lat = self._shard_lat.setdefault(shard, [])
        lat.append(float(seconds))
        del lat[: -int(policy.straggler_window)]
        others = [max(v) for s, v in self._shard_lat.items() if s != shard and v]
        if not others:
            return shard in self._lagging
        med = float(np.median(others))
        if med > 0.0 and max(lat) > policy.straggler_factor * med:
            self._lag_streak[shard] = self._lag_streak.get(shard, 0) + 1
        else:
            self._lag_streak[shard] = 0
        if self._lag_streak[shard] >= policy.straggler_streak and shard not in self._lagging:
            self._lagging.add(shard)
            self.stragglers += 1
            if self.trace is not None:
                self.trace.event("straggler", shard=shard, watermark_s=max(lat),
                                 peer_median_s=med)
            logger.warning("shard %d declared lagging (watermark %.4fs vs peer median "
                           "%.4fs); evacuation at the next batch boundary", shard, max(lat), med)
        return shard in self._lagging

    def _maybe_rebalance(self) -> None:
        """Move hot lanes off a saturated shard at a checkpoint boundary.

        The signal is the per-lane hop delta (walk + extract + drain, the
        counters behind ``CEPProcessor.per_key_cost``) since the last
        boundary; trip, streak and cooldown per :class:`ShardPolicy`.  The
        move is ``migrate.move_lanes`` with ``plan_rebalance``'s
        permutation, pinned by the snapshot that follows; a move that fails
        (the ``rebalance.move`` fault site) leaves the old processor and
        assignment intact."""
        policy = self._shard_policy
        mesh = self._mesh()
        if policy is None or mesh is None:
            return
        n = mesh.size
        k = self.processor.num_lanes
        if n < 2 or k % n != 0:
            return
        self._boundaries_since_move += 1
        arrays = {name: np.asarray(vals, dtype=np.int64).reshape(-1)
                  for name, vals in self.processor.batch.per_lane_counters(
                      self.processor.state).items()
                  if name in ("walk_hops", "extract_hops", "drain_hops")}
        if not arrays:
            return
        hops = sum(arrays.values())
        base = self._hops_base
        if base is None or base.shape != hops.shape:
            self._hops_base = hops
            self._rebalance_streak = 0
            return
        window = hops - base
        self._hops_base = hops
        total = int(window.sum())
        shard_loads = window.reshape(n, k // n).sum(axis=1)
        mean = total / n
        if not (total >= policy.rebalance_min_hops
                and float(shard_loads.max()) > policy.rebalance_skew * mean):
            self._rebalance_streak = 0
            return
        self._rebalance_streak += 1
        if (self._rebalance_streak < policy.rebalance_streak
                or self._boundaries_since_move <= policy.rebalance_cooldown):
            return
        perm = migrate_mod.plan_rebalance(window, n)
        if perm is None:
            self._rebalance_streak = 0
            return
        # The heavy hitters of the same window name the keys being moved
        # (span and log only: the decision is already made).
        hot = self.processor.per_key_cost(top_k=4, per_lane_arrays={
            "walk_hops": window, "extract_hops": np.zeros_like(window),
            "drain_hops": np.zeros_like(window)})
        moved = int(np.sum(perm != np.arange(k)))
        with maybe_span(self.trace, "rebalance", seq=self._seq, lanes_moved=moved,
                        hot_keys=[h["key"] for h in hot["top"]],
                        shard_loads=[int(x) for x in shard_loads]), \
                timed_histogram(self.telemetry, "phase.rebalance"):
            if self.processor.pipeline:
                # An undecoded batch cannot be permuted on the host; its
                # matches go to the caller.
                self._unclaimed.extend(self.processor.flush())
            try:
                self.processor = migrate_mod.move_lanes(self._pattern, self.processor, perm,
                                                        mesh=mesh)
            except Exception:
                self.rebalance_failures += 1
                # move_lanes changes nothing before it succeeds; the
                # baseline still indexes the unmoved lanes.
                logger.exception("lane rebalance failed; keeping the current assignment")
                return
            self._rewire()
            self.rebalances += 1
            self.lanes_moved += moved
            # The baseline follows its lanes to their new positions.
            self._hops_base = hops[perm]
            self._rebalance_streak = 0
            self._boundaries_since_move = 0
        logger.warning("hot-key rebalance #%d: moved %d lanes (window loads per shard %s; "
                       "hottest keys %s)", self.rebalances, moved,
                       [int(x) for x in shard_loads], [h["key"] for h in hot["top"]])

    def _observe_stall(self, cause: str, seconds: float, corr: Optional[str]) -> None:
        """One lifecycle stall (recover or replan wall time) into the
        latency ledger, tagged with the ``corr`` id of the batch it
        handled.  The live (rebuilt) processor's ledger takes it: the
        pre-failure ledger rolled back with the state it described."""
        ledger = getattr(self.processor, "ledger", None)
        if ledger is not None:
            ledger.observe_stall(cause, seconds, corr=corr)

    def _slo_tick(self, corr: str) -> None:
        """When the ledger's SLO burn rate first crosses 1.0, note it in the
        flight ring and dump the ring (the post-mortem then holds the
        batches that spent the budget); re-arms once it falls back."""
        ledger = getattr(self.processor, "ledger", None)
        if ledger is None or ledger.slo is None:
            return
        burn = ledger.slo.burn_rate()
        if burn > 1.0 and not self._slo_burning:
            self._slo_burning = True
            logger.warning("SLO burn rate %.3f exceeds budget (corr=%s)", burn, corr)
            if self.flight is not None:
                self.flight.note(slo_burn=round(burn, 3))
                self.flight.dump("slo_burn", corr=corr)
        elif burn <= 1.0 and self._slo_burning:
            self._slo_burning = False

    # -- overload control (runtime/overload.py) -------------------------------

    def attach_admission(self, admission) -> None:
        """Register the caller's tenant admission front door
        (``runtime/tenant.py: TenantAdmission``, or a bare
        ``AdmissionLimiter``) for the L2 actuator to squeeze in proportion
        to each tenant's measured cost.  Idempotent: the pinned pressure is
        applied at once, so a caller re-attaches after its own restore."""
        self._admission = admission
        self._overload_wire()

    def _overload_limiter(self):
        adm = self._admission
        if adm is None:
            return None
        return getattr(adm, "limiter", adm)

    def _overload_wire(self) -> None:
        """Re-apply the pinned level's actuators: a rebuilt or swapped
        processor (restore, resume, migration, replan) carries the default
        ones and must be re-wired before it processes or replays a batch."""
        if self._overload is not None:
            self._overload_apply()

    def _overload_apply(self) -> None:
        ctl = self._overload
        proc = self.processor
        base = max(int(ctl.base_drain), 1)
        proc.drain_interval = max(1, base * ctl.drain_widen())
        proc.telemetry_defer = ctl.telemetry_defer()
        proc.overload_admit_fraction = ctl.admit_fraction()
        lim = self._overload_limiter()
        if lim is not None:
            scale, shares = ctl.admission_pressure
            lim.set_pressure(scale, shares)

    def _overload_signals(self) -> dict:
        """The pressure inputs, all on the host (no device read a batch): the
        SLO burn rate, the reorder hold's depth and age, the queue segment's
        p99 and the deferred drains (the host's view of the handle ring).
        A processor without a guard or a ledger contributes nothing."""
        sig: dict = {}
        proc = self.processor
        guard = getattr(proc, "_guard", None)
        if guard is not None:
            depth = guard.policy.reorder_depth
            if depth:
                sig["hold_frac"] = guard.held / depth
            grace = guard.policy.grace_ms
            if grace > 0:
                sig["hold_age_frac"] = guard.hold_age_ms() / grace
        ledger = getattr(proc, "ledger", None)
        if ledger is not None:
            if ledger.slo is not None:
                sig["burn_rate"] = ledger.slo.burn_rate()
            hist = ledger._hists.get("queue")
            if hist is not None:
                sig["queue_p99_s"] = hist.percentile(0.99)
            sig["ring_depth"] = len(ledger._deferred)
        return sig

    def _overload_shares(self) -> dict:
        """Each tenant's share of the cost, from the heavy-hitter attribution
        (``per_key_cost``'s top keys) mapped through the admission policy's
        key-to-tenant function: L2 squeezes by measured cost, not record
        count.  One device read, on an L2+ transition only."""
        adm = self._admission
        if adm is None:
            return {}
        policy = getattr(adm, "policy", None)
        key_tenant = getattr(policy, "key_tenant", None) or str
        try:
            top = self.processor.per_key_cost().get("top") or []
        except Exception:
            logger.exception("per-key cost attribution failed; squeezing all tenants "
                             "uniformly")
            return {}
        shares: dict = {}
        for row in top:
            tenant = str(key_tenant(row["key"]))
            shares[tenant] = shares.get(tenant, 0.0) + float(row["share"])
        return shares

    def _overload_replay_tick(self) -> None:
        """The controller's observation of one replayed batch, taking no
        transition.  The crashed process ticked once a journaled batch after
        its last pin, and a resume restores the pinned streaks, so the
        replay must repeat those ticks or the resumed ladder would trail the
        uncrashed one by the journal window.  A committed transition pins a
        snapshot that truncates the journal, so every replayed batch was a
        no-transition tick; a proposal here (only from wall-clock signals)
        keeps its streak at threshold and commits on the first live batch."""
        ctl = self._overload
        if ctl is None:
            return
        guard = getattr(self.processor, "_guard", None)
        if guard is not None:
            ctl.shed_total = guard.overload_shed
        ctl.tick(self._overload_signals())

    def _overload_tick(self, corr: str) -> None:
        """One controller observation a batch (after _slo_tick); a proposal
        runs the transition protocol."""
        ctl = self._overload
        if ctl is None:
            return
        guard = getattr(self.processor, "_guard", None)
        if guard is not None:
            ctl.shed_total = guard.overload_shed
        proposal = ctl.tick(self._overload_signals())
        if proposal is not None:
            self._overload_transition(proposal[0], proposal[1], corr)

    def _overload_transition(self, from_level: int, to_level: int, corr: str) -> None:
        """The transition protocol: failpoint, tentative level, actuators,
        pin checkpoint, commit.  Any failure (an armed failpoint, a failed
        pin) reverts the level and the actuators, so the level in memory is
        always the last pinned one and a recovery's replay never spans a
        transition."""
        ctl = self._overload
        entering = to_level > from_level
        site = "overload.enter" if entering else "overload.exit"
        try:
            with maybe_span(self.trace, "overload.transition", corr=corr,
                            from_level=from_level, to_level=to_level,
                            pressure=round(ctl.last_pressure, 4)):
                # Fault site: before the actuators apply or the level pins; a
                # crash here leaves the previous level live.
                _failpoint(site)
                ctl.begin(to_level)
                scale = ctl.admission_scale(to_level)
                ctl.admission_pressure = (
                    float(scale), dict(self._overload_shares()) if scale < 1.0 else {})
                self._overload_apply()
                if entering and to_level >= _OVERLOAD_MAX_LEVEL:
                    # Emergency entry: flush pinned drains into the pin
                    # snapshot; their matches go out through _unclaimed.
                    self._unclaimed.extend(self.processor.flush())
                # The pin: the transition exists once snapshotted, so a
                # replayed crash lands in the same level.
                self._unclaimed.extend(self.checkpoint())
        except Exception:
            ctl.abort()
            self._overload_apply()
            logger.exception("overload transition L%d -> L%d failed; L%d stays "
                             "authoritative", from_level, to_level, from_level)
            return
        ctl.commit()
        if self.flight is not None:
            self.flight.note(overload_level=to_level,
                             overload_pressure=round(ctl.last_pressure, 4))
            if entering and to_level >= 3:
                # L3+ entry is the incident boundary: dump the last batches
                # while the ring still holds the flood that forced the shed.
                self.flight.dump("overload", corr=corr)

    # -- adaptive replanning --------------------------------------------------

    @staticmethod
    def _sel_counts(per_stage: dict) -> dict:
        """A ``stage_counters`` snapshot as cumulative ``{key: (evals,
        accepts)}`` rows: ``(stage,)`` per stage and ``(stage,
        conjunct_key)`` per measured conjunct."""
        counts: dict = {}
        for name, row in per_stage.items():
            if not isinstance(row, dict):
                continue
            counts[(name,)] = (int(row.get("stage_evals", 0) or 0),
                               int(row.get("stage_accepts", 0) or 0))
            cj = row.get("conjuncts")
            if isinstance(cj, dict):
                for key, crow in cj.items():
                    if isinstance(crow, dict):
                        counts[(name, key)] = (int(crow.get("evals", 0) or 0),
                                               int(crow.get("accepts", 0) or 0))
        return counts

    def _maybe_replan(self, corr: Optional[str] = None) -> None:
        """Swap the processor onto a re-derived plan when the measured
        selectivity drifted from the plan's (see :class:`AdaptPolicy`).
        Runs at checkpoint boundaries; the swap
        (``migrate.replan_processor``: config unchanged, state verbatim) is
        pinned by the checkpoint right after it.  A failed swap keeps the
        old processor and plan."""
        policy = self._adapt_policy
        if policy is None:
            return
        if not getattr(self.processor.batch.matcher.config, "tiering", False):
            return  # replan_processor needs the tiered matcher
        per_stage = self.processor.batch.stage_counters(self.processor.state)
        if not per_stage:
            return  # stage_attribution off: nothing measured
        counts = self._sel_counts(per_stage)
        prev, self._sel_prev = self._sel_prev, counts
        self._boundaries_since_replan += 1
        if self._plan_sel is None:
            # The first boundary with data pins the plan's baseline.
            self._plan_sel = {key: ac / ev for key, (ev, ac) in counts.items()
                              if ev >= policy.min_evals}
            return
        for key, (ev, ac) in counts.items():
            if key not in self._plan_sel and ev >= policy.min_evals:
                self._plan_sel[key] = ac / ev
        if prev is None:
            return  # no window yet (the first boundary after a rollback)
        drifted = []
        for key, (ev, ac) in counts.items():
            pev, pac = prev.get(key, (0, 0))
            wev, wac = ev - pev, ac - pac
            base = self._plan_sel.get(key)
            # wev < 0: the tally restarted under this key (a replan resets
            # the conjunct accumulator); wait for a full window.
            if base is None or wev < policy.min_evals:
                continue
            wsel = wac / wev
            if abs(wsel - base) > policy.drift_threshold:
                drifted.append((key, round(base, 4), round(wsel, 4)))
        if not drifted:
            self._replan_streak = 0
            return
        self._replan_streak += 1
        if (self._replan_streak < policy.replan_streak
                or self._boundaries_since_replan <= policy.cooldown):
            return
        t0 = time.perf_counter()
        with maybe_span(self.trace, "replan", corr=corr, seq=self._seq,
                        drifted=[{"key": "/".join(k), "plan": b, "window": w}
                                 for k, b, w in drifted]), \
                timed_histogram(self.telemetry, "phase.replan"):
            if self.processor.pipeline:
                # The undecoded batch belongs to the old plan's dispatch.
                self._unclaimed.extend(self.processor.flush())
            try:
                self.processor = migrate_mod.replan_processor(
                    self._pattern, self.processor, per_stage)
            except Exception:
                self.replan_failures += 1
                # replan_processor changes nothing before it succeeds.
                logger.exception("adaptive replan failed; keeping the current plan")
                self._replan_streak = 0
                return
            self._rewire()
            self.replans += 1
            self._replan_streak = 0
            self._boundaries_since_replan = 0
            # The new plan was derived from this profile; the window
            # restarts with the rebuilt matcher's conjunct accumulator.
            self._plan_sel = {key: ac / ev for key, (ev, ac) in counts.items()
                              if ev >= policy.min_evals}
            self._sel_prev = None
        self._observe_stall("replan", time.perf_counter() - t0, corr)
        logger.warning("adaptive replan #%d: selectivity drift %s (plan -> window); plan "
                       "re-derived from the measured profile", self.replans,
                       [("/".join(k), b, w) for k, b, w in drifted])

    # -- elastic capacity escalation ----------------------------------------

    def _capacity_counters(self) -> dict:
        return sizing.capacity_counters(self.processor.counters())

    def _ingest_loss_counters(self) -> dict:
        guard = getattr(self.processor, "_guard", None)
        if guard is None:
            return {}
        return sizing.ingest_capacity_counters(guard.loss_counters())

    def _maybe_escalate(self, records, matches, had_pending: bool = False,
                        corr: Optional[str] = None) -> List[Tuple[Hashable, Sequence]]:
        """Detect capacity loss in the batch just processed and recover it.

        A trip is a positive delta of the cumulative loss counters over the
        snapshot after the previous batch.  After ``hysteresis``
        consecutive tripping batches: roll back to the state before the
        batch, migrate it onto the next wider config, snapshot it (so later
        recoveries and resumes replay at the new width) and re-process the
        batch, returning the re-run's matches in place of the lossy
        attempt's (never emitted).  Repeats up to ``policy.max_rounds``
        while the re-run still trips; at the policy's ceiling it warns and
        keeps counting."""
        policy = self._policy
        counters = self._capacity_counters()
        base = self._counter_base
        if base is None:
            # The first observation (a fresh or restored processor).
            base = {k: 0 for k in counters} if self._seq == 0 else counters
        tripped = positive_delta(counters, base)
        if not tripped:
            self._counter_base = counters
            self._trip_streak = 0
            return matches
        self._trip_streak += 1
        if self._trip_streak < policy.hysteresis:
            logger.warning("capacity trip %s tolerated (%d/%d before escalation); this "
                           "batch's lost branches are NOT recovered", tripped,
                           self._trip_streak, policy.hysteresis)
            self._counter_base = counters
            return matches
        # Serial mode: ``matches`` is the lossy attempt's, superseded by the
        # re-run.  Pipelined: the return can mix the previous batch's clean
        # matches with this batch's lossy ones, so when the previous batch
        # was still in flight it is popped from the journal and recomputed
        # from the rollback point too; both re-runs are flushed.
        pipeline = self.processor.pipeline
        kept: List[Tuple[Hashable, Sequence]] = []
        rerun = [] if pipeline else matches
        redo_prev = pipeline and had_pending and bool(self._journal)
        rolled = False
        for _round in range(policy.max_rounds):
            cfg = self.processor.batch.matcher.config
            new_cfg = sizing.escalate(cfg, tripped, policy)
            if new_cfg is None:
                logger.warning("escalation exhausted at the policy ceiling (counters %s); "
                               "degrading to warn-and-count", tripped)
                self._counter_base = counters
                return (kept + rerun) if rolled else matches
            new_dims = {k: getattr(new_cfg, k) for k in
                        ("max_runs", "slab_entries", "slab_preds", "dewey_depth", "max_walk")}
            with maybe_span(self.trace, "escalate", corr=corr, round=_round,
                            tripped=dict(tripped), new_config=new_dims) as esp, \
                    timed_histogram(self.telemetry, "phase.escalate"):
                if self.flight is not None:
                    # The context of the trip, before the rollback drops it.
                    self.flight.note(escalation=self.escalations + 1, tripped=dict(tripped))
                    self.flight.dump("escalate", corr=corr)
                if redo_prev:
                    prev_batch = self._journal.pop()
                # Roll back to the state before the batch; a pending decode
                # belongs to the lossy attempt and dies with it.
                self._restore_tail()
                self.processor = migrate_mod.migrate_processor(
                    self._pattern, self.processor, new_cfg,
                    mesh=self._proc_kwargs.get("mesh"))
                self._rewire()
                self.escalations += 1
                logger.warning("capacity escalation #%d: %s after counters %s; "
                               "re-processing the %d-record batch at the new width",
                               self.escalations, new_dims, tripped, len(records))
                if redo_prev:
                    # The in-flight previous batch, whose matches rode the
                    # discarded lossy return (a wider config drops nothing
                    # the narrow one kept, so this re-run is clean).
                    kept = list(self.processor.process(prev_batch))
                    kept += self.processor.flush()
                    self._journal.append(prev_batch)
                    redo_prev = False
                # Pin the wide config before re-processing: a recovery or
                # resume from here on replays at the new width.
                try:
                    self.checkpoint()
                except Exception:
                    self.checkpoint_failures += 1
                    logger.exception("post-escalation checkpoint failed; a recovery "
                                     "before the next good snapshot replays at the OLD width")
                pre = self._capacity_counters()
                rerun = self.processor.process(records)
                if pipeline:
                    rerun = rerun + self.processor.flush()
                rolled = True
                counters = self._capacity_counters()
                tripped = positive_delta(counters, pre)
                esp["still_tripped"] = bool(tripped)
            if not tripped:
                break
        else:
            logger.warning("batch still trips %s after %d escalation rounds; keeping the "
                           "widest result", tripped, policy.max_rounds)
        self._counter_base = counters
        self._trip_streak = 0
        return kept + rerun

    def _maybe_escalate_ingest(self) -> None:
        """Grow the ingestion guard's policy when a batch tripped an ingest
        loss counter (late drops grow the grace, evictions the buffer
        depth).  Forward only: the dropped records are already
        dead-lettered.  The widened policy is pinned by a snapshot."""
        guard = getattr(self.processor, "_guard", None)
        if guard is None:
            return
        counters = self._ingest_loss_counters()
        base = self._ingest_base
        if base is None:
            base = {k: 0 for k in counters}
        tripped = positive_delta(counters, base)
        self._ingest_base = counters
        if not tripped:
            return
        new_policy = sizing.escalate_ingest(guard.policy, tripped, growth=self._policy.growth)
        if new_policy is None:
            logger.warning("ingest loss %s but the guard policy cannot grow; records remain "
                           "in the dead-letter queue", tripped)
            return
        old = guard.policy
        guard.policy = new_policy
        self.ingest_escalations += 1
        logger.warning("ingest escalation #%d: grace_ms %d -> %d, reorder_depth %d -> %d "
                       "after loss %s (already-dropped records stay in the dead-letter "
                       "queue)", self.ingest_escalations, old.grace_ms, new_policy.grace_ms,
                       old.reorder_depth, new_policy.reorder_depth, tripped)
        try:
            # Pipeline-flush matches go to the caller through _unclaimed.
            self._unclaimed.extend(self.checkpoint())
        except Exception:
            self.checkpoint_failures += 1
            logger.exception("post-ingest-escalation checkpoint failed; a recovery before "
                             "the next good snapshot replays under the OLD ingest policy")

    # -- diagnostics --------------------------------------------------------

    def health(self) -> HealthReport:
        return check_health(self.processor)

    def metrics_snapshot(self, per_lane: bool = True) -> dict:
        """The processor's snapshot plus the supervisor's lifecycle
        telemetry: the event counts and their latency histograms (``phases``
        gains ``checkpoint``, ``recover``, ``escalate``, ``evacuate``,
        ``rebalance`` and ``replan``), the mesh's ``evacuations``,
        ``stragglers``, ``rebalances``, ``rebalance_failures`` and
        ``lanes_moved``, and
        the ``overload_*`` gauges under an ``overload_policy``."""
        out = self.processor.metrics_snapshot(per_lane=per_lane)
        out["recoveries"] = self.recoveries
        out["checkpoints"] = self.checkpoints
        out["checkpoint_failures"] = self.checkpoint_failures
        out["journal_failures"] = self.journal_failures
        out["escalations"] = self.escalations
        out["ingest_escalations"] = self.ingest_escalations
        out["evacuations"] = self.evacuations
        out["rebalances"] = self.rebalances
        out["rebalance_failures"] = self.rebalance_failures
        out["replans"] = self.replans
        out["replan_failures"] = self.replan_failures
        out["lanes_moved"] = self.lanes_moved
        out["stragglers"] = self.stragglers
        if self.flight is not None:
            out["flight_dumps"] = self.flight.dumps
        if self._overload is not None:
            # The cep_overload_level, _pressure, _transitions and
            # _transition_failures gauges.
            out.update(self._overload.metrics())
        out["retry_backoff_ms_total"] = round(self.retry_backoff_ms_total, 3)
        phases = dict(out.get("phases") or {})
        phases.update({name[len("phase."):]: inst.snapshot()
                       for name, inst in self.telemetry.items()
                       if name.startswith("phase.")})
        out["phases"] = phases
        return out
