# Frozen copy of kafkastreams_cep_tpu_torch/nfa/oracle.py
# at commit 6531974 (the port's host oracle and its front end), imports
# rewritten to this folder: the benchmark's plain reference.  Do not edit
# it to follow the program: it is the yardstick.
"""Host oracle NFA engine — the conformance reference.

A faithful reimplementation of the reference evaluator (``nfa/NFA.java``) used
as (a) the behavioral oracle the array engine is differentially tested
against, and (b) a host fallback path.  A copy of the JAX package's
``kafkastreams_cep_tpu/nfa/oracle.py`` over this package's front end, so
the port's benchmarks and tests reach the oracle without the JAX package.

Per-event semantics preserved:

* one pass over a snapshot of the run queue per event; runs created during the
  event are not evaluated until the next event (``NFA.java:94-109``);
* window pruning before evaluation, skipped for BEGIN-typed runs
  (``NFA.java:143-144``, ``ComputationStage.java:98-100``);
* the begin state is re-added on every event so new runs can start, with the
  version bumped only when the event also progressed a match
  (``NFA.java:148-157``);
* edge dispatch: PROCEED recurses into the target stage appending a stage
  digit when crossing into a new stage off a non-branching run
  (``NFA.java:182-190``); TAKE re-adds a self-loop epsilon run and buffers the
  event (``NFA.java:191-209``); BEGIN buffers the event and advances
  (``NFA.java:210-222``); IGNORE re-adds the run unchanged
  (``NFA.java:223-227``);
* nondeterministic branching when the matched-op set contains {PROCEED,TAKE},
  {IGNORE,TAKE}, {IGNORE,BEGIN} or {IGNORE,PROCEED} (``NFA.java:280-289``):
  the branch run gets ``version.add_run()`` and a fresh run id, fold state is
  copied to the new run, and refcounts along the old path are incremented
  (``NFA.java:231-246``);
* folds evaluate only when the event was consumed, after edge evaluation
  (``NFA.java:248,260-265``);
* dead runs remove their buffer path; completed matches are extracted via
  ``buffer.remove`` per final state (``NFA.java:102-123``).

Preserved quirk: a run whose stage *type* is BEGIN takes the **current**
event's timestamp as the window start (``NFA.java:347-349``), so for patterns
whose first stage has cardinality ONE the window effectively starts at the
second event.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from portbench.reference.stages import (
    Edge,
    EdgeOperation,
    Stage,
    StageType,
    compile_pattern,
)
from portbench.reference.buffer import SharedVersionedBuffer
from portbench.reference.dewey import DeweyVersion
from portbench.reference.pattern import Pattern
from portbench.reference.events import Event, Sequence


@dataclasses.dataclass
class Run:
    """One live run of the NFA (``nfa/ComputationStage.java:31-53``)."""

    stage: Stage
    version: DeweyVersion
    event: Optional[Event] = None
    start_ts: int = -1
    seq: int = 1
    branching: bool = False

    def with_version(self, version: DeweyVersion) -> "Run":
        # setVersion clears the branching flag (ComputationStage.java:76-84).
        return Run(self.stage, version, self.event, self.start_ts, self.seq)

    def is_begin(self) -> bool:
        return self.stage.is_begin()

    def is_out_of_window(self, ts: int) -> bool:
        return self.stage.window_ms != -1 and (ts - self.start_ts) > self.stage.window_ms

    def is_forwarding(self) -> bool:
        return self.stage.is_epsilon()

    def is_forwarding_to_final(self) -> bool:
        return self.is_forwarding() and self.stage.edges[0].target.is_final()


class StatesView:
    """Read-only fold-state view handed to predicates
    (``pattern/States.java:46-68``)."""

    __slots__ = ("_nfa", "_seq")

    def __init__(self, nfa: "OracleNFA", seq: int):
        self._nfa = nfa
        self._seq = seq

    def get(self, name: str):
        return self._nfa._get_state(name, self._seq)

    def get_or_else(self, name: str, default):
        value = self._nfa._get_state(name, self._seq)
        return default if value is None else value

    def __getitem__(self, name: str):
        return self.get(name)


@dataclasses.dataclass(frozen=True)
class _Ctx:
    key: Any
    value: Any
    ts: int
    event: Event
    run: Run

    def first_ts(self) -> int:
        # NFA.java:347-349 — BEGIN-typed runs reset the window start.
        return self.ts if self.run.stage.type is StageType.BEGIN else self.run.start_ts

    def with_run(self, run: Run) -> "_Ctx":
        return _Ctx(self.key, self.value, self.ts, self.event, run)


_BRANCH_OP_SETS = (
    {EdgeOperation.PROCEED, EdgeOperation.TAKE},
    {EdgeOperation.IGNORE, EdgeOperation.TAKE},
    {EdgeOperation.IGNORE, EdgeOperation.BEGIN},
    {EdgeOperation.IGNORE, EdgeOperation.PROCEED},
)


class OracleNFA:
    """Single-partition host NFA over compiled stages."""

    def __init__(
        self,
        stages: List[Stage],
        buffer: Optional[SharedVersionedBuffer] = None,
        enforce_windows: bool = False,
    ):
        # ``enforce_windows`` mirrors ``EngineConfig.enforce_windows``: the
        # documented deviation that prunes runs by the *evaluation* stage's
        # window (the epsilon wrapper's PROCEED target), where the faithful
        # default reproduces the reference's quirk that epsilon wrappers
        # drop ``windowMs`` (``Stage.java:41-46``) so ``within()`` never
        # actually prunes.
        self.enforce_windows = bool(enforce_windows)
        self.stages = stages
        self.buffer = buffer if buffer is not None else SharedVersionedBuffer()
        self.runs: Deque[Run] = deque(
            Run(stage=s, version=DeweyVersion(1), seq=1) for s in stages if s.is_begin()
        )
        self._run_counter = 1
        self._offset_counter = 0
        # Per-run fold state: (state name, run id) -> value.
        self._agg_state: Dict[Tuple[str, int], Any] = {}
        # Declared init per state name (see pattern/aggregator.py deviation note).
        self._state_inits: Dict[str, Any] = {}
        # Typed fold state (the Aggregator<K,V,T> analog): the oracle
        # mirrors the array engine's storage casts exactly — int32 states
        # truncate toward zero and wrap, float32 states round to IEEE
        # single — so engine/oracle parity holds for every fold result.
        self._state_dtypes: Dict[str, str] = {}
        for stage in stages:
            for agg in stage.aggregates:
                self._state_inits.setdefault(agg.name, agg.init)
                self._state_dtypes.setdefault(agg.name, agg.resolved_dtype)

    @classmethod
    def from_pattern(
        cls, pattern: Pattern, enforce_windows: bool = False
    ) -> "OracleNFA":
        return cls(compile_pattern(pattern), enforce_windows=enforce_windows)

    # ------------------------------------------------------------------
    # fold state
    # ------------------------------------------------------------------
    def _get_state(self, name: str, seq: int):
        return self._agg_state.get((name, seq), self._state_inits.get(name))

    def _set_state(self, name: str, seq: int, value) -> None:
        if self._state_dtypes.get(name) == "float32":
            value = float(np.float32(value))
        else:
            v = int(value)  # truncate toward zero, like jnp int32 cast
            value = ((v + 2**31) % 2**32) - 2**31
        self._agg_state[(name, seq)] = value

    def _branch_state(self, name: str, seq: int, new_seq: int) -> None:
        # Copy-on-branch (ValueStore.java:92-97): only copies a present value.
        if (name, seq) in self._agg_state:
            self._agg_state[(name, new_seq)] = self._agg_state[(name, seq)]

    def _next_run_id(self) -> int:
        self._run_counter += 1
        return self._run_counter

    # ------------------------------------------------------------------
    # per-event stepping
    # ------------------------------------------------------------------
    def match(
        self,
        key: Any,
        value: Any,
        timestamp: int,
        topic: str = "test",
        partition: int = 0,
        offset: Optional[int] = None,
    ) -> List[Sequence]:
        """Process one event; returns completed matches (``NFA.java:94-109``).

        ``offset`` is the event identity within ``(topic, partition)``
        (``Event.java:56-69``); when omitted, a monotonic per-NFA counter is
        used so successive calls never collide.
        """
        if offset is None:
            offset = self._offset_counter
        self._offset_counter = max(self._offset_counter, offset + 1)
        event = Event(key, value, timestamp, topic, partition, offset)
        ctx_base = dict(key=key, value=value, ts=timestamp, event=event)

        finals: List[Run] = []
        for _ in range(len(self.runs)):
            run = self.runs.popleft()
            successors = self._match_one(_Ctx(run=run, **ctx_base))
            if not successors:
                self._remove_pattern(run)
            else:
                finals.extend(r for r in successors if r.is_forwarding_to_final())
            self.runs.extend(r for r in successors if not r.is_forwarding_to_final())
        matches = [self.buffer.remove(r.stage, r.event, r.version) for r in finals]
        # Fold state is keyed (name, run id); drop entries for dead runs so
        # state does not grow for the NFA's lifetime (the reference has the
        # same leak, but its stores are RocksDB-backed).
        live = {r.seq for r in self.runs}
        for key_seq in [k for k in self._agg_state if k[1] not in live]:
            del self._agg_state[key_seq]
        return matches

    def _remove_pattern(self, run: Run) -> None:
        if run.event is not None:
            self.buffer.remove(run.stage, run.event, run.version)

    def _enforced_out_of_window(self, run: Run, ts: int) -> bool:
        """The engine's ``enforce_windows`` rule (engine/matcher.py): prune
        by the evaluation stage's window; BEGIN-typed runs are exempt (their
        window start resets to the current event, ``NFA.java:347-349``)."""
        if run.is_begin():
            return False
        eval_stage = (
            run.stage.edges[0].target if run.stage.is_epsilon() else run.stage
        )
        w = eval_stage.window_ms
        return w != -1 and (ts - run.start_ts) > w

    def _match_one(self, ctx: _Ctx) -> List[Run]:
        run = ctx.run
        if not run.is_begin() and run.is_out_of_window(ctx.ts):
            return []
        if self.enforce_windows and self._enforced_out_of_window(run, ctx.ts):
            return []
        successors = self._evaluate(ctx, run.stage, None)
        if run.is_begin() and not run.is_forwarding():
            # Re-seed so a new run can start on every event (NFA.java:148-157).
            version = run.version if not successors else run.version.add_run()
            successors.append(Run(stage=run.stage, version=version, seq=self._next_run_id()))
        return successors

    def _matched_edges(self, ctx: _Ctx, stage: Stage, seq: int) -> List[Edge]:
        states = StatesView(self, seq)
        return [
            e for e in stage.edges if bool(e.matches(ctx.key, ctx.value, ctx.ts, states))
        ]

    @staticmethod
    def _is_branching(edges: List[Edge]) -> bool:
        ops = {e.op for e in edges}
        return any(s <= ops for s in _BRANCH_OP_SETS)

    def _evaluate(
        self, ctx: _Ctx, current: Stage, previous: Optional[Stage]
    ) -> List[Run]:
        """The hot loop (``NFA.java:162-250``)."""
        run = ctx.run
        seq_id = run.seq
        prev_event = run.event
        version = run.version

        matched = self._matched_edges(ctx, current, seq_id)
        if previous is None:
            # Begin-stage IGNORE edges are subsumed by the begin re-seed
            # (NFA.java:148-157): honoring them duplicates the begin run and
            # a begin-stage branch dereferences a null previous stage in the
            # reference (NFA.java:236).  Documented deviation: drop them.
            matched = [e for e in matched if e.op is not EdgeOperation.IGNORE]
        branching = self._is_branching(matched)
        cur_event = ctx.event
        start = ctx.first_ts()

        successors: List[Run] = []
        consumed = False
        ignored = False

        for edge in matched:
            if edge.op is EdgeOperation.PROCEED:
                next_ctx = ctx
                # Append a stage digit when crossing into a new stage off a
                # non-branching run (NFA.java:185-188).
                if edge.target != current and not run.branching:
                    next_ctx = ctx.with_run(run.with_version(version.add_stage()))
                successors.extend(self._evaluate(next_ctx, edge.target, current))
            elif edge.op is EdgeOperation.TAKE:
                if not branching:
                    successors.append(
                        Run(
                            stage=Stage.epsilon(current, current),
                            version=version,
                            event=cur_event,
                            start_ts=start,
                            seq=seq_id,
                        )
                    )
                    self._put(current, previous, prev_event, cur_event, version)
                else:
                    # On a branch the take is recorded under the bumped
                    # version; the surviving run comes from the branch block.
                    self._put(current, previous, prev_event, cur_event, version.add_run())
                consumed = True
            elif edge.op is EdgeOperation.BEGIN:
                self._put(current, previous, prev_event, cur_event, version)
                successors.append(
                    Run(
                        stage=Stage.epsilon(current, edge.target),
                        version=version,
                        event=cur_event,
                        start_ts=start,
                        seq=seq_id,
                    )
                )
                consumed = True
            elif edge.op is EdgeOperation.IGNORE:
                if not branching:
                    successors.append(run)
                ignored = True

        if branching:
            new_seq = self._next_run_id()
            latest_event = prev_event if ignored else cur_event
            successors.append(
                Run(
                    stage=Stage.epsilon(previous, current),
                    version=version.add_run(),
                    event=latest_event,
                    start_ts=start,
                    seq=new_seq,
                    branching=True,
                )
            )
            for agg in current.aggregates:
                self._branch_state(agg.name, seq_id, new_seq)
            self.buffer.branch(previous, prev_event, version)

        if consumed:
            for agg in current.aggregates:
                cur = self._get_state(agg.name, seq_id)
                self._set_state(agg.name, seq_id, agg.fn(ctx.key, ctx.value, cur))

        return successors

    def _put(
        self,
        current: Stage,
        previous: Optional[Stage],
        prev_event: Optional[Event],
        cur_event: Event,
        version: DeweyVersion,
    ) -> None:
        # NFA.putToSharedBuffer (NFA.java:252-257).
        if previous is not None:
            self.buffer.put(current, cur_event, previous, prev_event, version)
        else:
            self.buffer.put_first(current, cur_event, version)
