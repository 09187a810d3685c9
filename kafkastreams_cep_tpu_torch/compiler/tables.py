"""Stage graph -> dense transition tables for the array engine.

Lowers the object graph produced by :func:`compile_pattern` (the exact
``pattern/StatesFactory.java:41-119`` semantics) into fixed-shape numpy
arrays the device NFA step consumes:

* **Node enumeration.** The compiled stage *list* excludes ONE_OR_MORE Kleene
  loop stages — ``buildState`` returns only the mandatory entry state and the
  loop stage is reachable solely through its BEGIN edge
  (``StatesFactory.java:110-118``).  Nodes are therefore enumerated by DFS
  preorder over edge targets starting from the BEGIN-typed stage, which
  yields ``[begin, ..., $final]`` in chain order.
* **Identity.** Stage equality in the reference is ``(name, type)`` only
  (``Stage.java:116-127``); two positions can share an identity (a
  mid-pattern ONE_OR_MORE mandatory state and its loop stage).  ``ident[s]``
  is the canonical (first) position with the same ``(name, type)`` — the
  engine compares identities, not positions, wherever the reference calls
  ``Stage.equals`` (e.g. the PROCEED version rule, ``NFA.java:185``).
* **Edges.** Per position: at most one consuming edge (BEGIN or TAKE,
  ``StatesFactory.java:80-81``), one IGNORE, one PROCEED.  IGNORE edges on
  BEGIN-typed stages are dropped, mirroring the oracle's documented
  deviation (begin re-seed subsumes them; ``nfa/oracle.py``).
* **Predicates** are deduplicated by object identity into a dispatch list;
  the tables store predicate ids.
* **Aggregates** become a flat list of ``(stage, state, fn)`` triples so the
  engine can apply folds in the reference's per-stage declaration order
  (``NFA.java:260-265``).

Everything here is host-side numpy; the engine moves the tables to the
device once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np

from kafkastreams_cep_tpu_torch.compiler.stages import (
    EdgeOperation,
    Stage,
    StageType,
    compile_pattern,
)
from kafkastreams_cep_tpu_torch.pattern.pattern import Pattern
from kafkastreams_cep_tpu_torch.pattern.predicate import Matcher

# Stage type codes.
TYPE_BEGIN = 0
TYPE_NORMAL = 1
TYPE_FINAL = 2

_TYPE_CODE = {
    StageType.BEGIN: TYPE_BEGIN,
    StageType.NORMAL: TYPE_NORMAL,
    StageType.FINAL: TYPE_FINAL,
}

# Consuming-op codes.
OP_NONE = 0
OP_BEGIN = 1
OP_TAKE = 2


@dataclasses.dataclass(frozen=True)
class AggSlot:
    """One fold registration: stage position, state index, fold fn."""

    stage: int
    state: int
    fn: Callable
    name: str


def stackable(tables) -> bool:
    """Whether these compiled queries share a stackable table shape —
    the single source of truth for ``_build_step``'s stacked mode and
    ``parallel/stacked.py``."""
    t0 = tables[0]
    return all(
        t.num_stages == t0.num_stages
        and t.max_hops == t0.max_hops
        and int(t.begin_pos) == int(t0.begin_pos)
        and int(t.final_pos) == int(t0.final_pos)
        for t in tables[1:]
    )


@dataclasses.dataclass
class TransitionTables:
    """Dense NFA tables, position-indexed in chain order ``[begin .. $final]``."""

    stages: List[Stage]
    names: List[str]
    types: np.ndarray  # [S] int32 — TYPE_* codes
    ident: np.ndarray  # [S] int32 — canonical (name, type) position
    window_ms: np.ndarray  # [S] int64 — -1 when unset
    consume_op: np.ndarray  # [S] int32 — OP_* codes
    consume_pred: np.ndarray  # [S] int32 — predicate id, -1 absent
    consume_target: np.ndarray  # [S] int32 — eval position of the consuming
    #   successor: self for TAKE (eps(current, current)), edge target for BEGIN
    ignore_pred: np.ndarray  # [S] int32 — -1 absent
    proceed_pred: np.ndarray  # [S] int32 — -1 absent
    proceed_target: np.ndarray  # [S] int32 — -1 absent
    predicates: List[Matcher]  # predicate dispatch list (P entries)
    state_names: List[str]  # fold-state names, first-appearance order
    state_inits: List  # declared init per state name
    state_dtypes: List[str]  # "int32" | "float32" per state name
    aggs: List[AggSlot]  # flat fold list, per-stage declaration order
    begin_pos: int
    final_pos: int
    max_hops: int  # longest PROCEED chain (frames per run per event)
    can_branch: bool  # any branching op-pair statically reachable

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def num_predicates(self) -> int:
        return len(self.predicates)

    @property
    def num_states(self) -> int:
        return len(self.state_names)

    def agg_masks(self) -> np.ndarray:
        """[NA, S] bool — which stage owns each agg slot (engine convenience)."""
        mask = np.zeros((len(self.aggs), len(self.stages)), dtype=bool)
        for i, agg in enumerate(self.aggs):
            mask[i, agg.stage] = True
        return mask

    def is_strict_seq(self) -> bool:
        """True for the branch-free fragment (all cardinality ONE, strict
        contiguity, no folds) that the data-parallel stencil matcher handles."""
        # can_branch already covers any IGNORE edge, so no separate clause.
        return (
            not self.can_branch
            and not self.aggs
            and not np.any(self.consume_op == OP_TAKE)
        )


def _enumerate_nodes(compiled: List[Stage]) -> List[Stage]:
    """DFS preorder over edge targets from the BEGIN-typed stage.

    Follows edges in declaration order, which for this compiler's output
    (a linear chain with self-loops) produces ``[begin, ..., $final]``.
    """
    begins = [s for s in compiled if s.type is StageType.BEGIN]
    if len(begins) != 1:
        raise ValueError(f"expected exactly one BEGIN stage, got {len(begins)}")
    order: List[Stage] = []
    seen: set = set()

    def visit(stage: Stage) -> None:
        if id(stage) in seen:
            return
        seen.add(id(stage))
        order.append(stage)
        for edge in stage.edges:
            if edge.target is not None:
                visit(edge.target)

    visit(begins[0])
    for stage in compiled:
        if id(stage) not in seen:  # pragma: no cover - defensive; chain is connected
            visit(stage)
    return order


def lower(pattern_or_stages) -> TransitionTables:
    """Lower a :class:`Pattern` (or pre-compiled stage list) to dense tables."""
    if isinstance(pattern_or_stages, Pattern):
        compiled = compile_pattern(pattern_or_stages)
    else:
        compiled = list(pattern_or_stages)

    nodes = _enumerate_nodes(compiled)
    pos: Dict[int, int] = {id(s): i for i, s in enumerate(nodes)}
    S = len(nodes)

    names = [s.name for s in nodes]
    types = np.array([_TYPE_CODE[s.type] for s in nodes], dtype=np.int32)
    window_ms = np.array([s.window_ms for s in nodes], dtype=np.int64)

    ident = np.zeros(S, dtype=np.int32)
    first_by_identity: Dict[Tuple[str, StageType], int] = {}
    for i, s in enumerate(nodes):
        key = (s.name, s.type)
        ident[i] = first_by_identity.setdefault(key, i)

    predicates: List[Matcher] = []
    pred_ids: Dict[int, int] = {}

    def pred_id(matcher: Matcher) -> int:
        existing = pred_ids.get(id(matcher))
        if existing is not None:
            return existing
        predicates.append(matcher)
        pred_ids[id(matcher)] = len(predicates) - 1
        return len(predicates) - 1

    consume_op = np.zeros(S, dtype=np.int32)
    consume_pred = np.full(S, -1, dtype=np.int32)
    consume_target = np.full(S, -1, dtype=np.int32)
    ignore_pred = np.full(S, -1, dtype=np.int32)
    proceed_pred = np.full(S, -1, dtype=np.int32)
    proceed_target = np.full(S, -1, dtype=np.int32)

    state_names: List[str] = []
    state_inits: List = []
    state_dtypes: List[str] = []
    aggs: List[AggSlot] = []

    for i, stage in enumerate(nodes):
        for agg in stage.aggregates:
            if agg.name not in state_names:
                state_names.append(agg.name)
                state_inits.append(agg.init)
                state_dtypes.append(agg.resolved_dtype)
            elif state_dtypes[state_names.index(agg.name)] != agg.resolved_dtype:
                raise ValueError(
                    f"fold state {agg.name!r} declared with conflicting "
                    f"dtypes across stages"
                )
            aggs.append(AggSlot(i, state_names.index(agg.name), agg.fn, agg.name))

        for edge in stage.edges:
            if edge.op is EdgeOperation.BEGIN:
                if consume_op[i] != OP_NONE:
                    raise ValueError(f"stage {stage.name!r}: multiple consuming edges")
                consume_op[i] = OP_BEGIN
                consume_pred[i] = pred_id(edge.matcher)
                consume_target[i] = pos[id(edge.target)]
            elif edge.op is EdgeOperation.TAKE:
                if consume_op[i] != OP_NONE:
                    raise ValueError(f"stage {stage.name!r}: multiple consuming edges")
                consume_op[i] = OP_TAKE
                consume_pred[i] = pred_id(edge.matcher)
                # TAKE successors self-loop via eps(current, current)
                # (NFA.java:196); the edge's declared target is not the
                # successor's eval position.
                consume_target[i] = i
            elif edge.op is EdgeOperation.IGNORE:
                if stage.type is StageType.BEGIN:
                    # Deviation (shared with the oracle): begin-stage IGNORE
                    # edges are subsumed by the begin re-seed.
                    continue
                if ignore_pred[i] != -1:
                    raise ValueError(f"stage {stage.name!r}: multiple IGNORE edges")
                ignore_pred[i] = pred_id(edge.matcher)
            elif edge.op is EdgeOperation.PROCEED:
                if proceed_pred[i] != -1:
                    raise ValueError(f"stage {stage.name!r}: multiple PROCEED edges")
                proceed_pred[i] = pred_id(edge.matcher)
                proceed_target[i] = pos[id(edge.target)]

    finals = np.flatnonzero(types == TYPE_FINAL)
    if len(finals) != 1:
        raise ValueError(f"expected exactly one FINAL stage, got {len(finals)}")
    final_pos = int(finals[0])
    begin_pos = 0  # DFS starts at the begin stage

    # Longest PROCEED chain: frames visited by one run in one event.
    hops = np.ones(S, dtype=np.int64)
    for i in range(S - 1, -1, -1):  # proceed targets are later in chain order
        t = proceed_target[i]
        if t >= 0:
            if t <= i:
                raise ValueError("PROCEED edge does not advance the chain")
            hops[i] = 1 + hops[t]
    max_hops = int(hops.max())

    # Branching requires one of the op pairs {P,T} {I,T} {I,B} {I,P}
    # (NFA.java:280-289) to be matchable at a single stage.
    has_ignore = ignore_pred >= 0
    has_proceed = proceed_pred >= 0
    can_branch = bool(
        np.any(has_ignore) or np.any((consume_op == OP_TAKE) & has_proceed)
    )

    return TransitionTables(
        stages=nodes,
        names=names,
        types=types,
        ident=ident,
        window_ms=window_ms,
        consume_op=consume_op,
        consume_pred=consume_pred,
        consume_target=consume_target,
        ignore_pred=ignore_pred,
        proceed_pred=proceed_pred,
        proceed_target=proceed_target,
        predicates=predicates,
        state_names=state_names,
        state_inits=state_inits,
        state_dtypes=state_dtypes,
        aggs=aggs,
        begin_pos=begin_pos,
        final_pos=final_pos,
        max_hops=max_hops,
        can_branch=can_branch,
    )
