# Frozen copy of kafkastreams_cep_tpu_torch/compiler/stages.py
# at commit 6531974 (the port's host oracle and its front end), imports
# rewritten to this folder: the benchmark's plain reference.  Do not edit
# it to follow the program: it is the yardstick.
"""Pattern -> NFA stage-graph compiler.

Reproduces the SASE+ compilation scheme of ``pattern/StatesFactory.java``
exactly:

* a synthetic ``$final`` FINAL stage is appended (``StatesFactory.java:46-47``),
* one NORMAL stage per pattern stage, walking the ancestor chain backward,
  with the BEGIN stage last (``StatesFactory.java:52-60``),
* the consuming edge is BEGIN for cardinality ONE, TAKE otherwise
  (``StatesFactory.java:80-81``),
* IGNORE edge: ``true`` for skip-till-any-match, ``not(take)`` for
  skip-till-next-match, absent for strict contiguity
  (``StatesFactory.java:87-96``),
* TAKE stages get a PROCEED edge guarded by
  ``successor_predicate or not(take)`` (strict) /
  ``successor_predicate or (not(take) and not(ignore))`` (skip)
  (``StatesFactory.java:98-107``),
* ONE_OR_MORE prepends a mandatory same-named state with a single BEGIN edge
  (``StatesFactory.java:70-72,110-116``),
* window length is pushed onto stages, inherited from the successor pattern
  when unset (``StatesFactory.java:75-76,121-127``).

Stage equality is ``(name, type)`` only (``Stage.java:116-127``): epsilon
wrappers compare equal to their base stage, which the PROCEED version rule in
the engine depends on (``NFA.java:185``).
"""

from __future__ import annotations

import enum
from typing import List, Optional

from portbench.reference.aggregator import StateAggregator
from portbench.reference.pattern import Cardinality, Pattern, SelectStrategy
from portbench.reference.predicate import Matcher, and_, not_, or_, true_


class StageType(enum.Enum):
    BEGIN = "begin"
    NORMAL = "normal"
    FINAL = "final"


class EdgeOperation(enum.IntEnum):
    """Edge semantics as documented at ``nfa/EdgeOperation.java:20-41``.

    BEGIN   forward edge: consume the event and buffer it.
    TAKE    looping edge: consume the event and buffer it.
    PROCEED forward edge without consuming.
    IGNORE  looping edge without consuming (selection-strategy dependent).
    """

    BEGIN = 0
    TAKE = 1
    PROCEED = 2
    IGNORE = 3


class Edge:
    __slots__ = ("op", "matcher", "target")

    def __init__(self, op: EdgeOperation, matcher: Matcher, target: Optional["Stage"]):
        if matcher is None:
            raise ValueError("edge predicate cannot be None")
        self.op = op
        self.matcher = matcher
        self.target = target

    def matches(self, key, value, timestamp, states) -> bool:
        return self.matcher(key, value, timestamp, states)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        tgt = self.target.name if self.target is not None else None
        return f"Edge({self.op.name}->{tgt}:{self.matcher.label})"


class Stage:
    """A compiled NFA node; equality is (name, type) only (Stage.java:116-127)."""

    def __init__(self, name: str, type: StageType):
        self.name = name
        self.type = type
        self.window_ms: int = -1
        self.aggregates: List[StateAggregator] = []
        self.edges: List[Edge] = []

    @staticmethod
    def epsilon(current: "Stage", target: "Stage") -> "Stage":
        """An always-true PROCEED wrapper carrying ``current``'s identity
        (Stage.java:42-46)."""
        stage = Stage(current.name, current.type)
        stage.add_edge(Edge(EdgeOperation.PROCEED, true_(), target))
        return stage

    def add_edge(self, edge: Edge) -> "Stage":
        self.edges.append(edge)
        return self

    def is_begin(self) -> bool:
        return self.type is StageType.BEGIN

    def is_final(self) -> bool:
        return self.type is StageType.FINAL

    def is_epsilon(self) -> bool:
        return len(self.edges) == 1 and self.edges[0].op is EdgeOperation.PROCEED

    def target_by_op(self, op: EdgeOperation) -> Optional["Stage"]:
        target = None
        for edge in self.edges:
            if edge.op is op:
                target = edge.target
        return target

    def state_names(self) -> List[str]:
        return [agg.name for agg in self.aggregates]

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Stage):
            return NotImplemented
        return self.name == other.name and self.type is other.type

    def __hash__(self) -> int:
        return hash((self.name, self.type))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Stage({self.name}:{self.type.name}, edges={self.edges})"


FINAL_STAGE_NAME = "$final"


def compile_pattern(pattern: Pattern) -> List[Stage]:
    """Compile a pattern chain to stages ordered ``[$final, ..., begin]``
    like ``StatesFactory.make`` (``StatesFactory.java:41-63``)."""
    if pattern is None:
        raise ValueError("cannot compile a null pattern")

    sequence: List[Stage] = []
    successor_stage = Stage(FINAL_STAGE_NAME, StageType.FINAL)
    sequence.append(successor_stage)

    successor_pattern: Optional[Pattern] = None
    current = pattern
    while current.ancestor is not None:
        successor_stage = _build_stage(
            StageType.NORMAL, current, successor_stage, successor_pattern
        )
        sequence.append(successor_stage)
        successor_pattern = current
        current = current.ancestor

    sequence.append(_build_stage(StageType.BEGIN, current, successor_stage, successor_pattern))
    return sequence


def _build_stage(
    type: StageType,
    current: Pattern,
    successor_stage: Stage,
    successor_pattern: Optional[Pattern],
) -> Stage:
    # StatesFactory.buildState (StatesFactory.java:65-119).
    cardinality = current.cardinality
    has_mandatory = cardinality is Cardinality.ONE_OR_MORE
    if type is StageType.BEGIN and cardinality in (
        Cardinality.OPTIONAL,
        Cardinality.ZERO_OR_MORE,
    ):
        # The reference crashes at runtime on this shape (a first-stage
        # TAKE+PROCEED branch reaches newEpsilonState(null, ...) at
        # NFA.java:236); reject it at compile time instead.
        raise ValueError(
            f"stage {current.name!r}: the first pattern stage cannot be "
            "optional/zero_or_more (use one_or_more or cardinality ONE)"
        )
    current_type = StageType.NORMAL if has_mandatory else type

    stage = Stage(current.name, current_type)
    window_ms = _window_ms(current, successor_pattern)
    stage.window_ms = window_ms
    stage.aggregates = current.aggregates

    predicate = current.predicate
    if predicate is None:
        raise ValueError(f"pattern stage {current.name!r} has no predicate")

    op = EdgeOperation.BEGIN if cardinality is Cardinality.ONE else EdgeOperation.TAKE
    stage.add_edge(Edge(op, predicate, successor_stage))

    strategy = current.strategy
    ignore: Optional[Matcher] = None
    if strategy is SelectStrategy.SKIP_TIL_ANY_MATCH:
        ignore = true_()
        stage.add_edge(Edge(EdgeOperation.IGNORE, ignore, None))
    if strategy is SelectStrategy.SKIP_TIL_NEXT_MATCH:
        ignore = not_(predicate)
        stage.add_edge(Edge(EdgeOperation.IGNORE, ignore, None))

    if op is EdgeOperation.TAKE:
        # proceed = successor_begin or (not take [and not ignore])
        # (StatesFactory.java:98-107).  The reference dereferences
        # successorPattern unconditionally here, so a Kleene/optional *last*
        # stage is unsupported (latent NPE at StatesFactory.java:102); we make
        # the constraint explicit.
        if successor_pattern is None:
            raise ValueError(
                f"stage {current.name!r}: a pattern's last stage must have "
                "cardinality ONE (the reference compiler has the same constraint)"
            )
        if strategy is SelectStrategy.STRICT_CONTIGUITY:
            proceed = or_(successor_pattern.predicate, not_(predicate))
        else:
            proceed = or_(successor_pattern.predicate, and_(not_(predicate), not_(ignore)))
        stage.add_edge(Edge(EdgeOperation.PROCEED, proceed, successor_stage))

    if has_mandatory:
        # ONE_OR_MORE: a required same-named entry state precedes the Kleene
        # loop (StatesFactory.java:110-116).
        successor_stage = stage
        stage = Stage(current.name, type)
        stage.add_edge(Edge(EdgeOperation.BEGIN, current.predicate, successor_stage))
        stage.window_ms = window_ms
        stage.aggregates = current.aggregates

    return stage


def _window_ms(current: Pattern, successor: Optional[Pattern]) -> int:
    # Window inheritance from the successor pattern (StatesFactory.java:121-127).
    if current.window_time_ms is not None:
        return current.window_time_ms
    if successor is not None and successor.window_time_ms is not None:
        return successor.window_time_ms
    return -1
