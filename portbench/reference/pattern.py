# Frozen copy of kafkastreams_cep_tpu_torch/pattern/pattern.py
# at commit 6531974 (the port's host oracle and its front end), imports
# rewritten to this folder: the benchmark's plain reference.  Do not edit
# it to follow the program: it is the yardstick.
"""The pattern model: a linked chain of pattern stages.

Mirrors ``pattern/Pattern.java``: each stage holds a (AND-composed) predicate,
a cardinality, an event-selection strategy, an optional time window, and a
list of fold aggregates; stages link child -> ancestor
(``Pattern.java:102-104,176-178``), and unnamed stages default their name to
the level number (``Pattern.java:160-162``).
"""

from __future__ import annotations

import enum
from typing import Any, Callable, List, Optional

from portbench.reference.aggregator import StateAggregator
from portbench.reference.predicate import Matcher, and_


class Cardinality(enum.Enum):
    # Values as in Pattern.java:27-42.
    ZERO_OR_MORE = -2
    ONE_OR_MORE = -1
    OPTIONAL = 0
    ONE = 1


class SelectStrategy(enum.Enum):
    # Pattern.java:44-57.
    STRICT_CONTIGUITY = "strict_contiguity"
    SKIP_TIL_NEXT_MATCH = "skip_till_next_match"
    SKIP_TIL_ANY_MATCH = "skip_till_any_match"


_UNIT_MS = {
    "ms": 1,
    "milliseconds": 1,
    "s": 1000,
    "seconds": 1000,
    "m": 60_000,
    "minutes": 60_000,
    "h": 3_600_000,
    "hours": 3_600_000,
    "d": 86_400_000,
    "days": 86_400_000,
}


def to_millis(time: float, unit: str) -> int:
    try:
        return int(time * _UNIT_MS[unit.lower()])
    except KeyError:
        raise ValueError(f"unknown time unit {unit!r}; use one of {sorted(_UNIT_MS)}")


class Pattern:
    """One stage of a sequence pattern, linked to its ancestor."""

    def __init__(self, name: Optional[str] = None, ancestor: Optional["Pattern"] = None):
        self.level: int = ancestor.level + 1 if ancestor is not None else 0
        self._name = name
        self.ancestor = ancestor
        self.predicate: Optional[Matcher] = None
        self.window_time_ms: Optional[int] = None
        self.strategy: SelectStrategy = SelectStrategy.STRICT_CONTIGUITY
        self.cardinality: Cardinality = Cardinality.ONE
        self.aggregates: List[StateAggregator] = []

    # -- mutation used by the builders ---------------------------------
    def add_predicate(self, matcher) -> None:
        # AND-composition like Pattern.java:145-150.
        matcher = matcher if isinstance(matcher, Matcher) else Matcher(matcher)
        self.predicate = matcher if self.predicate is None else and_(self.predicate, matcher)

    def add_aggregator(self, agg: StateAggregator) -> None:
        self.aggregates.append(agg)

    def set_window(self, time: float, unit: str = "ms") -> None:
        self.window_time_ms = to_millis(time, unit)

    # -- accessors ------------------------------------------------------
    @property
    def name(self) -> str:
        # Unnamed stages take their level number (Pattern.java:160-162).
        return self._name if self._name is not None else str(self.level)

    def chain(self) -> List["Pattern"]:
        """The full pattern, newest stage first (Pattern.java:187-210)."""
        out, cur = [], self
        while cur is not None:
            out.append(cur)
            cur = cur.ancestor
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Pattern({self.name}, card={self.cardinality.name}, "
            f"strategy={self.strategy.name}, window={self.window_time_ms})"
        )
