# Frozen copy of kafkastreams_cep_tpu_torch/pattern/query.py
# at commit 6531974 (the port's host oracle and its front end), imports
# rewritten to this folder: the benchmark's plain reference.  Do not edit
# it to follow the program: it is the yardstick.
"""Fluent query DSL.

Three-phase builder mirroring the reference
(``pattern/QueryBuilder.java``, ``SelectBuilder.java``,
``PredicateBuilder.java``)::

    query = (
        Query()
        .select("first").where(lambda k, v, ts, st: v == "A")
        .then()
        .select("second").one_or_more().skip_till_next_match()
            .where(lambda k, v, ts, st: v == "B")
            .fold("count", lambda k, v, cur: cur + 1, init=0)
        .then()
        .select("last").where(lambda k, v, ts, st: v == "C")
            .within(1, "h")
        .build()
    )
"""

from __future__ import annotations

from typing import Any, Optional

from portbench.reference.aggregator import StateAggregator
from portbench.reference.pattern import Cardinality, Pattern, SelectStrategy


class Query:
    """Entry point: ``Query().select([name])`` (QueryBuilder.java:28,37)."""

    def select(self, name: Optional[str] = None) -> "SelectBuilder":
        return SelectBuilder(Pattern(name))


# Alias matching the reference class name.
QueryBuilder = Query


class SelectBuilder:
    """Cardinality + selection strategy phase (SelectBuilder.java:26-59)."""

    def __init__(self, pattern: Pattern):
        self._pattern = pattern

    def optional(self) -> "SelectBuilder":
        self._pattern.cardinality = Cardinality.OPTIONAL
        return self

    def one_or_more(self) -> "SelectBuilder":
        self._pattern.cardinality = Cardinality.ONE_OR_MORE
        return self

    def zero_or_more(self) -> "SelectBuilder":
        self._pattern.cardinality = Cardinality.ZERO_OR_MORE
        return self

    def skip_till_next_match(self) -> "SelectBuilder":
        self._pattern.strategy = SelectStrategy.SKIP_TIL_NEXT_MATCH
        return self

    def skip_till_any_match(self) -> "SelectBuilder":
        self._pattern.strategy = SelectStrategy.SKIP_TIL_ANY_MATCH
        return self

    def strict_contiguity(self) -> "SelectBuilder":
        self._pattern.strategy = SelectStrategy.STRICT_CONTIGUITY
        return self

    def where(self, matcher) -> "PredicateBuilder":
        self._pattern.add_predicate(matcher)
        return PredicateBuilder(self._pattern)


class PredicateBuilder:
    """Predicates / folds / window phase (PredicateBuilder.java:34-55)."""

    def __init__(self, pattern: Pattern):
        self._pattern = pattern

    def and_(self, matcher) -> "PredicateBuilder":
        self._pattern.add_predicate(matcher)
        return self

    def fold(
        self, state: str, aggregator, init: Any = 0, dtype: Any = None
    ) -> "PredicateBuilder":
        self._pattern.add_aggregator(
            StateAggregator(state, aggregator, init, dtype)
        )
        return self

    def within(self, time: float, unit: str = "ms") -> "PredicateBuilder":
        self._pattern.set_window(time, unit)
        return self

    def then(self) -> "Query":
        """Start the next stage, linked to this one (PredicateBuilder.java:49-51)."""
        return _ChainedQuery(self._pattern)

    def build(self) -> Pattern:
        return self._pattern


class _ChainedQuery(Query):
    def __init__(self, ancestor: Pattern):
        self._ancestor = ancestor

    def select(self, name: Optional[str] = None) -> SelectBuilder:
        return SelectBuilder(Pattern(name, ancestor=self._ancestor))
