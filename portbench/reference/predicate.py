# Frozen copy of kafkastreams_cep_tpu_torch/pattern/predicate.py
# at commit 6531974 (the port's host oracle and its front end), imports
# rewritten to this folder: the benchmark's plain reference.  Do not edit
# it to follow the program: it is the yardstick.
"""Predicate algebra for pattern guards.

A matcher is a function ``(key, value, timestamp, states) -> bool`` — the same
signature as the reference's ``Matcher.matches`` (``pattern/Matcher.java:22``)
— plus the combinators ``not_``/``and_``/``or_``
(``pattern/Matcher.java:24-70``).

Matchers must be written as **tensor expressions**: the ``bool`` they
return may be a ``torch.bool`` tensor (one value per lane and run) when
evaluated inside the array engine, and a plain Python bool on the host.  ``states``
is a read-only view over the per-run fold state (see
``pattern/aggregator.py``); inside the array engine its values are
``[K, R]`` tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

MatcherFn = Callable[[Any, Any, Any, Any], Any]


class Matcher:
    """A named, composable guard over ``(key, value, timestamp, states)``.

    Combinator structure is recorded (``op``/``parts``) so compile-time
    passes can see through it: ``and_`` chains are commuting conjunct
    lists the tiering pass (``compiler/tiering.py``) may reorder by
    selectivity/cost without changing semantics.  ``cost_hint`` and
    ``selectivity_hint`` are optional user annotations consumed by that
    pass's static cost model (see :func:`hint`); neither affects what the
    matcher computes.
    """

    __slots__ = ("fn", "label", "op", "parts", "cost_hint", "selectivity_hint")

    def __init__(self, fn: MatcherFn, label: Optional[str] = None):
        if isinstance(fn, Matcher):
            fn, label = fn.fn, label or fn.label
        if not callable(fn):
            raise TypeError(f"matcher must be callable, got {type(fn)!r}")
        self.fn = fn
        self.label = label or getattr(fn, "__name__", "matcher")
        self.op: Optional[str] = None  # "and" | "or" | "not" for combinators
        self.parts: tuple = ()
        self.cost_hint: Optional[float] = None
        self.selectivity_hint: Optional[float] = None

    def __call__(self, key, value, timestamp, states):
        return self.fn(key, value, timestamp, states)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Matcher({self.label})"


def _wrap(m) -> Matcher:
    return m if isinstance(m, Matcher) else Matcher(m)


def _normalize(result):
    """Coerce plain host values to bool; leave tensor values alone.

    Bitwise ``~``/``&``/``|`` are the only operators bool tensors support,
    but they are wrong for plain truthy ints (``~1 == -2`` is truthy), so host
    scalars are normalized to ``bool`` first.
    """
    if isinstance(result, bool):
        return result
    if not hasattr(result, "shape") and not hasattr(result, "dtype"):
        # Any non-array host value (int, None, '', lists...): Python truth.
        # Only tensor values pass through to the bitwise path.
        return bool(result)
    return result


def not_(matcher) -> Matcher:
    m = _wrap(matcher)

    def fn(key, value, timestamp, states):
        result = _normalize(m(key, value, timestamp, states))
        return (not result) if isinstance(result, bool) else ~result

    out = Matcher(fn, label=f"not({m.label})")
    out.op, out.parts = "not", (m,)
    return out


def and_(left, right) -> Matcher:
    l, r = _wrap(left), _wrap(right)

    def fn(key, value, timestamp, states):
        lv = _normalize(l(key, value, timestamp, states))
        rv = _normalize(r(key, value, timestamp, states))
        if isinstance(lv, bool) and isinstance(rv, bool):
            return lv and rv
        return lv & rv

    out = Matcher(fn, label=f"and({l.label},{r.label})")
    out.op, out.parts = "and", (l, r)
    return out


def or_(left, right) -> Matcher:
    l, r = _wrap(left), _wrap(right)

    def fn(key, value, timestamp, states):
        lv = _normalize(l(key, value, timestamp, states))
        rv = _normalize(r(key, value, timestamp, states))
        if isinstance(lv, bool) and isinstance(rv, bool):
            return lv or rv
        return lv | rv

    out = Matcher(fn, label=f"or({l.label},{r.label})")
    out.op, out.parts = "or", (l, r)
    return out


def hint(matcher, cost: Optional[float] = None,
         selectivity: Optional[float] = None) -> Matcher:
    """Annotate a matcher with a relative evaluation cost and/or an
    expected accept fraction (0..1).  Pure metadata for the lazy-chain
    ordering pass (``compiler/tiering.py: apply_lazy_order``): cheap,
    selective conjuncts are ordered ahead of expensive ones.  Returns the
    (wrapped) matcher itself."""
    m = _wrap(matcher)
    if cost is not None:
        m.cost_hint = float(cost)
    if selectivity is not None:
        m.selectivity_hint = float(selectivity)
    return m


def true_() -> Matcher:
    return Matcher(lambda key, value, timestamp, states: True, label="true")
