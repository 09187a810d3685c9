# Frozen copy of kafkastreams_cep_tpu_torch/pattern/aggregator.py
# at commit 6531974 (the port's host oracle and its front end), imports
# rewritten to this folder: the benchmark's plain reference.  Do not edit
# it to follow the program: it is the yardstick.
"""Fold-aggregate state declarations.

The reference lets a stage register named fold functions
``(key, value, current) -> new`` evaluated only when an event is consumed
(``pattern/Aggregator.java:22-25``, ``nfa/NFA.java:248,260-265``), with the
state scoped per run and copied on Kleene branching
(``pattern/ValueStore.java:92-97``).

Deviation from the reference (documented): the Java implementation starts a
fresh run's fold state as ``null``; arrays cannot represent ``null``, so every
fold must declare an ``init`` value (default ``0``).  ``states.get(name)``
returns ``init`` until the first fold runs.  Patterns whose predicates only
read state that an earlier stage's fold always sets (the common case, e.g. the
SASE stock query) behave identically.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

AggregatorFn = Callable[[Any, Any, Any], Any]


@dataclasses.dataclass(frozen=True)
class StateAggregator:
    """A named fold: ``fn(key, value, current) -> new`` with initial value.

    Mirrors ``pattern/StateAggregator.java:20-37`` plus the explicit ``init``.
    ``dtype`` is the device storage type of the state — the array analog of
    the reference's generic ``Aggregator<K, V, T>`` (``Aggregator.java:
    22-25``): ``"int32"`` folds stay exact past float32's 2^24 integer
    range, ``"float32"`` is IEEE single.  ``None`` infers from ``init``'s
    Python type (float -> float32, int/bool -> int32).  Fold return values
    are cast to the state dtype, like assigning to a typed Java field.
    """

    name: str
    fn: AggregatorFn
    init: Any = 0
    dtype: Any = None

    @property
    def resolved_dtype(self) -> str:
        if self.dtype is not None:
            d = str(self.dtype)
            if d not in ("int32", "float32"):
                raise ValueError(
                    f"fold state {self.name!r}: dtype must be 'int32' or "
                    f"'float32', got {self.dtype!r}"
                )
            return d
        kind = np.asarray(self.init).dtype
        if np.issubdtype(kind, np.floating):
            return "float32"
        if np.issubdtype(kind, np.integer) or np.issubdtype(kind, np.bool_):
            return "int32"
        raise ValueError(
            f"fold state {self.name!r}: cannot infer dtype from init "
            f"{self.init!r} (type {type(self.init).__name__}); pass "
            f"dtype='int32' or 'float32' explicitly"
        )
