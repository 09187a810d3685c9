# Frozen copy of kafkastreams_cep_tpu_torch/nfa/dewey.py
# at commit 6531974 (the port's host oracle and its front end), imports
# rewritten to this folder: the benchmark's plain reference.  Do not edit
# it to follow the program: it is the yardstick.
"""Dewey version numbers — the SASE+ run-versioning algebra.

Semantics follow ``nfa/DeweyVersion.java``:

* ``add_run``   increments the last component (``DeweyVersion.java:51-56``),
* ``add_stage`` appends a ``0`` component (``DeweyVersion.java:84-86``),
* ``is_compatible(that)`` is true when ``that`` is a proper prefix of
  ``self``, or both have equal length with an equal prefix and
  ``last(self) >= last(that)`` (``DeweyVersion.java:62-82``).

This host class backs the oracle engine; the array engine uses the
fixed-width equivalent in ``ops/dewey_ops.py``.
"""

from __future__ import annotations

from typing import Tuple, Union


class DeweyVersion:
    __slots__ = ("components",)

    def __init__(self, init: Union[int, str, Tuple[int, ...]] = 1):
        if isinstance(init, int):
            self.components: Tuple[int, ...] = (init,)
        elif isinstance(init, str):
            self.components = tuple(int(part) for part in init.split("."))
        else:
            self.components = tuple(init)

    def add_run(self) -> "DeweyVersion":
        return DeweyVersion(self.components[:-1] + (self.components[-1] + 1,))

    def add_stage(self) -> "DeweyVersion":
        return DeweyVersion(self.components + (0,))

    def __len__(self) -> int:
        return len(self.components)

    def is_compatible(self, that: "DeweyVersion") -> bool:
        mine, theirs = self.components, that.components
        if len(mine) > len(theirs):
            return mine[: len(theirs)] == theirs
        if len(mine) == len(theirs):
            return mine[:-1] == theirs[:-1] and mine[-1] >= theirs[-1]
        return False

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, DeweyVersion):
            return NotImplemented
        return self.components == other.components

    def __hash__(self) -> int:
        return hash(self.components)

    def __str__(self) -> str:
        return ".".join(str(c) for c in self.components)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"DeweyVersion({self})"
