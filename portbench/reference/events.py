# Frozen copy of kafkastreams_cep_tpu_torch/utils/events.py
# at commit 6531974 (the port's host oracle and its front end), imports
# rewritten to this folder: the benchmark's plain reference.  Do not edit
# it to follow the program: it is the yardstick.
"""Event and match-sequence domain types.

Semantics follow the reference types ``cep/Event.java`` and
``cep/Sequence.java``: an event is uniquely identified by its stream position
``(topic, partition, offset)``; a sequence is an ordered mapping of stage name
to the list of events matched at that stage, with order-insensitive per-stage
equality (``Sequence.java:57-73``).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Dict, Iterable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Event:
    """A uniquely identifiable stream record.

    Identity (equality/hash) is the stream position ``(topic, partition,
    offset)`` only, matching ``Event.java:56-69`` — key/value/timestamp do not
    participate.
    """

    key: Any
    value: Any
    timestamp: int
    topic: str = "test"
    partition: int = 0
    offset: int = 0

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Event):
            return NotImplemented
        return (
            self.topic == other.topic
            and self.partition == other.partition
            and self.offset == other.offset
        )

    def __hash__(self) -> int:
        return hash((self.topic, self.partition, self.offset))

    @property
    def position(self) -> Tuple[str, int, int]:
        return (self.topic, self.partition, self.offset)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Event(key={self.key!r}, value={self.value!r}, ts={self.timestamp}, "
            f"{self.topic}/{self.partition}@{self.offset})"
        )


class Sequence:
    """A completed pattern match: stage name -> matched events.

    Events are inserted in buffer-walk order, i.e. *final stage first*
    (the reference's backward pointer walk,
    ``nfa/buffer/impl/KVSharedVersionedBuffer.java:147-171``); use
    :meth:`reversed` for presentation order, as the reference demo does
    (``demo/CEPStockKStreamsDemo.java:66``).
    """

    def __init__(self, items: Optional[Iterable[Tuple[str, Event]]] = None):
        self._stages: Dict[str, List[Event]] = {}
        if items:
            for stage, event in items:
                self.add(stage, event)

    def add(self, stage: str, event: Event) -> "Sequence":
        self._stages.setdefault(stage, []).append(event)
        return self

    def get(self, stage: str) -> Optional[List[Event]]:
        return self._stages.get(stage)

    def as_map(self) -> Dict[str, List[Event]]:
        return self._stages

    def stages(self) -> List[str]:
        return list(self._stages)

    def size(self) -> int:
        return sum(len(v) for v in self._stages.values())

    def __len__(self) -> int:
        return self.size()

    def reversed(self) -> "Sequence":
        """Presentation order: first stage first, events in arrival order."""
        out = Sequence()
        for stage in reversed(list(self._stages)):
            for event in reversed(self._stages[stage]):
                out.add(stage, event)
        return out

    def __eq__(self, other: object) -> bool:
        # Per-stage equality is order-insensitive (Sequence.java:57-73).
        if not isinstance(other, Sequence):
            return NotImplemented
        if set(self._stages) != set(other._stages):
            return False
        for stage, events in self._stages.items():
            if Counter(events) != Counter(other._stages[stage]):
                return False
        return True

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        parts = ", ".join(
            f"{stage}=[{', '.join(repr(e.value) for e in events)}]"
            for stage, events in self._stages.items()
        )
        return f"Sequence({parts})"
