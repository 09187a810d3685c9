# Frozen copy of kafkastreams_cep_tpu_torch/nfa/buffer.py
# at commit 6531974 (the port's host oracle and its front end), imports
# rewritten to this folder: the benchmark's plain reference.  Do not edit
# it to follow the program: it is the yardstick.
"""Host shared versioned buffer — the SASE+ compact match DAG.

A dict-backed reimplementation of the reference's
``nfa/buffer/impl/KVSharedVersionedBuffer.java``: every partially-matched
event is stored once, keyed by ``(stage name, stage type, topic, partition,
offset)`` (``StackEventKey.java:28-54``), with a list of Dewey-versioned
predecessor pointers and a refcount (``TimedKeyValue.java:27-45``).

Semantics preserved exactly:

* ``put`` with a predecessor requires the predecessor entry to exist
  (hard error, ``KVSharedVersionedBuffer.java:86-89``);
* a first-stage ``put`` registers a null-predecessor pointer recording the
  run version (``KVSharedVersionedBuffer.java:117-128``);
* ``branch`` walks a path incrementing refcounts so shared prefixes survive
  sibling-run removal (``KVSharedVersionedBuffer.java:99-110``);
* ``peek`` walks predecessors selecting at each hop the first pointer whose
  version is compatible, decrementing refcounts (floored at zero,
  ``TimedKeyValue.java:59-61``), deleting entries when refs reach zero with at
  most one predecessor, and pruning traversed pointers
  (``KVSharedVersionedBuffer.java:147-171``).

This buffer backs the host oracle engine; the array engine uses the slab
equivalent in ``ops/slab.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from portbench.reference.stages import Stage
from portbench.reference.dewey import DeweyVersion
from portbench.reference.events import Event, Sequence

# (stage name, stage type value, topic, partition, offset)
StackKey = Tuple[str, str, str, int, int]


@dataclasses.dataclass(eq=False)
class Pointer:
    """A versioned predecessor pointer; a ``None`` key marks the run origin."""

    version: DeweyVersion
    key: Optional[StackKey]


class _Entry:
    __slots__ = ("key", "value", "timestamp", "refs", "preds")

    def __init__(self, key: Any, value: Any, timestamp: int):
        self.key = key
        self.value = value
        self.timestamp = timestamp
        self.refs = 1
        self.preds: List[Pointer] = []

    def decrement(self) -> int:
        # Floors at zero (TimedKeyValue.java:59-61).
        if self.refs > 0:
            self.refs -= 1
        return self.refs

    def pointer_by_version(self, version: DeweyVersion) -> Optional[Pointer]:
        # First compatible pointer in insertion order (TimedKeyValue.java:83-92).
        for pointer in self.preds:
            if version.is_compatible(pointer.version):
                return pointer
        return None


def _stack_key(stage: Stage, event: Event) -> StackKey:
    return (stage.name, stage.type.value, event.topic, event.partition, event.offset)


class SharedVersionedBuffer:
    """Host shared versioned buffer over a plain dict."""

    def __init__(self) -> None:
        self.store: Dict[StackKey, _Entry] = {}

    def __len__(self) -> int:
        return len(self.store)

    def put_first(self, stage: Stage, event: Event, version: DeweyVersion) -> None:
        """First-stage put: records the run version via a null predecessor."""
        entry = _Entry(event.key, event.value, event.timestamp)
        entry.preds.append(Pointer(version, None))
        self.store[_stack_key(stage, event)] = entry

    def put(
        self,
        curr_stage: Stage,
        curr_event: Event,
        prev_stage: Stage,
        prev_event: Event,
        version: DeweyVersion,
    ) -> None:
        prev_key = _stack_key(prev_stage, prev_event)
        curr_key = _stack_key(curr_stage, curr_event)
        if prev_key not in self.store:
            raise RuntimeError(f"cannot find predecessor event for {prev_key}")
        entry = self.store.get(curr_key)
        if entry is None:
            entry = _Entry(curr_event.key, curr_event.value, curr_event.timestamp)
            self.store[curr_key] = entry
        entry.preds.append(Pointer(version, prev_key))

    def branch(self, stage: Stage, event: Event, version: DeweyVersion) -> None:
        pointer: Optional[Pointer] = Pointer(version, _stack_key(stage, event))
        while pointer is not None and pointer.key is not None:
            entry = self.store.get(pointer.key)
            if entry is None:
                # The reference NPEs here (KVSharedVersionedBuffer.java:
                # 102-108 dereferences store.get unchecked); reachable when
                # sibling runs sharing a path die in one event (e.g. window
                # pruning).  A crash is not a semantics — the walk stops,
                # matching the array engine's counted-miss behavior.
                break
            entry.refs += 1
            pointer = entry.pointer_by_version(pointer.version)

    def get(self, stage: Stage, event: Event, version: DeweyVersion) -> Sequence:
        return self._peek(stage, event, version, remove=False)

    def remove(self, stage: Stage, event: Event, version: DeweyVersion) -> Sequence:
        return self._peek(stage, event, version, remove=True)

    def _peek(self, stage: Stage, event: Event, version: DeweyVersion, remove: bool) -> Sequence:
        pointer: Optional[Pointer] = Pointer(version, _stack_key(stage, event))
        sequence = Sequence()
        while pointer is not None and pointer.key is not None:
            key = pointer.key
            entry = self.store.get(key)
            if entry is None:
                break  # reference-NPE state; see branch() above
            refs_left = entry.decrement()
            if remove and refs_left == 0 and len(entry.preds) <= 1:
                del self.store[key]
            stage_name, _, topic, partition, offset = key
            sequence.add(
                stage_name,
                Event(entry.key, entry.value, entry.timestamp, topic, partition, offset),
            )
            nxt = entry.pointer_by_version(pointer.version)
            if remove and nxt is not None and refs_left == 0:
                entry.preds.remove(nxt)
            pointer = nxt
        return sequence
