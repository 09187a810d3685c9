"""Serde infrastructure — the boundary between bytes and records.

The reference's serde stack (``serde/KryoSerDe.java``,
``AbstractKryoSerde.java``) exists because every store/changelog round-trip
crosses a byte boundary.  Here the only byte boundaries are stream ingest
and checkpoints: state tensors serialize as numpy blobs inside checkpoints
(``runtime/checkpoint.py``), so the pluggable part is the *record* serde —
this module.  ``json_serde`` is the analog of the demo's ``StockEventSerDe``
(``demo/StockEventSerDe.java:50-89``): JSON object <-> dict-of-scalars
values, the shape the engine consumes.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Generic, TypeVar

T = TypeVar("T")


class Serde(Generic[T]):
    """A (serializer, deserializer) pair over ``bytes``."""

    def __init__(
        self,
        serialize: Callable[[T], bytes],
        deserialize: Callable[[bytes], T],
    ):
        self.serialize = serialize
        self.deserialize = deserialize


def json_serde(encoding: str = "utf-8") -> Serde[Any]:
    """JSON-over-utf8 for dict/list/scalar values (compact separators, so
    output matches the reference demo's JSON lines byte-for-byte)."""
    return Serde(
        serialize=lambda obj: json.dumps(
            obj, separators=(",", ":")
        ).encode(encoding),
        deserialize=lambda data: json.loads(data.decode(encoding)),
    )


def string_serde(encoding: str = "utf-8") -> Serde[str]:
    return Serde(
        serialize=lambda s: s.encode(encoding),
        deserialize=lambda b: b.decode(encoding),
    )
