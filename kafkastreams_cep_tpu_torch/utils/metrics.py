"""Runtime counters of one processor: records, matches, batches, drops,
and wall seconds per batch phase.

The processor reads and writes them as attributes
(``metrics.records_in += n``) and times its phases with
``with metrics.timed("decode_seconds"):``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

#: Integer runtime counters, in snapshot order.
COUNTER_ATTRS = (
    "records_in",
    "matches_out",
    "batches",
    "duplicates_dropped",
    "decode_fallbacks",
)

#: Wall-time accumulators, one per batch phase.
SECONDS_ATTRS = (
    "device_seconds",
    "decode_seconds",
    "pack_seconds",
    "dispatch_seconds",
    "drain_seconds",
    "gc_seconds",
)


class Metrics:
    """Mutable counters for one processor."""

    def __init__(self):
        for n in COUNTER_ATTRS:
            setattr(self, n, 0)
        for n in SECONDS_ATTRS:
            setattr(self, n, 0.0)

    @contextlib.contextmanager
    def timed(self, attr: str) -> Iterator[None]:
        """Add the wall seconds of the ``with`` body to ``attr``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            setattr(self, attr, getattr(self, attr) + time.perf_counter() - t0)


def merge_counter_dicts(dicts) -> dict:
    """Key-wise sum of plain counter dicts (bank members, shard reports)."""
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out
