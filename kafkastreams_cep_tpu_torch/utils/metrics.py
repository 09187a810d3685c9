"""Runtime counters of one processor: records, matches, batches, drops,
and wall seconds per batch phase.

The processor reads and writes them as attributes
(``metrics.records_in += n``) and times its phases with
``with metrics.timed("decode_seconds"):``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator

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

    def snapshot(self, engine_counters: Dict[str, int]) -> Dict[str, float]:
        """One flat dict: the runtime counters, the phase seconds (rounded
        to the microsecond), ``events_per_second_device`` once a device
        phase was timed, and ``engine_counters``."""
        out: Dict[str, float] = {n: getattr(self, n) for n in COUNTER_ATTRS}
        for n in SECONDS_ATTRS:
            out[n] = round(getattr(self, n), 6)
        if out["device_seconds"] > 0:
            out["events_per_second_device"] = round(
                out["records_in"] / out["device_seconds"], 1)
        out.update(engine_counters)
        return out

    @contextlib.contextmanager
    def timed(self, attr: str) -> Iterator[None]:
        """Add the wall seconds of the ``with`` body to ``attr``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            setattr(self, attr, getattr(self, attr) + time.perf_counter() - t0)


def device_memory_stats(device=None) -> Dict[str, int]:
    """The ``*bytes*`` entries of ``torch.cuda.memory_stats(device)`` (the
    card's allocator gauges, for capacity planning); ``{}`` for a CPU
    device or where no GPU is present."""
    import torch

    device = torch.device(device) if device is not None else None
    if (device is not None and device.type != "cuda") or not torch.cuda.is_available():
        return {}
    return {k: int(v) for k, v in torch.cuda.memory_stats(device).items()
            if isinstance(v, (int, float)) and "bytes" in k}


def merge_counter_dicts(dicts) -> dict:
    """Key-wise sum of plain counter dicts (bank members, shard reports)."""
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out
