"""Crash flight recorder — the last N batches' context, always on hand.

Production failures are diagnosed from what was happening *just before*:
which batch tripped, what the phase timings looked like, which counters
were moving, how full the slab and handle ring were.  The telemetry
registry answers "what is the lifetime total"; this module keeps a
bounded ring of **per-batch** records — phase-timing deltas, counter
deltas, watermark, occupancy, escalation state — and dumps it as JSONL
whenever something goes wrong (supervisor crash/recovery, capacity
escalation, a quarantine burst) or on demand, so every failure ships its
own last-N-batches context instead of a lifetime aggregate.

Design constraints:

* **Cheap per batch.**  One record is a handful of host counter reads
  plus two small device reductions (slab/ring occupancy), read back to
  the host in one copy; the deltas come
  from :func:`~kafkastreams_cep_tpu_torch.utils.telemetry.positive_delta` over
  the previous record's snapshot.  Disabled (no recorder attached) the
  cost is one ``None`` check per batch.
* **Bounded.**  ``capacity`` batches, FIFO — a deque, never a file,
  until a dump is requested.
* **Dump schema** (one JSON object per line): a ``flight_dump`` header
  ``{type, reason, corr, ts_ms, records, dropped}`` followed by
  ``flight_record`` lines ``{type, corr, seq, ts_ms, records_in,
  matches_out, phase_seconds, counters, watermark, slab_live,
  ring_pending, lanes, ...}`` — newest last, exactly the ring order.
  ``corr`` is the processor's batch correlation id
  (``<name>-<batch_seq>``, the same id the ingestion guard stamps on
  dead letters), so a dump row joins against trace spans and DLQ
  entries.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch

from kafkastreams_cep_tpu_torch.utils.logging import get_logger
from kafkastreams_cep_tpu_torch.utils.telemetry import positive_delta

logger = get_logger("runtime.flight")

#: Cumulative per-batch-delta'd runtime counters (utils/metrics.py names).
_RUNTIME_KEYS = (
    "records_in",
    "matches_out",
    "duplicates_dropped",
    "decode_fallbacks",
)
_SECONDS_KEYS = (
    "pack_seconds",
    "dispatch_seconds",
    "drain_seconds",
    "device_seconds",
    "decode_seconds",
    "gc_seconds",
)


class FlightRecorder:
    """Bounded ring of per-batch flight records with JSONL dump-on-event.

    ``capacity`` bounds the ring (oldest records drop, counted).
    ``path`` is the dump destination *prefix*: each dump writes
    ``<path>-<reason>-<n>.jsonl`` (``n`` monotone per recorder); without
    a path, :meth:`dump` returns the records and writes nothing.
    ``quarantine_burst`` is the per-batch dead-letter count at or above
    which the processor triggers an automatic dump.
    """

    def __init__(
        self,
        capacity: int = 64,
        path: Optional[str] = None,
        quarantine_burst: int = 32,
    ):
        self.capacity = max(int(capacity), 1)
        self.path = path
        self.quarantine_burst = max(int(quarantine_burst), 1)
        self.records: deque = deque(maxlen=self.capacity)
        self.dropped = 0  # records aged out of the ring
        self.dumps = 0
        self.dump_paths: List[str] = []
        self._base: Dict[str, Any] = {}
        self._lock = threading.Lock()

    # -- recording (one call per processed batch) ---------------------------

    def observe(self, processor, corr: Optional[str] = None) -> Dict[str, Any]:
        """Append one per-batch record built from ``processor``'s live
        state.  Called by :class:`~kafkastreams_cep_tpu_torch.runtime.processor.
        CEPProcessor` at the end of every batch when a recorder is
        attached; safe to call manually (e.g. between supervisor steps).
        """
        reg = processor.metrics.registry
        flat: Dict[str, Any] = {
            k: reg.counter(k).value for k in _RUNTIME_KEYS + _SECONDS_KEYS
        }
        flat.update(processor.counters())
        flat.update(processor.hot_counters())
        flat.update(processor.walk_counters())
        guard = getattr(processor, "_guard", None)
        if guard is not None:
            flat.update(guard.loss_counters())
        # Tiered processors wrap the engine state (engine/tiered.py); a
        # meshed one holds one engine state a shard.
        shards = getattr(processor.state, "shards", None) or (
            getattr(processor.state, "engine", processor.state),)
        # Two tiny device reductions a shard, read back in one copy each.
        slab_live = ring_pending = 0
        for state in shards:
            live, pending = torch.stack((
                (state.slab.stage >= 0).sum(),
                state.hr_count.sum(dtype=torch.int64),
            )).tolist()
            slab_live += live
            ring_pending += pending
        with self._lock:
            delta = positive_delta(flat, self._base)
            self._base = flat
            rec = {
                "type": "flight_record",
                "corr": corr or f"{processor.name}-{processor._batch_seq}",
                "seq": int(processor._batch_seq),
                "ts_ms": round(time.time() * 1000.0, 3),
                "records_in": delta.pop("records_in", 0),
                "matches_out": delta.pop("matches_out", 0),
                "phase_seconds": {
                    k[: -len("_seconds")]: round(delta.pop(k), 6)
                    for k in _SECONDS_KEYS
                    if k in delta
                },
                # Only the counters that MOVED this batch — a healthy
                # batch's record stays small.
                "counters": {
                    k: int(v)
                    for k, v in delta.items()
                    if isinstance(v, (int, float))
                },
                "watermark": processor._watermark,
                "slab_live": slab_live,
                "ring_pending": ring_pending,
                "lanes": len(processor._lane_of),
            }
            if guard is not None:
                rec["held"] = int(guard.held)
                rec["dead_letters"] = int(
                    sum(guard.reason_counts.values())
                )
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(rec)
        return rec

    def note(self, **attrs: Any) -> None:
        """Attach extra context to the newest record (escalation state,
        recovery round, ...) — a no-op on an empty ring."""
        with self._lock:
            if self.records:
                self.records[-1].update(attrs)

    # -- dumping ------------------------------------------------------------

    def dump(
        self, reason: str, corr: Optional[str] = None
    ) -> Optional[str]:
        """Write the ring as JSONL (header line + one line per record,
        oldest first) to ``<path>-<reason>-<n>.jsonl``; returns the path,
        or the record list when the recorder has no path.  The ring is
        NOT cleared — consecutive triggers each ship full context."""
        with self._lock:
            self.dumps += 1
            n = self.dumps
            records = list(self.records)
            header = {
                "type": "flight_dump",
                "reason": reason,
                "corr": corr,
                "ts_ms": round(time.time() * 1000.0, 3),
                "records": len(records),
                "dropped": self.dropped,
                "capacity": self.capacity,
            }
        if self.path is None:
            return [header] + records  # type: ignore[return-value]
        path = f"{self.path}-{reason}-{n}.jsonl"
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(header, default=str) + "\n")
            for rec in records:
                f.write(json.dumps(rec, default=str) + "\n")
        os.replace(tmp, path)  # a torn dump never shadows a complete one
        self.dump_paths.append(path)
        logger.warning(
            "flight recorder dumped %d batch records to %s (reason=%s, "
            "corr=%s)", len(records), path, reason, corr,
        )
        return path


def read_dump(path: str) -> Dict[str, Any]:
    """Parse one dump file into ``{"header": ..., "records": [...]}`` —
    the inverse of :meth:`FlightRecorder.dump` (diagnostic/test helper)."""
    with open(path, "r", encoding="utf-8") as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    if not lines or lines[0].get("type") != "flight_dump":
        raise ValueError(f"{path} is not a flight-recorder dump")
    return {"header": lines[0], "records": lines[1:]}
