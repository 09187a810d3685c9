"""Checkpoint / restore of processor state — the changelog-store analog.

The reference persists its engine state in Kafka Streams changelog stores
and never serializes code: runs reference stages by *name* and are
rehydrated from the compiled topology on restore
(``ComputationStageSerDe.java:40-46,66-78``).  Here a checkpoint is a host
snapshot of the engine tensors plus the host bookkeeping (key-to-lane map,
per-lane event store, offsets); restore compiles the pattern fresh from
user code and refuses a topology whose stage names differ.

The file format is the JAX package's (``kafkastreams_cep_tpu/runtime/
checkpoint.py``, format 3): one pickled ``{header, arrays}`` dict whose
``arrays`` is an ``.npz`` of the state leaves under the same names
(``alive``, ..., ``slab/stage``, ...).  A snapshot written by either
package restores into the other.

Snapshots are mesh-agnostic: a meshed processor's lane rows are gathered in
logical lane order, and the header records which mesh wrote them
(``mesh_size``, ``lane_shards``), so a restore may place the lanes onto a
mesh of another size, or onto one device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import pickle
from typing import Any, Dict, Optional

import numpy as np

from kafkastreams_cep_tpu_torch.convert import state_arrays
from kafkastreams_cep_tpu_torch.engine.matcher import EngineConfig
from kafkastreams_cep_tpu_torch.runtime import migrate as migrate_mod
from kafkastreams_cep_tpu_torch.runtime.ingest import DeadLetter, IngestGuard
from kafkastreams_cep_tpu_torch.runtime.processor import CEPProcessor, Record
from kafkastreams_cep_tpu_torch.utils.events import Event
from kafkastreams_cep_tpu_torch.utils.failpoints import fire as _failpoint
from kafkastreams_cep_tpu_torch.utils.latency import LatencyLedger
from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("runtime.checkpoint")

FORMAT_VERSION = 3

# Classes of the JAX package a snapshot's header may name (the host event
# mirror's events, the ingest guard's held records and dead letters), mapped
# to this package's copies: restoring a snapshot written by the JAX package
# imports nothing of it.
_JAX_CLASSES = {
    ("kafkastreams_cep_tpu.utils.events", "Event"): Event,
    ("kafkastreams_cep_tpu.runtime.processor", "Record"): Record,
    ("kafkastreams_cep_tpu.runtime.ingest", "DeadLetter"): DeadLetter,
}


class CheckpointCorrupt(ValueError):
    """The checkpoint's payload does not match its recorded digest."""


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        cls = _JAX_CLASSES.get((module, name))
        return cls if cls is not None else super().find_class(module, name)


def save_checkpoint(
    processor: CEPProcessor, path: str, extra: Optional[Dict[str, Any]] = None
) -> None:
    """Snapshot a processor's full state to ``path`` (a single file).
    ``extra`` rides in the header for the caller's own bookkeeping (the
    supervisor's journal sequence number)."""
    # Fault site (utils/failpoints.py): a snapshot that fails before
    # anything is written.
    _failpoint("checkpoint.save")
    if processor._pending is not None:
        raise ValueError(
            "pipelined processor holds an undecoded batch; call flush() "
            "before checkpointing (a snapshot cannot carry device outputs)"
        )
    if processor._col_batches:
        # Column batches (process_columns) materialize their live rows into
        # the picklable event mirror; dead rows drop.
        processor._gc_events()
    tables = processor.batch.matcher.tables
    header = {
        "format_version": FORMAT_VERSION,
        "extra": dict(extra or {}),
        "stage_names": list(processor.batch.names),
        "state_names": list(tables.state_names),
        "state_dtypes": list(tables.state_dtypes),
        "config": dataclasses.asdict(processor.batch.matcher.config),
        "num_lanes": processor.num_lanes,
        "topic": processor.topic,
        "epoch": processor.epoch,
        "gc_events": processor.gc_events,
        "dedup": processor.dedup,
        "gc_interval": processor.gc_interval,
        "gc_events_interval": processor.gc_events_interval,
        "decode_budget": processor.decode_budget,
        "pipeline": processor.pipeline,
        "drain_interval": processor.drain_interval,
        "lane_of": dict(processor._lane_of),
        # Which mesh wrote this snapshot (None: one device); the rows are
        # logical lanes whatever it was.
        "mesh_size": processor.mesh.size if processor.mesh is not None else None,
        "lane_shards": processor.lane_shards(),
        "next_offset": processor._next_offset.copy(),
        "off_base": processor._off_base.copy(),
        "events": [dict(d) for d in processor._events],
        "value_proto": processor._value_proto,
        # The ingest guard's held records, watermark, frontier, dead letters
        # and loss counters, restored as they were.
        "ingest": processor._guard.to_state() if processor._guard is not None else None,
        # The latency ledger's committed histograms and parked bundles
        # (utils/latency.py), restored on the wall clock.
        "latency": processor.ledger.to_state() if processor.ledger is not None else None,
    }
    buf = io.BytesIO()
    np.savez(buf, **state_arrays(processor.host_state()))
    header["arrays_sha256"] = hashlib.sha256(buf.getvalue()).hexdigest()
    with open(path, "wb") as f:
        pickle.dump({"header": header, "arrays": buf.getvalue()}, f)
    logger.info(
        "checkpoint saved to %s: %d lanes, stages %s",
        path, header["num_lanes"], header["stage_names"],
    )


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint file into ``{header, arrays}``; raises
    :class:`CheckpointCorrupt` when it cannot be parsed or fails its
    digest."""
    try:
        with open(path, "rb") as f:
            blob = _Unpickler(f).load()
        header = blob["header"]
    except OSError:
        raise
    except (pickle.UnpicklingError, EOFError, KeyError, TypeError,
            AttributeError, ImportError) as e:
        raise CheckpointCorrupt(
            f"checkpoint {path} is unreadable ({type(e).__name__}: {e})"
        ) from e
    if header["format_version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {header['format_version']} unsupported")
    want = header.get("arrays_sha256")
    if want is not None and hashlib.sha256(blob["arrays"]).hexdigest() != want:
        raise CheckpointCorrupt(
            f"checkpoint {path} failed integrity check: array payload digest "
            f"differs from the header's {want}"
        )
    with np.load(io.BytesIO(blob["arrays"])) as z:
        arrays = {k: z[k] for k in z.files}
    return {"header": header, "arrays": arrays}


def restore_processor(
    pattern, path: str, ckpt: Optional[Dict[str, Any]] = None, device="cuda", mesh=None
) -> CEPProcessor:
    """Rebuild a processor from user code plus a checkpoint.

    ``pattern`` is compiled fresh (predicates and folds come from code);
    the checkpoint supplies only state, and a topology whose stage names,
    fold-state names or fold dtypes differ is refused.  A tiered snapshot
    (``engine/...`` and ``carry/...`` leaves) restores with its stencil
    carry; a snapshot with ingest-guard state restores the guard with its
    held records and dead letters, and one with a latency ledger the
    ledger.

    ``mesh`` may differ from the mesh (or one device) that wrote the
    snapshot, the analog of restoring changelogged partitions onto a
    resized consumer group; its size must divide the lane count.  A change
    of device count routes the rows through the identity
    ``runtime.migrate.repartition_state`` (the one audited re-assignment
    point) and is logged."""
    if ckpt is None:
        ckpt = load_checkpoint(path)
    header = ckpt["header"]
    target_devs = mesh.size if mesh is not None else 1
    if int(header["num_lanes"]) % target_devs:
        raise ValueError(
            f"checkpoint holds {header['num_lanes']} lanes, not divisible "
            f"by the {target_devs}-device restore mesh; pick a mesh whose "
            "size divides the lane count (parallel/sharding.py contract)"
        )
    proc = CEPProcessor(
        pattern,
        header["num_lanes"],
        EngineConfig(**header["config"]),
        topic=header["topic"],
        epoch=header["epoch"],
        gc_events=header.get("gc_events", True),
        dedup=header.get("dedup", True),
        gc_interval=header.get("gc_interval", 0),
        gc_events_interval=header.get("gc_events_interval", 8),
        decode_budget=header.get("decode_budget", 131072),
        pipeline=header.get("pipeline", False),
        drain_interval=header.get("drain_interval", 1),
        device=device,
        mesh=mesh,
    )
    tables = proc.batch.matcher.tables
    if list(proc.batch.names) != list(header["stage_names"]):
        raise ValueError(
            "pattern topology does not match checkpoint: stages "
            f"{proc.batch.names} vs checkpoint {header['stage_names']}"
        )
    if list(tables.state_names) != list(header["state_names"]):
        raise ValueError("fold-state names do not match checkpoint")
    if list(tables.state_dtypes) != list(header["state_dtypes"]):
        raise ValueError(
            "fold-state dtypes do not match checkpoint: "
            f"{tables.state_dtypes} vs checkpoint {header['state_dtypes']} "
            "(typed agg bit patterns are not translatable across dtypes)"
        )
    arrays = ckpt["arrays"]
    written_devs = int(header.get("mesh_size") or 1)
    if written_devs != target_devs:
        # Rows are logical lanes, and every move this runtime makes
        # (evacuation, rebalance: migrate.move_lanes) relabels lanes so the
        # live assignment is the contiguous identity: a new device count
        # is the identity repartition placed in new-sized blocks.
        arrays = migrate_mod.repartition_state(arrays, np.arange(int(header["num_lanes"])))
        logger.info(
            "checkpoint written on %d device(s) restored onto %d: lanes "
            "placed in %d-lane shard blocks",
            written_devs, target_devs, int(header["num_lanes"]) // target_devs,
        )
    proc.state = proc.place_arrays(arrays)
    # step_seq is the per-lane step counter; a tiered state nests the
    # engine's leaves under "engine/".
    proc._step_base = int(np.max(arrays.get("step_seq", arrays.get("engine/step_seq"))))
    proc._lane_of = dict(header["lane_of"])
    proc._key_of = {v: k for k, v in proc._lane_of.items()}
    proc._next_offset = np.asarray(header["next_offset"]).copy()
    proc._off_base = np.asarray(header["off_base"]).copy()
    proc._events = [dict(d) for d in header["events"]]
    proc._value_proto = header["value_proto"]
    if header.get("ingest") is not None:
        # The guard runs on time.time until the caller sets a clock
        # (``proc.set_clock``): clocks are not durable state.
        proc._guard = IngestGuard.from_state(header["ingest"])
        # The flight recorder's burst detection diffs against the dead-letter
        # total: re-base it so a restore never reads the history as a burst.
        proc._dlq_base = int(sum(proc._guard.reason_counts.values()))
    if header.get("latency") is not None:
        # On the wall clock: callers with a pinned clock re-inject it with
        # ``proc.set_clock`` (a supervisor does).
        proc.ledger = LatencyLedger.from_state(header["latency"])
    logger.info(
        "restored processor from %s: %d keys assigned", path, len(proc._lane_of)
    )
    return proc
