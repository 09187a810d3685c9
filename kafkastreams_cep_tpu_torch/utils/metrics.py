"""Runtime counters of one processor: records, matches, batches, drops and
wall seconds per batch phase, backed by a
:class:`~kafkastreams_cep_tpu_torch.utils.telemetry.MetricsRegistry`, so
every timed phase also lands in a fixed-log-bucket latency histogram
(count, sum, p50, p99 in ``snapshot()["phases"]``) and processor metrics
merge across bank members (``registry.merge``).

The processor reads and writes them as attributes
(``metrics.records_in += n``) and times its phases with
``with metrics.timed("decode_seconds"):``; the child spans inside its
phases (``pack.lanes``, ``decode.wait``, ...), timed with
``with metrics.timed_span("decode.wait"):``, and their work counts
(``metrics.steps += T``) land in ``snapshot()["layers"]``.
:func:`profile` captures a ``torch.profiler`` trace of a window (host
spans and, on the card, its kernels) and :func:`annotate` names a host
region inside one.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

from kafkastreams_cep_tpu_torch.utils.telemetry import (
    LATENCY_EDGES_S,
    MetricsRegistry,
    merge_counter_dicts,
)

__all__ = ["COUNTER_ATTRS", "SECONDS_ATTRS", "PHASE_NAMES", "LAYER_SPANS", "LAYER_COUNTERS",
           "Metrics", "profile", "annotate", "device_memory_stats", "merge_counter_dicts"]

#: Integer runtime counters, in snapshot order.
COUNTER_ATTRS = (
    "records_in",
    "matches_out",
    "batches",
    "duplicates_dropped",
    "decode_fallbacks",
)

#: Wall-time accumulators; each also feeds the phase histogram of the same
#: stem ("device_seconds" -> phases["device"]).  On a CUDA processor without
#: a mesh, ``device_seconds`` is the card's time, read from CUDA events.
SECONDS_ATTRS = (
    "device_seconds",
    "decode_seconds",
    "pack_seconds",
    "dispatch_seconds",
    "drain_seconds",
    "gc_seconds",
)

#: The batch phases every processor pre-registers, so snapshots of runs
#: that never hit a phase (gc off, eager extraction) carry the same keys.
PHASE_NAMES = ("pack", "dispatch", "drain", "device", "decode", "gc")

#: The child spans inside the batch phases, each inside the phase its name
#: begins with; each a ``span.<name>`` histogram whose ``sum`` is its seconds
#: total (``snapshot()["layers"]["spans"]``).
LAYER_SPANS = ("pack.lanes", "pack.columns", "pack.copy", "dispatch.sweep", "device.wait",
               "decode.wait", "decode.build", "gc.read", "gc.sweep")

#: Work counts at the same boundaries, ``layer.<name>`` in the registry
#: (``snapshot()["layers"]["counters"]``): engine steps dispatched (each
#: batch's ``T``), Events the decode and the event GC built from column rows,
#: host events the GC dropped, and ``host_events``, the host mirror's size
#: after the last GC (a level, set there; summed across bank members).
LAYER_COUNTERS = ("steps", "decode_events_materialized", "gc_events_materialized",
                  "gc_events_dropped", "host_events")


def _counter_property(name: str) -> property:
    def get(self) -> float:
        return self.registry.counter(name).value

    def set(self, v) -> None:
        self.registry.counter(name).value = v

    return property(get, set)


class Metrics:
    """Mutable counters for one processor (or bank member), registry-backed.

    Counter attributes read and write registry counters; ``timed(attr)``
    adds the wall seconds of its body to the ``attr`` counter and observes
    the phase's latency histogram."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry or MetricsRegistry()
        for n in COUNTER_ATTRS:
            self.registry.counter(n)
        known = {n for n, _ in self.registry.items()}
        for n in SECONDS_ATTRS:
            # Seconds are floats from the start; a registry handed over (a
            # bank's merged one) keeps its values.
            if n not in known:
                self.registry.counter(n).value = 0.0
        for n in PHASE_NAMES:
            self.registry.histogram(f"phase.{n}", LATENCY_EDGES_S)
        for n in LAYER_SPANS:
            self.registry.histogram(f"span.{n}", LATENCY_EDGES_S)
        for n in LAYER_COUNTERS:
            self.registry.counter(f"layer.{n}")

    def snapshot(self, engine_counters: Dict[str, int]) -> Dict[str, float]:
        """One flat dict: the runtime counters, the phase seconds (rounded
        to the microsecond), ``events_per_second_device`` once a device
        phase was timed, ``engine_counters``, the per-phase latency
        histograms (``"phases"``) and the child spans and work counts
        (``"layers"``)."""
        out: Dict[str, float] = {n: self.registry.counter(n).value for n in COUNTER_ATTRS}
        for n in SECONDS_ATTRS:
            out[n] = round(self.registry.counter(n).value, 6)
        if out["device_seconds"] > 0:
            out["events_per_second_device"] = round(
                out["records_in"] / out["device_seconds"], 1)
        out.update(engine_counters)
        out["phases"] = self.phases()
        out["layers"] = self.layers()
        return out

    def phases(self) -> Dict[str, dict]:
        """Per-phase latency histogram snapshots (count, sum, p50, p99)."""
        return {
            name[len("phase."):]: inst.snapshot()
            for name, inst in self.registry.items()
            if name.startswith("phase.")
        }

    def layers(self) -> Dict[str, dict]:
        """The child spans' histogram snapshots (count, sum, p50, p99) under
        ``"spans"`` and the work counts under ``"counters"``."""
        items = self.registry.items()
        return {
            "spans": {name[len("span."):]: inst.snapshot()
                      for name, inst in items if name.startswith("span.")},
            "counters": {name[len("layer."):]: inst.value
                         for name, inst in items if name.startswith("layer.")},
        }

    def observe(self, attr: str, seconds: float) -> None:
        """Add ``seconds`` to ``attr`` and observe them in the phase's
        histogram."""
        self.registry.counter(attr).value += seconds
        phase = attr[:-8] if attr.endswith("_seconds") else attr
        self.registry.histogram(f"phase.{phase}", LATENCY_EDGES_S).observe(seconds)

    @contextlib.contextmanager
    def timed(self, attr: str) -> Iterator[None]:
        """Add the wall seconds of the ``with`` body to ``attr`` and observe
        them in the phase's histogram."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(attr, time.perf_counter() - t0)

    @contextlib.contextmanager
    def timed_span(self, name: str) -> Iterator[None]:
        """Observe the wall seconds of the ``with`` body in the child span
        ``name``'s histogram."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.registry.histogram(f"span.{name}", LATENCY_EDGES_S).observe(
                time.perf_counter() - t0)


for _n in COUNTER_ATTRS + SECONDS_ATTRS:
    setattr(Metrics, _n, _counter_property(_n))
for _n in LAYER_COUNTERS:
    setattr(Metrics, _n, _counter_property(f"layer.{_n}"))
del _n


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[object]:
    """Capture a ``torch.profiler`` trace of the enclosed block: host spans,
    and the card's kernels when a GPU is present.  The trace is written as
    a Chrome/TensorBoard JSON file under ``log_dir`` when the block ends;
    the profiler is yielded, so the caller can read ``key_averages()`` or
    ``events()`` after the block."""
    import torch
    from torch.profiler import ProfilerActivity, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Name a host-side region inside an active profiler trace."""
    import torch

    with torch.profiler.record_function(name):
        yield


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
