"""``K`` independent per-key matchers stepped together.

The reference runs one NFA per Kafka partition (``CEPProcessor.java:
117-134``); here each lane of the ``[K]`` axis is one such matcher (run
queue + slab), and every step advances all lanes at once.  The step's slab
phase, and the lazy drain pass, are the hand-written walk-pass kernel when
the state lives on a CUDA device (``ops/walk_kernel.py``), the plain
PyTorch pass on the CPU.

``CEP_SCAN_KERNEL=1`` (or ``interpret``, accepted so that one environment
drives both packages alike) runs each ``scan`` as one whole-scan kernel
launch instead (``ops/scan_kernel.py``), in the instance of the config's
modes (eager or lazy, single or two-tier slab, with or without stage
attribution; the conjunct tally still runs once a batch around it): the
first scan traces the pattern's predicates and folds into C++ for the
events' leaf dtypes (``ops/scan_codegen.py``), then builds and launches the
kernel on CUDA, or runs its plain version on the CPU.  A pattern the code
generator cannot express
(:class:`~kafkastreams_cep_tpu_torch.ops.scan_codegen.LoweringError`,
raised on the host before any build) is logged and served by the per-step
path for good; every other failure raises.

The whole scan is the JAX package's whole-scan kernel, which serves every
walker alone in the batched slab order whatever ``walker_budget`` and
``sequential_slab`` say (``kafkastreams_cep_tpu/parallel/batch.py:
359-380`` builds it without reading either); the two switches then shape
only ``step`` and ``drain``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import torch

from kafkastreams_cep_tpu_torch.compiler.multitenant import tables_key
from kafkastreams_cep_tpu_torch.compiler.tables import TransitionTables, lower
from kafkastreams_cep_tpu_torch.compiler.tiering import build_conjunct_tally
from kafkastreams_cep_tpu_torch.engine.matcher import (
    COUNTER_NAMES,
    HOT_COUNTER_NAMES,
    TIER_COUNTER_NAMES,
    WALK_COUNTER_NAMES,
    EngineConfig,
    EngineState,
    EventBatch,
    TPUMatcher,
    counter_values,
    hot_counter_values,
    map_value,
    _build_step,
    per_lane_counter_arrays,
    resolve_device,
    stage_counter_arrays,
    stage_report,
    scan_steps,
    summed,
    walk_counter_values,
)
from kafkastreams_cep_tpu_torch.ops import renorm as renorm_mod
from kafkastreams_cep_tpu_torch.ops import scan_codegen, scan_kernel
from kafkastreams_cep_tpu_torch.ops import slab as slab_mod
from kafkastreams_cep_tpu_torch.utils import tracecache
from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("parallel.batch")


#: Pointer-version elements a renormalization chunk of lanes holds at most.
_RENORM_CHUNK = 1 << 26


def lane_slice(x, a: int, b: int):
    """Lanes ``[a, b)`` of a tensor or a named tuple of ``[K, ...]`` tensors."""
    if isinstance(x, tuple):
        vals = [lane_slice(v, a, b) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x[a:b]


def lane_cat(parts):
    """The lane-wise concatenation of equal-structured results."""
    first = parts[0]
    if isinstance(first, tuple):
        vals = [lane_cat([p[i] for p in parts]) for i in range(len(first))]
        return type(first)(*vals) if hasattr(first, "_fields") else tuple(vals)
    return torch.cat(parts)


def sweep_lanes(state: EngineState, depth: int, do_renorm: bool) -> EngineState:
    """Per-lane maintenance sweep: slab mark-sweep (frees entries no future
    buffer op can reach), then, when enabled, Dewey version
    renormalization (``ops/renorm.py``).  Pending lazy-extraction handles
    are liveness roots and renormalize with the runs (inert under the
    eager engine, where ``hr_count`` stays 0), so a sweep between a match's
    completion and its drain keeps the match."""
    HB = state.hr_stage.shape[-1]
    R = state.alive.shape[-1]
    pending = (
        torch.arange(HB, device=state.alive.device)[None, :]
        < state.hr_count[:, None]
    )
    run_off = torch.cat(
        [
            torch.where(state.alive, state.event_off, -1),
            torch.where(pending, state.hr_off, -1),
        ],
        dim=1,
    )
    state = state._replace(slab=slab_mod.mark_sweep(state.slab, run_off, depth))
    if do_renorm:
        args = (
            torch.cat([state.ver, state.hr_ver], dim=1),
            torch.cat([state.vlen, state.hr_vlen], dim=1),
            torch.cat([state.alive, pending], dim=1),
            # Handles are never seed runs (a match consumed events).
            torch.cat([state.id_pos, torch.zeros_like(state.hr_vlen)], dim=1),
            state.slab,
        )
        # Lanes are independent: renormalize them in chunks whose pointer
        # versions stay under _RENORM_CHUNK elements, so the int64
        # temporaries of a wide slab (K x E x MP x D) fit beside the state.
        K = state.alive.shape[0]
        per = max(1, _RENORM_CHUNK // max(state.slab.pver[0].numel(), 1))
        parts = [renorm_mod.renorm_lane(*(lane_slice(x, a, a + per) for x in args))
                 for a in range(0, K, per)]
        ver2, vlen2, slab, _ = (parts[0] if len(parts) == 1 else
                                lane_cat(parts))
        state = state._replace(
            ver=ver2[:, :R], vlen=vlen2[:, :R],
            hr_ver=ver2[:, R:], hr_vlen=vlen2[:, R:], slab=slab,
        )
    return state


class BatchMatcher:
    """``K`` per-key matchers as one array program.

    ``step`` consumes one event per lane (``EventBatch`` leaves ``[K]``);
    ``scan`` consumes a ``[K, T]`` batch step by step and returns
    ``[K, T, ...]`` outputs — the shape the processor feeds."""

    def __init__(self, pattern, num_lanes: int,
                 config: Optional[EngineConfig] = None, device="cuda"):
        tables = pattern if isinstance(pattern, TransitionTables) else lower(pattern)
        config = config or EngineConfig()
        device = resolve_device(device)
        # The step phases (the tables and predicate plan on the device) and
        # the generated whole-scan sources are structural functions of
        # (tables, config, device): a rebuilt matcher of a known pattern (a
        # recovery, an escalation, a restore) takes them from the process
        # cache (utils/tracecache.py).  The lane count is not in the key:
        # nothing built depends on it.
        tk = tables_key(tables)
        self._cache_key = (None if tk is None
                           else (tk, dataclasses.astuple(config), str(device)))
        phases = self._cached("batch.step", lambda: _build_step(tables, config, device))
        self.matcher = TPUMatcher(tables, config, device, phases=phases)
        self.num_lanes = int(num_lanes)
        self.device = self.matcher.device
        self.step = self.matcher.step
        # Under stage attribution every conjunct of every consuming-edge
        # predicate is tallied over each scanned batch, on the device
        # (``compiler/tiering.py``); ``conjunct_counters`` reads it.
        self._conjunct_slots: list = []
        self._conjunct_counts: Optional[torch.Tensor] = None
        if self.matcher.config.stage_attribution:
            self._conjunct_slots, self._conjunct_tally = build_conjunct_tally(
                self.matcher.tables
            )
        # The whole-scan kernel (opt-in): one generated source per event
        # structure and leaf dtypes, made by the first scan that sees it.
        self.uses_scan_kernel = os.environ.get("CEP_SCAN_KERNEL", "0") in (
            "1", "interpret",
        )
        self._scan_sources: Dict[str, scan_codegen.ScanSource] = self._cached(
            "batch.scan", dict)

    def _cached(self, namespace: str, build):
        """``build()`` through the process cache under this matcher's key
        (an unkeyable pattern builds uncached)."""
        return tracecache.lookup(namespace, self._cache_key, build)

    @property
    def names(self):
        return self.matcher.names

    @property
    def phases(self):
        return self.matcher.phases

    def init_state(self) -> EngineState:
        return self.matcher.init_state(self.num_lanes)

    def scan(self, state: EngineState, events: EventBatch):
        """Run a ``[K, T]`` batch; returns ``(state, StepOutput [K, T, ...])``."""
        self._accumulate_conjuncts(events)
        if self.uses_scan_kernel:
            source = self._scan_source(events)
            if source is not None:
                return scan_kernel.scan_pass(
                    source, self.matcher.config, self.phases, state, events
                )
        return scan_steps(self.step, state, events)

    def _accumulate_conjuncts(self, events: EventBatch) -> None:
        """Add one batch to the conjunct tally (on the device, no host
        read); a no-op unless ``stage_attribution`` is on."""
        if not self._conjunct_slots:
            return
        if self._conjunct_counts is None:
            self._conjunct_counts = torch.zeros(
                (2, len(self._conjunct_slots)), dtype=torch.int32,
                device=self.device,
            )
        self._conjunct_counts = self._conjunct_tally(self._conjunct_counts, events)

    def _scan_source(self, events: EventBatch):
        """The generated source for ``events``' structure and leaf dtypes,
        or None once the pattern proved inexpressible (the per-step path
        then serves every scan)."""
        key = repr(map_value(lambda x: str(getattr(x, "dtype", type(x))), events.value))
        if key not in self._scan_sources:
            try:
                self._scan_sources[key] = scan_codegen.generate(
                    self.matcher.tables, events.value
                )
            except scan_codegen.LoweringError as e:
                logger.warning(
                    "whole-scan kernel cannot express this pattern (%s); "
                    "falling back to the per-step path", e,
                )
                self.uses_scan_kernel = False
                return None
        return self._scan_sources[key]

    def sweep(self, state: EngineState) -> EngineState:
        """Free slab entries unreachable from live runs and renormalize
        versions; ``CEPProcessor(gc_interval=N)`` calls it every N
        batches."""
        cfg = self.matcher.config
        return sweep_lanes(state, cfg.max_walk, cfg.renorm_versions)

    def drain(self, state: EngineState):
        """Walk every pending lazy-extraction handle of every lane in one
        pass (the walk-pass kernel in drain mode on CUDA, the plain pass on
        the CPU); returns ``(state, DrainOutput [K, HB, ...])``.  A no-op on
        eager or already-drained state."""
        return self.matcher.drain(state)

    def counters(self, state: EngineState) -> Dict[str, int]:
        """Overflow/drop counters summed over all lanes."""
        return summed(COUNTER_NAMES, counter_values(state))

    def hot_counters(self, state: EngineState) -> Dict[str, int]:
        """Two-tier residency counters summed over all lanes (all 0 when
        ``slab_hot_entries == 0``)."""
        return summed(HOT_COUNTER_NAMES, hot_counter_values(state))

    def walk_counters(self, state: EngineState) -> Dict[str, int]:
        """Walk-cost counters summed over all lanes (not loss indicators)."""
        return summed(WALK_COUNTER_NAMES, walk_counter_values(state))

    def per_lane_counters(self, state: EngineState) -> Dict[str, list]:
        """Per-lane (un-summed) loss, hot-tier and walk counters: ``{name:
        [K ints]}``, which lane is burning capacity."""
        return {n: v.reshape(-1).tolist()
                for n, v in per_lane_counter_arrays(state).items()}

    def conjunct_counters(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        """Measured per-conjunct tallies ``{stage: {conjunct_key: {evals,
        accepts, selectivity}}}`` (``selectivity`` None before any batch);
        empty unless ``stage_attribution`` is on."""
        if not self._conjunct_slots:
            return {}
        if self._conjunct_counts is None:
            counts = [[0] * len(self._conjunct_slots)] * 2
        else:
            counts = self._conjunct_counts.tolist()
        report: Dict[str, Dict[str, Dict[str, Any]]] = {}
        for i, (stage, key, _m) in enumerate(self._conjunct_slots):
            ev, ac = int(counts[0][i]), int(counts[1][i])
            report.setdefault(stage, {})[key] = {
                "evals": ev,
                "accepts": ac,
                "selectivity": (ac / ev) if ev else None,
            }
        return report

    def stage_counters(self, state: EngineState) -> Dict[str, Dict[str, Any]]:
        """Per-stage tallies summed over all lanes (``{stage_name: {tally:
        total, selectivity}}``), each stage with a ``"conjuncts"`` report of
        its measured conjunct tallies; empty when attribution is off."""
        report = stage_report(stage_counter_arrays(state), self.names)
        for stage, rows in self.conjunct_counters().items():
            report.setdefault(stage, {})["conjuncts"] = rows
        return report

    def metrics_snapshot(self, state: EngineState) -> Dict[str, Any]:
        """The engine's telemetry of ``state`` in one dict: the summed loss,
        hot-tier and walk counters, the tier counters (structural zeros
        untiered, so every matcher has one schema) and, under attribution,
        ``per_stage``."""
        out: Dict[str, Any] = {}
        out.update(self.counters(state))
        out.update(self.hot_counters(state))
        out.update(self.walk_counters(state))
        out.update({n: 0 for n in TIER_COUNTER_NAMES})
        per_stage = self.stage_counters(state)
        if per_stage:
            out["per_stage"] = per_stage
        return out
