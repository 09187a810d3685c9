"""Stacked multi-query bank: N same-shape queries stepped as one lane batch.

The counterpart of ``kafkastreams_cep_tpu/parallel/stacked.py``.  Queries
that lower to the same table shape (stage count, chain depth, begin and
final positions: ``compiler/tables.py: stackable``) stack their tables on a
leading query axis, and a per-lane ``qid`` selects each lane's query inside
the step (``engine/matcher.py: _build_step`` stacked mode).  N queries x K
lanes run as ``N * K`` lanes of one step, and its slab phase is one launch
of the walk-pass kernel over all of them (the kernel reads no tables).
Identical predicates across the stack are interned before the step is
built (``compiler/multitenant.py: plan_step_predicates``), so each distinct
predicate is evaluated once per lane; ``pred_stats`` reports the dedup.

Use :func:`stackable` to test compatibility and fall back to
``runtime/bank.py: CEPBank``'s per-query loop otherwise;
:func:`choose_bank` decides between the two by measurement.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from kafkastreams_cep_tpu_torch.compiler.tables import (
    TransitionTables,
    lower,
    stackable,
)
from kafkastreams_cep_tpu_torch.engine.matcher import (
    COUNTER_NAMES,
    HOT_COUNTER_NAMES,
    TIER_COUNTER_NAMES,
    WALK_COUNTER_NAMES,
    EngineConfig,
    EngineState,
    EventBatch,
    _build_step,
    build_drain,
    counter_values,
    hot_counter_values,
    make_step,
    map_value,
    per_lane_counter_arrays,
    resolve_device,
    scan_steps,
    stage_counter_arrays,
    stage_report,
    summed,
    walk_counter_values,
)
from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("parallel.stacked")

__all__ = ["StackedBankMatcher", "choose_bank", "stackable"]


def replicate_events(events: EventBatch, copies: int) -> EventBatch:
    """``[K, T]`` events repeated ``copies`` times along the lane axis
    (query-major: copy ``q`` is lanes ``[q * K, (q + 1) * K)``)."""
    def rep(x):
        return torch.cat([x] * copies, dim=0)

    return EventBatch(
        key=rep(events.key), value=map_value(rep, events.value),
        ts=rep(events.ts), off=rep(events.off), valid=rep(events.valid),
    )


def tile_states(states: Sequence[EngineState]) -> EngineState:
    """Per-query ``[K]``-lane states concatenated along the lane axis."""
    def cat(*xs):
        if isinstance(xs[0], tuple):
            return type(xs[0])(*(cat(*f) for f in zip(*xs)))
        return torch.cat(xs, dim=0)

    return cat(*states)


class StackedBankMatcher:
    """``Q`` same-shape queries x ``K`` lanes each, stepped as one batch.

    Lane layout: query-major, lane ``q * K + k`` runs query ``q`` over key
    lane ``k``.  ``scan`` takes per-key events ``[K, T]``, replicates them
    across queries (every query sees every record, as with one processor
    per pattern) and returns outputs ``[Q, K, T, R, W]``, decoded per query
    with that query's stage names (:meth:`names_of`).
    """

    def __init__(self, patterns: Sequence, lanes_per_query: int,
                 config: Optional[EngineConfig] = None, device="cuda"):
        self.tables_list: List[TransitionTables] = [
            p if isinstance(p, TransitionTables) else lower(p) for p in patterns
        ]
        if not self.tables_list or not stackable(self.tables_list):
            raise ValueError(
                "queries do not share a stackable table shape; use "
                "runtime.bank.CEPBank's per-query loop instead"
            )
        self.config = config or EngineConfig()
        self.device = resolve_device(device)
        self.Q = len(self.tables_list)
        self.K = int(lanes_per_query)
        self.num_lanes = self.Q * self.K
        logger.info("stacked bank: %d queries x %d lanes in one batch", self.Q, self.K)
        self.phases = _build_step(self.tables_list, self.config, self.device)
        self.pred_stats = dict(self.phases.pred_stats or {})
        logger.info(
            "stacked bank predicate dedup: %d -> %d distinct (%d event-level, "
            "%d run-level; ratio %.2f)",
            self.pred_stats["total_predicates"],
            self.pred_stats["distinct_predicates"], self.pred_stats["event_level"],
            self.pred_stats["run_level"], self.pred_stats["dedup_ratio"],
        )
        self.qids = torch.arange(self.Q, dtype=torch.int32, device=self.device
                                 ).repeat_interleave(self.K)  # [Q * K]
        self.step = make_step(self.phases, qids=self.qids)
        self._drain = build_drain(self.config)

    def names_of(self, q: int) -> List[str]:
        return self.tables_list[q].names

    def init_state(self) -> EngineState:
        """Each query's initial state over its ``K`` lanes, tiled to the
        ``[Q * K]`` lane axis."""
        return tile_states([self.phases.init_state(self.K, q) for q in range(self.Q)])

    def scan_flat(self, state: EngineState, events: EventBatch):
        """Events ``[K, T]``, replicated across queries, stepped over the
        ``[Q * K]`` lanes; outputs ``[Q * K, T, ...]``."""
        return scan_steps(self.step, state, replicate_events(events, self.Q))

    def scan(self, state: EngineState, events: EventBatch):
        """Events ``[K, T]`` -> outputs ``[Q, K, T, ...]``."""
        state, out = self.scan_flat(state, events)
        return state, type(out)(*(x.reshape((self.Q, self.K) + x.shape[1:]) for x in out))

    def drain(self, state: EngineState):
        """Walk every pending lazy-extraction handle of every lane in one
        pass (the drain reads no tables, so one pass serves every query);
        outputs ``[Q * K, HB, ...]``."""
        return self._drain(state)

    def counters(self, state: EngineState) -> Dict[str, int]:
        return summed(COUNTER_NAMES, counter_values(state))

    def hot_counters(self, state: EngineState) -> Dict[str, int]:
        """Two-tier residency counters summed over all lanes."""
        return summed(HOT_COUNTER_NAMES, hot_counter_values(state))

    def walk_counters(self, state: EngineState) -> Dict[str, int]:
        """Walk-cost counters summed over all lanes."""
        return summed(WALK_COUNTER_NAMES, walk_counter_values(state))

    def stage_counters(self, state: EngineState) -> Dict[str, Dict[str, int]]:
        """Per-stage tallies over every lane (stackable tables share their
        stage positions, so query 0's names label them); empty when
        attribution is off."""
        return stage_report(stage_counter_arrays(state), self.tables_list[0].names)

    def per_query_counters(self, state: EngineState) -> Dict[str, Dict[str, int]]:
        """Loss, hot-tier and walk counters summed over each query's
        ``K``-lane block (lane layout is query-major)."""
        arrays = per_lane_counter_arrays(state)
        return {
            f"q{q}": {n: int(v.reshape(self.Q, self.K)[q].sum()) for n, v in arrays.items()}
            for q in range(self.Q)
        }

    def metrics_snapshot(self, state: EngineState) -> Dict[str, object]:
        """The summed engine counters, structural-zero tier counters, the
        ``per_pattern`` breakdown and, under attribution, ``per_stage``."""
        out: Dict[str, object] = {}
        out.update(self.counters(state))
        out.update(self.hot_counters(state))
        out.update(self.walk_counters(state))
        out.update({n: 0 for n in TIER_COUNTER_NAMES})
        out["per_pattern"] = self.per_query_counters(state)
        per_stage = self.stage_counters(state)
        if per_stage:
            out["per_stage"] = per_stage
        return out


def choose_bank(patterns: Sequence, config: Optional[EngineConfig] = None,
                sample_events: Optional[EventBatch] = None, reps: int = 2,
                device="cuda") -> Tuple[str, Dict[str, object]]:
    """Serial (one :class:`BatchMatcher` per query) or stacked, decided by
    measurement, as in the JAX package.

    Without ``sample_events`` a stackable bank is stacked (one build instead
    of Q) and an unstackable one serial.  With a ``[K_s, T]`` sample, both
    run it (the first run untimed), best of ``reps`` wall times, with the
    device synchronized after each, and the faster wins.  Size the sample
    near the deployment's per-query width: launch overhead dominates at
    small widths.  Returns ``(mode, details)``."""
    from kafkastreams_cep_tpu_torch.parallel.batch import BatchMatcher

    tlist = [p if isinstance(p, TransitionTables) else lower(p) for p in patterns]
    if not stackable(tlist):
        return "serial", {"reason": "not stackable"}
    if sample_events is None:
        return "stacked", {"reason": "no sample; one build beats Q"}
    dev = resolve_device(device)
    K_s = int(sample_events.ts.shape[0])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def best_of(fn):
        fn()
        sync()
        best = float("inf")
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            fn()
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    serial = [BatchMatcher(t, K_s, config, device=dev) for t in tlist]
    serial_states = [m.init_state() for m in serial]
    t_serial = best_of(lambda: [m.scan(s, sample_events)
                                for m, s in zip(serial, serial_states)])
    del serial, serial_states
    stacked = StackedBankMatcher(tlist, K_s, config, device=dev)
    st0 = stacked.init_state()
    t_stacked = best_of(lambda: stacked.scan(st0, sample_events))
    details = {"serial_s": t_serial, "stacked_s": t_stacked,
               "speedup_stacked": t_serial / t_stacked}
    mode = "stacked" if t_stacked <= t_serial else "serial"
    logger.info("choose_bank: %s (%s)", mode, details)
    return mode, details
