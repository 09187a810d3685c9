"""Capacity estimation: derive an ``EngineConfig`` from a sample of traffic
instead of tuning it by hand.

The counterpart of ``kafkastreams_cep_tpu/engine/sizing.py`` (its note
explains why the array engine needs sizing at all: every shape is a
capacity knob with an overflow counter, where the reference's stores grow
on the heap).  The same functions with the same arithmetic, so a sample
sizes to the same config in both packages:

``probe``    — one instrumented run of the sample: counters and occupancy
               maxima, read once per chunk;
``suggest``  — a config from a probe report (structural floors from the
               compiled tables, measured maxima times a margin);
``autosize`` — probe, grow what overflowed, re-probe, tighten, verify;
``escalate`` — the next strictly wider config for the counters a live
               batch tripped, under an :class:`EscalationPolicy`;
``escalate_ingest`` — the same for the ingest guard's loss counters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import torch

from kafkastreams_cep_tpu_torch.engine.matcher import (
    EngineConfig,
    EventBatch,
    map_value,
)
from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("engine.sizing")

# Counters that say a capacity knob is too small, with the knob each grows.
# slab_missing is absent (reference NPE states, a pattern property), and so
# is walk_collisions (a walker_budget > 1 semantics flag, not a capacity).
_COUNTER_KNOB = {
    "run_drops": "max_runs",
    "ver_overflows": "dewey_depth",
    "slab_full_drops": "slab_entries",
    "slab_pred_drops": "slab_preds",
    "slab_trunc": "max_walk",
    "handle_overflows": "handle_ring",
}

# The ingest guard's loss counters and the IngestPolicy knob each grows:
# a late drop means the grace window under-covered the stream's skew, an
# eviction that the reorder buffer was too shallow.  ``quarantined`` is a
# data defect that no knob repairs.
_INGEST_COUNTER_KNOB = {
    "late_dropped": "grace_ms",
    "reorder_evictions": "reorder_depth",
}

# Additive growth floors for knobs that may be 0 (a multiplier alone would
# never move grace_ms off zero).
_INGEST_KNOB_FLOOR = {"grace_ms": 1000, "reorder_depth": 64}


class ProbeReport(NamedTuple):
    """What one instrumented sample run observed."""

    counters: Dict[str, int]
    max_alive_runs: int  # per lane, max over chunk boundaries
    max_live_entries: int  # slab entries in use, per lane
    max_npreds: int  # pointer-list width in use
    max_vlen: int  # deepest Dewey version (runs and pointers)
    max_match_len: int  # longest extracted match
    max_matches_chunk: int  # matches completed per lane per chunk (the
    #   handle ring's working set under lazy extraction)
    config: EngineConfig


def _chunked(events: EventBatch, chunk: int):
    T = int(events.ts.shape[1])
    for t0 in range(0, T, chunk):
        yield EventBatch(*(map_value(lambda x: x[:, t0:t0 + chunk], f) for f in events))


def _on(events: EventBatch, device) -> EventBatch:
    return EventBatch(*(map_value(lambda x: torch.as_tensor(x).to(device), f)
                        for f in events))


def probe(
    pattern,
    events: EventBatch,
    config: EngineConfig,
    sweep_every: int = 16,
    device="cuda",
) -> ProbeReport:
    """Run ``pattern`` over ``events [K, T]`` under ``config`` on
    ``device``, sweeping every ``sweep_every`` events (match the
    deployment's ``gc_interval`` cadence), and record occupancy maxima.

    The maxima are read at chunk boundaries, one host read a chunk; a
    dimension that peaks inside a chunk still fires its counter, which
    :func:`autosize` grows."""
    from kafkastreams_cep_tpu_torch.parallel.batch import BatchMatcher

    K = int(events.ts.shape[0])
    batch = BatchMatcher(pattern, K, config, device)
    events = _on(events, batch.device)
    state = batch.init_state()
    chunk = max(int(sweep_every), 1)
    mx = [0] * 6  # alive, entries, npreds, vlen, match len, matches a chunk
    for ev in _chunked(events, chunk):
        state, out = batch.scan(state, ev)
        occupancy = [
            state.alive.sum(dim=-1).max(),
            (state.slab.stage >= 0).sum(dim=-1).max(),
            state.slab.npreds.max().to(torch.int64),
            torch.maximum(state.vlen.max(), state.slab.pvlen.max()).to(torch.int64),
        ]
        if config.lazy_extraction:
            # Lazy configs emit through the drain: drain at chunk cadence
            # (the processor's) and measure there.
            state, dout = batch.drain(state)
            mlen = dout.count.max()
            mchunk = (dout.count > 0).sum(dim=-1).max()
        else:
            mlen = out.count.max()
            # Completions per lane over this chunk: the handle ring must
            # hold one drain interval's worth.
            mchunk = (out.count > 0).sum(dim=(-2, -1)).max()
        got = torch.stack(occupancy + [mlen.to(torch.int64), mchunk]).tolist()
        mx = [max(a, int(b)) for a, b in zip(mx, got)]
        state = batch.sweep(state)
    return ProbeReport(
        counters=batch.counters(state),
        max_alive_runs=mx[0],
        max_live_entries=mx[1],
        max_npreds=mx[2],
        max_vlen=mx[3],
        max_match_len=mx[4],
        max_matches_chunk=mx[5],
        config=config,
    )


def _round8(x: int) -> int:
    return max(8, int(math.ceil(x / 8)) * 8)


def suggest(tables, report: ProbeReport, margin: float = 1.5) -> EngineConfig:
    """An ``EngineConfig`` from a probe report: a run chain holds
    ``max_hops`` frames and every stage can hold a run (the floors), the
    measured maxima get ``margin`` on top; shapes round up to multiples of
    8 except the walk bound, which is work, not storage."""
    S = tables.num_stages
    floor_runs = S + 2
    cfg = report.config
    slab_entries = _round8(max(8, int(report.max_live_entries * margin)))
    return dataclasses.replace(
        cfg,
        max_runs=_round8(max(floor_runs, int(report.max_alive_runs * margin))),
        slab_entries=slab_entries,
        slab_hot_entries=suggest_hot_entries(slab_entries, report.max_alive_runs),
        slab_preds=_round8(max(2, int(report.max_npreds * margin))),
        dewey_depth=_round8(max(tables.max_hops + 2, int(report.max_vlen * margin))),
        max_walk=max(tables.max_hops + 2, int(report.max_match_len * margin) + 2),
        handle_ring=suggest_handle_ring(report.max_matches_chunk, margin),
    )


def suggest_hot_entries(slab_entries: int, max_alive_runs: int) -> int:
    """E_hot for a derived ``slab_entries``: the hot tier is a speed knob
    (drops are the same at any E_hot), sized to the per-step fresh working
    set the live run count bounds; 0 (one tier) below E=32."""
    if slab_entries < 32:
        return 0
    e_hot = _round8(max(8, min(24, 2 * max_alive_runs)))
    return min(e_hot, slab_entries - 8)


def suggest_handle_ring(max_matches_chunk: int, margin: float = 1.5) -> int:
    """HB for a probed per-chunk completion maximum (derived for eager
    configs too, so that a later ``lazy_extraction=True`` inherits it)."""
    return _round8(max(8, int(max_matches_chunk * margin)))


def capacity_counters(counters: Dict[str, int]) -> Dict[str, int]:
    """The capacity-relevant subset of an engine counters dict."""
    return {k: counters[k] for k in _COUNTER_KNOB if k in counters}


def ingest_capacity_counters(stats: Dict[str, int]) -> Dict[str, int]:
    """The knob-growable subset of an ingest guard's stats dict."""
    return {k: stats[k] for k in _INGEST_COUNTER_KNOB if k in stats}


def escalate_ingest(
    policy,
    tripped: Dict[str, int],
    growth: float = 2.0,
    max_policy=None,
):
    """The next wider :class:`~kafkastreams_cep_tpu_torch.runtime.ingest.
    IngestPolicy` for the loss counters in ``tripped`` (name -> positive
    delta).  Forward only: the dropped records are in the dead-letter
    queue already, and widening stops the loss for the rest of the stream.
    None when nothing can grow (at ``max_policy``, or no such counter)."""
    grown = {}
    for counter, delta in tripped.items():
        knob = _INGEST_COUNTER_KNOB.get(counter)
        if knob is None or not delta:
            continue
        cur = getattr(policy, knob)
        new = max(int(math.ceil(cur * growth)), cur + _INGEST_KNOB_FLOOR[knob])
        if max_policy is not None:
            new = min(new, getattr(max_policy, knob))
        if new > cur:
            grown[knob] = new
    if not grown:
        return None
    return dataclasses.replace(policy, **grown)


class EscalationPolicy(NamedTuple):
    """How a live deployment grows capacity when a batch trips a loss
    counter.

    ``growth``     — multiplier for each tripped dimension (shape dims
                     round up to multiples of 8);
    ``hysteresis`` — consecutive tripping batches before an escalation
                     fires (1: on the first trip, the only setting under
                     which nothing is lost);
    ``max_config`` — per-dimension ceiling (None: unbounded);
    ``max_rounds`` — growth rounds tried per batch."""

    growth: float = 2.0
    hysteresis: int = 1
    max_config: Optional[EngineConfig] = None
    max_rounds: int = 4


def escalate(
    config: EngineConfig,
    tripped: Dict[str, int],
    policy: EscalationPolicy = EscalationPolicy(),
) -> Optional[EngineConfig]:
    """The next strictly wider config for the counters in ``tripped``
    (name -> positive delta, mapped to dims as :func:`autosize` maps
    them); None when every tripped dimension is at its ceiling."""
    grown = {}
    for counter, delta in tripped.items():
        knob = _COUNTER_KNOB.get(counter)
        if knob is None or not delta:
            continue
        cur = getattr(config, knob)
        new = int(math.ceil(cur * policy.growth))
        if knob != "max_walk":  # the walk bound is work, not storage
            new = _round8(new)
        if policy.max_config is not None:
            new = min(new, getattr(policy.max_config, knob))
        if new > cur:
            grown[knob] = new
    if not grown:
        return None
    new_cfg = dataclasses.replace(config, **grown)
    # Keep the hot-tier split valid and sized for the grown run count.
    if new_cfg.slab_hot_entries:
        new_cfg = dataclasses.replace(
            new_cfg,
            slab_hot_entries=suggest_hot_entries(
                new_cfg.slab_entries, new_cfg.max_runs // 2
            ),
        )
    return new_cfg


def autosize(
    pattern,
    events: EventBatch,
    start: Optional[EngineConfig] = None,
    margin: float = 1.5,
    sweep_every: int = 16,
    max_iters: int = 6,
    device="cuda",
) -> EngineConfig:
    """Probe -> grow what overflowed -> re-probe -> tighten -> verify, on
    ``device``.

    Returns a config whose capacity counters are all zero on ``events``
    (the sample); raises if ``max_iters`` doublings cannot get there.  A
    heavier stream than the sample can still overflow: the counters stay
    the runtime signal for that."""
    from kafkastreams_cep_tpu_torch.compiler.tables import lower

    cfg = start or EngineConfig(
        max_runs=16, slab_entries=64, slab_preds=8, dewey_depth=16, max_walk=16,
    )
    tables = lower(pattern)
    report = probe(pattern, events, cfg, sweep_every, device)
    for it in range(max_iters):
        hot = {k: v for k, v in capacity_counters(report.counters).items() if v}
        if not hot:
            break
        grown = {_COUNTER_KNOB[c]: getattr(cfg, _COUNTER_KNOB[c]) * 2 for c in hot}
        logger.info("autosize iter %d: grew %s (counters %s)", it, grown, hot)
        cfg = dataclasses.replace(cfg, **grown)
        report = probe(pattern, events, cfg, sweep_every, device)
    hot = {k: v for k, v in capacity_counters(report.counters).items() if v}
    if hot:
        raise RuntimeError(
            f"autosize: counters still nonzero after {max_iters} growth "
            f"iterations: {hot}"
        )
    tight = suggest(tables, report, margin)
    verify = probe(pattern, events, tight, sweep_every, device)
    if any(capacity_counters(verify.counters).values()):
        # The margin under-covered an intra-chunk peak: keep the loose,
        # verified-clean config rather than iterate forever.
        logger.info("autosize: tightened config overflowed (%s); keeping probe config",
                    capacity_counters(verify.counters))
        return report.config
    return tight
