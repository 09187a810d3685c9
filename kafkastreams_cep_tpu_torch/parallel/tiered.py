"""The tiered matcher: the stencil prefix tier in front of the NFA tier.

The counterpart of ``kafkastreams_cep_tpu/parallel/tiered.py``: the
:class:`BatchMatcher` surface (``scan``, ``sweep``, ``drain``, the
counters) over the tiering plan of ``compiler/tiering.py``.
``CEPProcessor`` builds it when ``EngineConfig.tiering`` is set.

* ``nfa``     — no usable prefix: the inner :class:`BatchMatcher` does
  everything; the state is still a :class:`TieredState`.
* ``stencil`` — the whole pattern is a strict sequence: the prefix tier is
  the matcher, its completions are rendered as the engine's output grid and
  the NFA engine only ticks ``step_seq``.
* ``hybrid``  — the stencil screens the whole ``[K, T]`` batch first, then
  the NFA tier runs with a promotion after every engine step
  (``engine/tiered.py``).  Two ways:

  - per step (the default): the batch is cut into ``gate_chunk``-step
    chunks, and a chunk in which no lane holds a live suffix run and the
    prefix completes nowhere is skipped (``step_seq`` advances by its
    length, its output is empty).  The JAX package decides that on the
    device with ``lax.cond``; eager PyTorch cannot skip launches without
    reading the flag, so this path reads one flag per chunk
    (:func:`gate_flag`) and that is its only host read.  The ragged tail is
    a shorter chunk, never padded (padding would tick ``step_seq`` past the
    batch);
  - ``CEP_SCAN_KERNEL=1``: one launch of the tiered whole-scan kernel per
    batch (``ops/scan_kernel.py``, ``promo=``), gated per lane and step
    inside the kernel, with no host read.  Only the code generator's
    :class:`~kafkastreams_cep_tpu_torch.ops.scan_codegen.LoweringError`
    swaps it for the per-step path, for good, and that is logged.

Matches, emission order and loss counters equal the untiered engine's on
loss-free workloads (``tests/test_torch_tiering.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from kafkastreams_cep_tpu_torch.compiler.tables import TransitionTables, lower
from kafkastreams_cep_tpu_torch.compiler.tiering import (
    TIER_NFA,
    TIER_STENCIL,
    TieringPlan,
    apply_lazy_order,
    plan_tiering,
)
from kafkastreams_cep_tpu_torch.engine.matcher import (
    TIER_COUNTER_NAMES,
    EngineConfig,
    EngineState,
    EventBatch,
    StepOutput,
    step_events,
    summed,
)
from kafkastreams_cep_tpu_torch.engine.stencil import StencilPrefix
from kafkastreams_cep_tpu_torch.engine.tiered import (
    TieredState,
    build_promote,
    empty_carry,
    seedless_init,
    stencil_step_output,
)
from kafkastreams_cep_tpu_torch.ops import scan_kernel
from kafkastreams_cep_tpu_torch.parallel.batch import BatchMatcher
from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("parallel.tiered")

I32 = torch.int32


def gate_flag(needed: torch.Tensor) -> bool:
    """The per-step hybrid path's chunk gate, read on the host: its one
    host read per ``gate_chunk`` chunk."""
    return bool(needed)


class TieredBatchMatcher:
    """``K`` lanes matched under a compiler tiering plan.

    ``profile`` is a measured ``per_stage`` snapshot (a
    ``stage_attribution`` run's ``stage_counters``) for the lazy-chain
    conjunct ordering; without it the static cost model orders them.
    ``reorder=False`` skips the ordering."""

    def __init__(self, pattern, num_lanes: int,
                 config: Optional[EngineConfig] = None,
                 profile: Optional[Dict] = None, reorder: bool = True,
                 device="cuda"):
        tables = pattern if isinstance(pattern, TransitionTables) else lower(pattern)
        config = config or EngineConfig()
        if reorder:
            tables, self.lazy_order = apply_lazy_order(tables, profile)
        else:
            self.lazy_order = {}
        self.plan: TieringPlan = plan_tiering(tables, config, profile)
        self.tables = tables
        self.num_lanes = int(num_lanes)
        self.inner = BatchMatcher(tables, num_lanes, config, device)
        self.matcher = self.inner.matcher
        self.device = self.inner.device
        logger.info("tiered matcher: %s (%s), %d lanes",
                    self.plan.tier, self.plan.reason, self.num_lanes)
        # Dispatch accounting, on the host: scans, gate chunks offered on
        # the per-step path, and NFA dispatches (whole batches on the nfa
        # tier and the kernel path, chunks that ran on the per-step path).
        self.scan_calls = 0
        self.gate_chunks = 0
        self.nfa_dispatches = 0
        self._prefix = None
        self._tiered_kernel = False
        p = self.plan.prefix_len
        if self.plan.tier != TIER_NFA:
            self._prefix = StencilPrefix(tables, num_lanes, p)
            self._promote = build_promote(tables, config, p)
            if self.plan.tier == TIER_STENCIL:
                self._synth = stencil_step_output(tables, config, p)
            elif self.inner.uses_scan_kernel:
                self._tiered_kernel = True
                logger.info("tiered matcher: whole-scan kernel enabled")

    # -- state ---------------------------------------------------------------

    @property
    def names(self) -> List[str]:
        return self.inner.names

    @property
    def uses_scan_kernel(self) -> bool:
        """Whether scans run a whole-scan kernel: the untiered one on the
        nfa tier, the tiered one on the hybrid tier; never on the stencil
        tier, which has no NFA work."""
        if self.plan.tier == TIER_NFA:
            return self.inner.uses_scan_kernel
        return self._tiered_kernel

    def init_state(self) -> TieredState:
        eng = self.inner.init_state()
        if self.plan.tier == TIER_NFA:
            return TieredState(eng, empty_carry(self.num_lanes, self.device))
        # The begin stage lives on the stencil tier: the queue starts empty.
        return TieredState(seedless_init(eng), self._prefix.init_carry(self.device))

    # -- the scan ------------------------------------------------------------

    def scan(self, state: TieredState, events: EventBatch):
        """One ``[K, T]`` batch through the plan; returns ``(state,
        StepOutput [K, T, ...])`` as :meth:`BatchMatcher.scan` does."""
        T = int(events.ts.shape[1])
        self.scan_calls += 1
        if self.plan.tier == TIER_NFA:
            self.nfa_dispatches += 1
            eng, out = self.inner.scan(state.engine, events)
            return TieredState(eng, state.carry), out
        # The stencil and hybrid tiers never reach inner.scan: the measured
        # conjunct tally (stage_attribution) accumulates here, once a batch.
        self.inner._accumulate_conjuncts(events)
        carry, promo = self._prefix.scan(state.carry, events)
        if self.plan.tier == TIER_STENCIL:
            eng = state.engine._replace(step_seq=state.engine.step_seq + T)
            return TieredState(eng, carry), self._synth(promo)
        source = self.inner._scan_source(events) if self._tiered_kernel else None
        if self._tiered_kernel and source is None:
            logger.warning("tiered whole-scan kernel cannot express this pattern; "
                           "falling back to the chunk-gated per-step path")
            self._tiered_kernel = False
        if source is not None:
            self.nfa_dispatches += 1
            eng, out, promoted = scan_kernel.scan_pass(
                source, self.matcher.config, self.inner.phases, state.engine,
                events, promo=(self._promote, promo),
            )
        else:
            eng, out, promoted = self._chunked_scan(state.engine, events, promo)
        carry = carry._replace(promotions=carry.promotions + promoted)
        return TieredState(eng, carry), out

    def _chunked_scan(self, eng: EngineState, events: EventBatch, promo):
        """The per-step hybrid path: each step, then its promotions, under
        a gate per ``gate_chunk`` chunk.  Step first, then promote: a prefix
        completing at ``t`` first evaluates at ``t + 1``, the untiered
        run's schedule; so a completion's first effect lies in its own
        chunk, which the gate never skips."""
        cfg = self.matcher.config
        C = max(int(cfg.gate_chunk), 1)
        K, T = events.ts.shape
        R, W = cfg.max_runs, cfg.max_walk
        promoted = torch.zeros((K,), dtype=I32, device=self.device)
        outs = []
        for c0 in range(0, T, C):
            c1 = min(c0 + C, T)
            self.gate_chunks += 1
            if not gate_flag(eng.alive.any() | promo.fire[:, c0:c1].any()):
                # Exact: a stepped empty queue with nothing to promote
                # changes only step_seq.
                eng = eng._replace(step_seq=eng.step_seq + (c1 - c0))
                outs.append(StepOutput(
                    torch.full((K, c1 - c0, R, W), -1, dtype=I32, device=self.device),
                    torch.full((K, c1 - c0, R, W), -1, dtype=I32, device=self.device),
                    torch.zeros((K, c1 - c0, R), dtype=I32, device=self.device),
                ))
                continue
            self.nfa_dispatches += 1
            steps = []
            for t in range(c0, c1):
                eng, out = self.inner.step(eng, step_events(events, t))
                eng, n = self._promote(eng, promo.fire[:, t], promo.offs[:, t],
                                       promo.anchor_ts[:, t], promo.sver[:, t])
                promoted = promoted + n
                steps.append(out)
            outs.append(StepOutput(*(torch.stack(x, dim=1) for x in zip(*steps))))
        return eng, StepOutput(*(torch.cat(x, dim=1) for x in zip(*outs))), promoted

    # -- maintenance / drains ------------------------------------------------

    def sweep(self, state: TieredState) -> TieredState:
        """The engine tier's sweep; the carry owns no slab entries."""
        return state._replace(engine=self.inner.sweep(state.engine))

    def drain(self, state: TieredState):
        eng, out = self.inner.drain(state.engine)
        return state._replace(engine=eng), out

    # -- telemetry -----------------------------------------------------------

    def counters(self, state: TieredState) -> Dict[str, int]:
        return self.inner.counters(state.engine)

    def hot_counters(self, state: TieredState) -> Dict[str, int]:
        return self.inner.hot_counters(state.engine)

    def walk_counters(self, state: TieredState) -> Dict[str, int]:
        return self.inner.walk_counters(state.engine)

    def per_lane_counters(self, state: TieredState) -> Dict[str, list]:
        return self.inner.per_lane_counters(state.engine)

    def stage_counters(self, state: TieredState) -> Dict[str, Dict[str, Any]]:
        return self.inner.stage_counters(state.engine)

    def tier_counters(self, state: TieredState) -> Dict[str, int]:
        """Lane-summed tier counters in ``TIER_COUNTER_NAMES`` order: events
        the prefix screened, prefix completions, promoted runs."""
        c = state.carry
        return summed(TIER_COUNTER_NAMES, (c.screened, c.fires, c.promotions))

    def metrics_snapshot(self, state: TieredState) -> Dict[str, object]:
        out = self.inner.metrics_snapshot(state.engine)
        out.update(self.tier_counters(state))
        out["tier_scan_calls"] = self.scan_calls
        out["tier_gate_chunks"] = self.gate_chunks
        out["tier_nfa_dispatches"] = self.nfa_dispatches
        return out
