"""``K`` independent per-key matchers stepped together.

The reference runs one NFA per Kafka partition (``CEPProcessor.java:
117-134``); here each lane of the ``[K]`` axis is one such matcher (run
queue + slab), and every step advances all lanes at once.  The step's slab
phase is the hand-written walk-pass kernel when the state lives on a CUDA
device (``ops/walk_kernel.py``), the plain PyTorch pass on the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from kafkastreams_cep_tpu_torch.engine.matcher import (
    COUNTER_NAMES,
    WALK_COUNTER_NAMES,
    EngineConfig,
    EngineState,
    EventBatch,
    StepOutput,
    TPUMatcher,
    counter_values,
    map_value,
    summed,
    walk_counter_values,
)
from kafkastreams_cep_tpu_torch.ops import renorm as renorm_mod
from kafkastreams_cep_tpu_torch.ops import slab as slab_mod


def sweep_lanes(state: EngineState, depth: int, do_renorm: bool) -> EngineState:
    """Per-lane maintenance sweep: slab mark-sweep (frees entries no future
    buffer op can reach), then, when enabled, Dewey version
    renormalization (``ops/renorm.py``).  Pending lazy-extraction handles
    are liveness roots and renormalize with the runs (inert under the
    eager engine, where ``hr_count`` stays 0)."""
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
        ver2, vlen2, slab, _ = renorm_mod.renorm_lane(
            torch.cat([state.ver, state.hr_ver], dim=1),
            torch.cat([state.vlen, state.hr_vlen], dim=1),
            torch.cat([state.alive, pending], dim=1),
            # Handles are never seed runs (a match consumed events).
            torch.cat([state.id_pos, torch.zeros_like(state.hr_vlen)], dim=1),
            state.slab,
        )
        state = state._replace(
            ver=ver2[:, :R], vlen=vlen2[:, :R],
            hr_ver=ver2[:, R:], hr_vlen=vlen2[:, R:], slab=slab,
        )
    return state


def step_events(events: EventBatch, t: int) -> EventBatch:
    """Step ``t`` of a ``[K, T]`` batch as a ``[K]`` batch."""
    return EventBatch(
        key=events.key[:, t],
        value=map_value(lambda x: x[:, t], events.value),
        ts=events.ts[:, t],
        off=events.off[:, t],
        valid=events.valid[:, t],
    )


class BatchMatcher:
    """``K`` per-key matchers as one array program.

    ``step`` consumes one event per lane (``EventBatch`` leaves ``[K]``);
    ``scan`` consumes a ``[K, T]`` batch step by step and returns
    ``[K, T, ...]`` outputs — the shape the processor feeds."""

    def __init__(self, pattern, num_lanes: int,
                 config: Optional[EngineConfig] = None, device="cuda"):
        self.matcher = TPUMatcher(pattern, config, device)
        self.num_lanes = int(num_lanes)
        self.device = self.matcher.device
        self.step = self.matcher.step

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
        outs = []
        for t in range(events.ts.shape[1]):
            state, out = self.step(state, step_events(events, t))
            outs.append(out)
        return state, StepOutput(*(torch.stack(x, dim=1) for x in zip(*outs)))

    def sweep(self, state: EngineState) -> EngineState:
        """Free slab entries unreachable from live runs and renormalize
        versions; ``CEPProcessor(gc_interval=N)`` calls it every N
        batches."""
        cfg = self.matcher.config
        return sweep_lanes(state, cfg.max_walk, cfg.renorm_versions)

    def counters(self, state: EngineState) -> Dict[str, int]:
        """Overflow/drop counters summed over all lanes."""
        return summed(COUNTER_NAMES, counter_values(state))

    def walk_counters(self, state: EngineState) -> Dict[str, int]:
        """Walk-cost counters summed over all lanes (not loss indicators)."""
        return summed(WALK_COUNTER_NAMES, walk_counter_values(state))
