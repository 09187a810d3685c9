"""Tier promotion: seed NFA suffix runs from the stencil prefix's
completions.

The counterpart of ``kafkastreams_cep_tpu/engine/tiered.py`` (its note
traces each choice to the reference).  At every event where the prefix
completes, :func:`build_promote` injects into the NFA engine exactly the run
and the shared-buffer chain the untiered engine would hold then:

* the Dewey version ``[v, 0, ..., 0]`` of length ``p``, ``v`` the seed
  version at the window root (``p <= dewey_depth`` by the plan);
* the window start ``anchor_ts`` (``engine/stencil.py``);
* the run appended after the live queue prefix (compaction keeps live runs
  contiguous), so suffix runs keep creation order and emission order;
* the prefix chain's buffer writes replayed: ``put_first`` at the root and
  one chained ``put`` per later stage, under the promoted version.

A promotion that finds the queue full counts in ``run_drops``.  The
promotion is the plain version of the whole-scan kernel's promotion phase
(``csrc/scan_pass.cu``, ``kPromo``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from kafkastreams_cep_tpu_torch.engine.matcher import (
    EngineConfig,
    EngineState,
    StepOutput,
)
from kafkastreams_cep_tpu_torch.engine.stencil import PrefixCarry, PromoOutput
from kafkastreams_cep_tpu_torch.ops import slab as slab_mod

I32 = torch.int32


class TieredState(NamedTuple):
    """A tiered matcher's state: the NFA engine state and the stencil
    prefix carry (checkpointed as ``engine/...`` and ``carry/...``)."""

    engine: EngineState
    carry: PrefixCarry


def engine_view(state) -> EngineState:
    """The :class:`EngineState` inside ``state``: itself for an engine
    state, the ``engine`` field of a :class:`TieredState`."""
    return getattr(state, "engine", state)


def seedless_init(state: EngineState) -> EngineState:
    """``state`` (an initial engine state) without its seed run: under
    tiering the begin stage lives on the stencil tier, so the queue starts
    empty and only promotions fill it."""
    return state._replace(
        alive=torch.zeros_like(state.alive),
        eval_pos=torch.zeros_like(state.eval_pos),
        ver=torch.zeros_like(state.ver),
        vlen=torch.zeros_like(state.vlen),
    )


def _encoded_inits(tables) -> list:
    """The fold states' initial values as the engine stores them (int32,
    float32 states as their bit pattern), padded to at least one."""
    out = [
        int(np.float32(x).view(np.int32)) if dt == "float32" else int(np.int32(x))
        for x, dt in zip(tables.state_inits, tables.state_dtypes)
    ]
    return out + [0] * (max(tables.num_states, 1) - tables.num_states)


class Promote:
    """One tiering plan's promotion step over ``[K]`` lanes:
    ``promote(state, fire, offs, anchor_ts, sver) -> (state, n_promoted
    [K])`` with ``fire [K]``, ``offs [K, p]``, ``anchor_ts [K]``, ``sver
    [K]`` (one batch slot of a :class:`PromoOutput`).

    ``prefix_len``, ``idents`` (the prefix stages' identities) and
    ``eval_pos`` (the appended run's eval position) are what the kernel's
    promotion phase takes as arguments."""

    def __init__(self, tables, cfg: EngineConfig, prefix_len: int):
        p = int(prefix_len)
        D = cfg.dewey_depth
        if not 0 < p <= D:
            raise ValueError(
                f"prefix_len={p} must be in 1..dewey_depth={D} (the promoted "
                "version carries one digit per prefix stage)"
            )
        self.prefix_len = p
        self.idents = [int(tables.ident[j]) for j in range(p)]
        self.eval_pos = int(tables.consume_target[p - 1])
        self.max_runs = cfg.max_runs
        self.hot_entries = cfg.slab_hot_entries
        self.inits = _encoded_inits(tables)

    def __call__(self, state: EngineState, fire, offs, anchor_ts, sver
                 ) -> Tuple[EngineState, torch.Tensor]:
        K = state.ver.shape[0]
        dev = state.alive.device
        idents = torch.tensor(self.idents, dtype=I32, device=dev).expand(K, -1)
        eval_pos = torch.full((K,), self.eval_pos, dtype=I32, device=dev)
        inits = torch.tensor(self.inits, dtype=I32, device=dev).expand(K, -1)
        return promote_runs(state, fire, offs, anchor_ts, sver, idents, eval_pos,
                            inits, self.max_runs, self.hot_entries)


def promote_runs(state: EngineState, fire, offs, anchor_ts, sver, idents,
                 eval_pos, inits, max_runs: int, hot_entries: int
                 ) -> Tuple[EngineState, torch.Tensor]:
    """The promotion of one batch slot over ``[K]`` lanes, with each lane's
    prefix stage identities ``idents [K, p]``, appended run's eval position
    ``eval_pos [K]`` and encoded fold inits ``inits [K, NS]``."""
    R, EH = max_runs, hot_entries
    p = idents.shape[1]
    dev = state.alive.device
    K, D = state.ver.shape[0], state.ver.shape[2]
    fire = fire.to(torch.bool)
    cnt = state.alive.sum(dim=1, dtype=I32)
    fit = fire & (cnt < R)
    ver = torch.zeros((K, D), dtype=I32, device=dev)
    ver[:, 0] = sver
    slab = slab_mod.put_first(
        state.slab, idents[:, 0].contiguous(), offs[:, 0], ver,
        torch.ones((K,), dtype=I32, device=dev), fit, hot_entries=EH,
    )
    for j in range(1, p):
        slab = slab_mod.put(
            slab, idents[:, j].contiguous(), offs[:, j], idents[:, j - 1].contiguous(),
            offs[:, j - 1], ver, torch.full((K,), j + 1, dtype=I32, device=dev),
            fit, hot_entries=EH,
        )
    # The live runs are a contiguous prefix: the new run goes at row cnt.
    row = (torch.arange(R, device=dev)[None, :] == cnt[:, None]) & fit[:, None]

    def put_row(field, value):
        m = row.reshape(row.shape + (1,) * (field.dim() - 2))
        return torch.where(m, torch.as_tensor(value, device=dev).to(field.dtype), field)

    state = state._replace(
        alive=put_row(state.alive, True),
        id_pos=put_row(state.id_pos, idents[:, p - 1:p]),
        eval_pos=put_row(state.eval_pos, eval_pos[:, None]),
        ver=put_row(state.ver, ver[:, None, :]),
        vlen=put_row(state.vlen, p),
        event_off=put_row(state.event_off, offs[:, p - 1:p]),
        start_ts=put_row(state.start_ts, anchor_ts[:, None]),
        branching=put_row(state.branching, False),
        agg=put_row(state.agg, inits[:, None, :]),
        slab=slab,
        run_drops=state.run_drops + (fire & ~fit).to(I32),
    )
    return state, fit.to(I32)


class StackedPromote:
    """The promotion step of a group of stacked queries with one prefix
    length (``kafkastreams_cep_tpu/engine/tiered.py: build_promote_stacked``):
    ``promote(state, fire, offs, anchor_ts, sver, qids) -> (state,
    n_promoted [K])``, each lane with its own query's stage identities, eval
    position and fold inits, gathered by ``qids [K]``; otherwise
    :class:`Promote` verbatim."""

    def __init__(self, tlist, cfg: EngineConfig, prefix_len: int):
        p = int(prefix_len)
        D = cfg.dewey_depth
        if not 0 < p <= D:
            raise ValueError(
                f"prefix_len={p} must be in 1..dewey_depth={D} (the promoted "
                "version carries one digit per prefix stage)"
            )
        NS = max(max(t.num_states for t in tlist), 1)
        self.prefix_len = p
        self.idents = [[int(t.ident[j]) for j in range(p)] for t in tlist]  # [Q, p]
        self.eval_pos = [int(t.consume_target[p - 1]) for t in tlist]  # [Q]
        self.inits = [_encoded_inits(t) + [0] * (NS - max(t.num_states, 1))
                      for t in tlist]  # [Q, NS]
        self.max_runs = cfg.max_runs
        self.hot_entries = cfg.slab_hot_entries
        self._dev = {}

    def _tables(self, dev):
        if dev not in self._dev:
            self._dev[dev] = tuple(torch.tensor(x, dtype=I32, device=dev)
                                   for x in (self.idents, self.eval_pos, self.inits))
        return self._dev[dev]

    def __call__(self, state: EngineState, fire, offs, anchor_ts, sver, qids
                 ) -> Tuple[EngineState, torch.Tensor]:
        idents, eval_pos, inits = self._tables(state.alive.device)
        q = qids.long()
        return promote_runs(state, fire, offs, anchor_ts, sver, idents[q], eval_pos[q],
                            inits[q], self.max_runs, self.hot_entries)


def build_promote(tables, cfg: EngineConfig, prefix_len: int) -> Promote:
    """The promotion step of one tiering plan (see :class:`Promote`)."""
    return Promote(tables, cfg, prefix_len)


def build_promote_stacked(tlist, cfg: EngineConfig, prefix_len: int) -> StackedPromote:
    """The promotion step of a stacked group (see :class:`StackedPromote`)."""
    return StackedPromote(tlist, cfg, prefix_len)


def stencil_step_output(tables, cfg: EngineConfig, prefix_len: int):
    """The whole-pattern stencil tier's output: each completion rendered as
    the ``[K, T, R, W]`` :class:`StepOutput` the untiered extraction walk
    would emit (stage identities final first, offsets backward, one match
    in row 0).  Needs ``prefix_len <= max_walk``."""
    p = int(prefix_len)
    R, W = cfg.max_runs, cfg.max_walk
    if p > W:
        raise ValueError(f"pure-stencil tier needs prefix_len={p} <= max_walk={W}")
    rev_ident = [int(tables.ident[j]) for j in range(p - 1, -1, -1)]

    def synth(promo: PromoOutput) -> StepOutput:
        K, T = promo.fire.shape
        dev = promo.fire.device
        fire = promo.fire[..., None]
        stage = torch.full((K, T, R, W), -1, dtype=I32, device=dev)
        off = torch.full((K, T, R, W), -1, dtype=I32, device=dev)
        rid = torch.tensor(rev_ident, dtype=I32, device=dev)
        stage[:, :, 0, :p] = torch.where(fire, rid, -1)
        off[:, :, 0, :p] = torch.where(fire, promo.offs.flip(-1), -1)
        count = torch.zeros((K, T, R), dtype=I32, device=dev)
        count[:, :, 0] = torch.where(promo.fire, p, 0)
        return StepOutput(stage=stage, off=off, count=count)

    return synth


def stencil_step_output_stacked(tlist, cfg: EngineConfig, prefix_len: int):
    """:func:`stencil_step_output` for a group of whole-pattern stencil
    queries with one prefix length: ``synth(promo) -> StepOutput [N, K, T,
    R, W]`` from ``[N]``-stacked :class:`PromoOutput` leaves, each member
    with its own stage identities."""
    p = int(prefix_len)
    R, W = cfg.max_runs, cfg.max_walk
    if p > W:
        raise ValueError(f"pure-stencil tier needs prefix_len={p} <= max_walk={W}")
    rev_idents = [[int(t.ident[j]) for j in range(p - 1, -1, -1)] for t in tlist]

    def synth(promo: PromoOutput) -> StepOutput:
        N, K, T = promo.fire.shape
        dev = promo.fire.device
        fire = promo.fire[..., None]
        rid = torch.tensor(rev_idents, dtype=I32, device=dev)[:, None, None, :]
        stage = torch.full((N, K, T, R, W), -1, dtype=I32, device=dev)
        off = torch.full((N, K, T, R, W), -1, dtype=I32, device=dev)
        stage[:, :, :, 0, :p] = torch.where(fire, rid, -1)
        off[:, :, :, 0, :p] = torch.where(fire, promo.offs.flip(-1), -1)
        count = torch.zeros((N, K, T, R), dtype=I32, device=dev)
        count[:, :, :, 0] = torch.where(promo.fire, p, 0)
        return StepOutput(stage=stage, off=off, count=count)

    return synth


def empty_carry(num_lanes: int, device) -> PrefixCarry:
    """The carry of a plan with no prefix tier (zero-width windows, zero
    counters), so every tiered config has one state shape."""
    K = num_lanes
    z = torch.zeros((K,), dtype=I32, device=device)
    return PrefixCarry(
        bools=torch.zeros((K, 0, 0), dtype=torch.bool, device=device),
        offs=torch.zeros((K, 0), dtype=I32, device=device),
        ts=torch.zeros((K, 0), dtype=I32, device=device),
        sver=torch.zeros((K, 0), dtype=I32, device=device),
        cnt=z, screened=z.clone(), fires=z.clone(), promotions=z.clone(),
    )
