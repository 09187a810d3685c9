"""The stencil tier: a strict sequence (or a query's strict-contiguity
prefix) over a whole ``[K, T]`` batch at once.

The counterpart of ``kafkastreams_cep_tpu/engine/stencil.py`` (its note
cites the reference): :class:`StencilMatcher` matches a whole branch-free
strict sequence; ``PrefixCarry``, ``PromoOutput`` and ``StencilPrefix``
serve the first tier of a tiered query.  A strict sequence of ``n`` stages
completes at event ``t`` iff stage ``i``'s predicate holds on event
``t-n+1+i`` for every ``i``: ``n`` boolean columns ANDed under shifts, with
the trailing ``n-1`` valid events carried across batches.

A strict prefix of ``p`` stages neither branches nor
skips: the begin stage re-seeds a run at every event and strict contiguity
kills a run at the first event its stage rejects, so the prefix completes
at event ``t`` iff stage ``j`` accepted event ``t-p+1+j`` for every ``j``.
That is ``p`` boolean columns ANDed under shifts, parallel over lanes and
time.  A carry of the last ``p-1`` valid events makes it exact across
batches.

At each completion the tier hands the NFA tier (``engine/tiered.py``)
everything the untiered run would carry there: the ``p`` event offsets, the
window anchor (the second window event for ``p >= 2``, the root for
``p == 1``: the reference re-anchors the window while a run's identity is
BEGIN-typed) and the Dewey root ``1 + begin-accepts before the window
root``.  Predicates see the fold states' declared initial values, decoded
to each state's dtype: prefix stages have no folds, so that is what every
untiered prefix run sees.

Plain PyTorch on the device of its inputs; the JAX package runs it as jnp,
not as a Pallas kernel.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from kafkastreams_cep_tpu_torch.compiler.tables import (
    OP_BEGIN,
    TransitionTables,
    lower,
)
from kafkastreams_cep_tpu_torch.engine.matcher import ArrayStates, EventBatch

I32 = torch.int32


class PrefixCarry(NamedTuple):
    """The prefix tier's state across batches: the trailing ``p-1`` valid
    events' stage booleans, offsets, timestamps and seed versions, the
    begin-accept count that generates those versions, and the tier
    counters (device state, so they checkpoint with the engine)."""

    bools: torch.Tensor  # [K, p-1, p] bool — per-stage predicate values
    offs: torch.Tensor  # [K, p-1] int32 — event offsets (-1 = none yet)
    ts: torch.Tensor  # [K, p-1] int32 — rebased event timestamps
    sver: torch.Tensor  # [K, p-1] int32 — seed version at each event
    cnt: torch.Tensor  # [K] int32 — begin-accepts seen
    screened: torch.Tensor  # [K] int32 — valid events the prefix screened
    fires: torch.Tensor  # [K] int32 — prefix completions
    promotions: torch.Tensor  # [K] int32 — runs promoted into the NFA tier


class PromoOutput(NamedTuple):
    """The promotion feed for the NFA tier, per batch slot: whether the
    prefix completed there, its ``p`` event offsets, the window anchor and
    the first Dewey digit of the promoted run."""

    fire: torch.Tensor  # [K, T] bool
    offs: torch.Tensor  # [K, T, p] int32
    anchor_ts: torch.Tensor  # [K, T] int32
    sver: torch.Tensor  # [K, T] int32


def init_states(tables: TransitionTables, device) -> ArrayStates:
    """The fold states' declared initial values, each in its dtype."""
    return ArrayStates({
        name: torch.tensor(
            init, dtype=torch.float32 if dt == "float32" else I32, device=device
        )
        for name, init, dt in zip(
            tables.state_names, tables.state_inits, tables.state_dtypes
        )
    })


def _trailing(ext: torch.Tensor, start: torch.Tensor, n: int) -> torch.Tensor:
    """``ext[k, start[k] : start[k] + n]`` per lane (along dim 1)."""
    idx = start[:, None].long() + torch.arange(n, device=ext.device)[None, :]
    idx = idx.reshape(idx.shape + (1,) * (ext.dim() - 2)).expand(
        (ext.shape[0], n) + ext.shape[2:]
    )
    return ext.gather(1, idx)


class StencilPrefix:
    """Stencil evaluation of the leading ``prefix_len`` stages of a query
    (the split ``compiler/tiering.py`` chose) over ``num_lanes`` lanes.

    ``scan(carry, events)`` consumes a ``[K, T]`` :class:`EventBatch` whose
    valid slots form a per-lane prefix and returns ``(carry, PromoOutput)``.
    """

    def __init__(self, tables, num_lanes: int, prefix_len: int):
        self.tables: TransitionTables = (
            tables if isinstance(tables, TransitionTables) else lower(tables)
        )
        t = self.tables
        p = int(prefix_len)
        n = t.num_stages - 1
        if not 0 < p <= n:
            raise ValueError(f"prefix_len={p} outside 1..{n}")
        if (np.any(t.consume_op[:p] != OP_BEGIN) or np.any(t.ignore_pred[:p] >= 0)
                or np.any(t.proceed_pred[:p] >= 0)
                or any(slot.stage < p for slot in t.aggs)):
            raise ValueError(
                f"stages [0, {p}) are not a strict-contiguity prefix; run "
                "compiler.tiering.plan_tiering first"
            )
        self.num_lanes = int(num_lanes)
        self.p = p
        self._preds = [t.predicates[t.consume_pred[j]] for j in range(p)]

    def init_carry(self, device) -> PrefixCarry:
        K, p = self.num_lanes, self.p
        z = torch.zeros((K,), dtype=I32, device=device)
        return PrefixCarry(
            bools=torch.zeros((K, p - 1, p), dtype=torch.bool, device=device),
            offs=torch.full((K, p - 1), -1, dtype=I32, device=device),
            ts=torch.zeros((K, p - 1), dtype=I32, device=device),
            sver=torch.ones((K, p - 1), dtype=I32, device=device),
            cnt=z, screened=z.clone(), fires=z.clone(), promotions=z.clone(),
        )

    def scan(self, carry: PrefixCarry, ev: EventBatch
             ) -> Tuple[PrefixCarry, PromoOutput]:
        p = self.p
        K, T = ev.ts.shape
        dev = ev.ts.device
        states = init_states(self.tables, dev)
        valid = ev.valid.to(torch.bool)
        bools = torch.stack(
            [
                torch.as_tensor(pr(ev.key, ev.value, ev.ts, states), device=dev)
                .to(torch.bool).expand(K, T) & valid
                for pr in self._preds
            ],
            dim=-1,
        )  # [K, T, p]
        return prefix_recurrence(p, carry, bools, ev.off.to(I32), ev.ts.to(I32), valid)


def prefix_recurrence(p: int, carry: PrefixCarry, bools: torch.Tensor,
                      offs: torch.Tensor, ts: torch.Tensor, valid: torch.Tensor
                      ) -> Tuple[PrefixCarry, PromoOutput]:
    """The prefix tier's recurrence over ``[K, T]``, the stage predicates
    already evaluated: ``bools [K, T, p]`` (valid-masked), ``offs``/``ts``
    ``[K, T]`` int32, ``valid [K, T]`` (a per-lane prefix of slots)."""
    T = ts.shape[1]
    b0 = bools[..., 0].to(I32)
    # Seed version at each slot: 1 + begin-accepts strictly before it
    # (the untiered seed bumps its version at every accept).
    sver = 1 + carry.cnt[:, None] + (torch.cumsum(b0, dim=1, dtype=I32) - b0)
    ext_b = torch.cat([carry.bools, bools], dim=1)
    ext_off = torch.cat([carry.offs, offs], dim=1)
    ext_ts = torch.cat([carry.ts, ts], dim=1)
    ext_sver = torch.cat([carry.sver, sver], dim=1)
    # fire[k, t] = AND_j ext_b[k, t + j, j]: stage j saw event t-p+1+j.
    fire = ext_b[:, 0:T, 0]
    for j in range(1, p):
        fire = fire & ext_b[:, j:j + T, j]
    offs_out = torch.stack([ext_off[:, j:j + T] for j in range(p)], dim=-1)
    a = min(1, p - 1)  # the window anchor's column
    # The new carry: the trailing p-1 valid columns, which end at
    # column c + p - 1 (valid slots are a per-lane prefix).
    c = valid.sum(dim=1, dtype=I32)
    new = PrefixCarry(
        bools=_trailing(ext_b, c, p - 1),
        offs=_trailing(ext_off, c, p - 1),
        ts=_trailing(ext_ts, c, p - 1),
        sver=_trailing(ext_sver, c, p - 1),
        cnt=carry.cnt + b0.sum(dim=1, dtype=I32),
        screened=carry.screened + c,
        fires=carry.fires + fire.sum(dim=1, dtype=I32),
        promotions=carry.promotions,
    )
    return new, PromoOutput(
        fire=fire, offs=offs_out, anchor_ts=ext_ts[:, a:a + T].contiguous(),
        sver=ext_sver[:, 0:T].contiguous(),
    )


class StencilState(NamedTuple):
    """:class:`StencilMatcher`'s carry across batches: the trailing ``n-1``
    valid events."""

    bools: torch.Tensor  # [K, n-1, n] bool — per-stage predicate values
    offs: torch.Tensor  # [K, n-1] int32 — event offsets (-1 = none yet)


class StencilOutput(NamedTuple):
    """``hit[k, t]``: a match completed at batch slot ``t``; ``offs[k, t,
    i]``: the offset of that match's stage-``i`` event."""

    hit: torch.Tensor  # [K, T] bool
    offs: torch.Tensor  # [K, T, n] int32


class StencilMatcher:
    """The stencil matcher of one branch-free strict sequence (every stage
    of cardinality one, strict contiguity, no folds: ``TransitionTables.
    is_strict_seq``) over ``num_lanes`` lanes.

    ``scan(state, events)`` consumes a ``[K, T]`` :class:`EventBatch` whose
    valid slots form a per-lane prefix (the processor's padding) and
    returns every completed match; no step depends on the one before, so
    the whole batch is a few elementwise passes on the device of its
    inputs.  ``device`` is where :meth:`init_state` puts the carry."""

    def __init__(self, pattern, num_lanes: int, device="cuda"):
        from kafkastreams_cep_tpu_torch.engine.matcher import resolve_device

        self.tables: TransitionTables = (
            pattern if isinstance(pattern, TransitionTables) else lower(pattern)
        )
        if not self.tables.is_strict_seq():
            raise ValueError(
                "pattern is not a branch-free strict sequence; use TPUMatcher"
            )
        self.device = resolve_device(device)
        self.num_lanes = int(num_lanes)
        n = self.tables.num_stages - 1
        if np.any(self.tables.consume_op[:n] != OP_BEGIN):
            raise ValueError("a strict sequence consumes every stage by BEGIN")
        self.n = n
        #: Stage names in chain order, for decoding matches.
        self.stage_names: List[str] = self.tables.names[:n]
        self._preds = [
            self.tables.predicates[self.tables.consume_pred[i]] for i in range(n)
        ]

    def init_state(self) -> StencilState:
        K, n = self.num_lanes, self.n
        return StencilState(
            bools=torch.zeros((K, max(n - 1, 0), n), dtype=torch.bool, device=self.device),
            offs=torch.full((K, max(n - 1, 0)), -1, dtype=I32, device=self.device),
        )

    def scan(self, state: StencilState, ev: EventBatch
             ) -> Tuple[StencilState, StencilOutput]:
        n = self.n
        K, T = ev.ts.shape
        dev = ev.ts.device
        valid = ev.valid.to(torch.bool)
        empty = ArrayStates({})
        bools = torch.stack(
            [
                torch.as_tensor(p(ev.key, ev.value, ev.ts, empty), device=dev)
                .to(torch.bool).expand(K, T) & valid
                for p in self._preds
            ],
            dim=-1,
        )  # [K, T, n]
        offs = ev.off.to(I32)
        if n == 1:
            return state, StencilOutput(hit=bools[..., 0], offs=offs[..., None])
        ext_b = torch.cat([state.bools, bools], dim=1)  # [K, T+n-1, n]
        ext_off = torch.cat([state.offs, offs], dim=1)
        # hit[k, t] = AND_i ext_b[k, t+i, i]: stage i saw event t-n+1+i.
        hit = ext_b[:, 0:T, 0]
        for i in range(1, n):
            hit = hit & ext_b[:, i:i + T, i]
        match_offs = torch.stack([ext_off[:, i:i + T] for i in range(n)], dim=-1)
        # The new carry: the trailing n-1 valid columns, one gather a leaf.
        c = valid.sum(dim=1, dtype=I32)
        carry = StencilState(_trailing(ext_b, c, n - 1), _trailing(ext_off, c, n - 1))
        return carry, StencilOutput(hit, match_offs)

    def decode(self, out: StencilOutput, events_by_offset, lane_keys=None):
        """Host side: the matches as ``(lane, slot, Sequence)``, stages
        added final first (the reference's backward buffer walk);
        ``events_by_offset[k]`` maps lane ``k``'s offsets to events."""
        from kafkastreams_cep_tpu_torch.utils.events import Sequence

        hit = out.hit.cpu().numpy()
        offs = out.offs.cpu().numpy()
        matches = []
        for k, t in zip(*np.nonzero(hit)):
            seq = Sequence()
            for i in range(self.n - 1, -1, -1):
                seq.add(self.stage_names[i], events_by_offset[k][int(offs[k, t, i])])
            matches.append((int(k), int(t), seq))
        return matches
