"""The stencil prefix tier: a query's strict-contiguity prefix over a whole
``[K, T]`` batch at once.

The counterpart of the prefix half of ``kafkastreams_cep_tpu/engine/
stencil.py`` (``PrefixCarry``, ``PromoOutput``, ``StencilPrefix``; its note
cites the reference).  A strict prefix of ``p`` stages neither branches nor
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

from typing import NamedTuple, Tuple

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
