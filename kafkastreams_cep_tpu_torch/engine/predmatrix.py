"""Dense predicate matrix: every distinct bank predicate once per batch.

The counterpart of ``kafkastreams_cep_tpu/engine/predmatrix.py``.  The
multi-tenant bank (``parallel/tenantbank.py``) screens N queries' strict
prefixes over one shared ``[K, T]`` batch.  After the bank compile pass
(``compiler/multitenant.py: plan_bank``) the distinct prefix predicates form
a column table; :func:`build_matrix` evaluates it as one ``[K, T, C]``
boolean matrix, each distinct predicate once per batch however many queries
use it.  Each query's prefix is then a gather of ``p`` columns
(:func:`group_bools`), and a whole group of equal-length prefixes advances
with one recurrence over a leading query axis (:func:`bank_prefix_scan`):
the ``[Nq, K]`` lanes of the group are stepped together, not one query at a
time.

Exactness: the recurrence is ``engine/stencil.py: prefix_recurrence``, the
one :class:`~kafkastreams_cep_tpu_torch.engine.stencil.StencilPrefix` runs;
a shared column is provably state-independent, so its empty states view
equals any owner's init view, and a private column is evaluated under its
owner query's init view.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from kafkastreams_cep_tpu_torch.compiler.multitenant import PrefixColumn
from kafkastreams_cep_tpu_torch.compiler.tables import TransitionTables
from kafkastreams_cep_tpu_torch.engine.matcher import ArrayStates, EventBatch
from kafkastreams_cep_tpu_torch.engine.stencil import (
    PrefixCarry,
    PromoOutput,
    init_states,
    prefix_recurrence,
)

I32 = torch.int32


def owner_states(tables: TransitionTables, device) -> ArrayStates:
    """The fold-state init view a prefix predicate sees: prefix stages
    precede every fold, so an untiered run in its prefix sees exactly
    these values (``StencilPrefix`` builds the same view)."""
    return init_states(tables, device)


def build_matrix(columns: Sequence[PrefixColumn],
                 owner_tables: Sequence[TransitionTables], disabled: Sequence[int] = ()):
    """An evaluator ``matrix(ev) -> [K, T, C]`` bool for the bank's prefix
    column table, each value ANDed with ``ev.valid``.

    ``disabled`` columns (those only quarantined tenants use) come out
    constant False without calling their predicate, so a quarantined
    tenant's predicate can neither raise nor cost screen work."""
    dis = frozenset(int(c) for c in disabled)

    def matrix(ev: EventBatch) -> torch.Tensor:
        K, T = ev.valid.shape
        dev = ev.valid.device
        valid = ev.valid.to(torch.bool)
        cols = []
        for ci, col in enumerate(columns):
            if ci in dis:
                cols.append(torch.zeros((K, T), dtype=torch.bool, device=dev))
                continue
            env = ArrayStates({}) if col.shared else owner_states(
                owner_tables[col.owner], dev)
            got = torch.as_tensor(col.pred(ev.key, ev.value, ev.ts, env), device=dev)
            cols.append(got.to(torch.bool).expand(K, T) & valid)
        if not cols:
            return torch.zeros((K, T, 0), dtype=torch.bool, device=dev)
        return torch.stack(cols, dim=-1)

    return matrix


def group_bools(matrix: torch.Tensor, sigs: np.ndarray) -> torch.Tensor:
    """One prefix group's stage booleans ``[Nq, K, T, p]`` gathered from
    the matrix by its ``[Nq, p]`` column-id table."""
    cols = torch.as_tensor(np.asarray(sigs, dtype=np.int64), device=matrix.device)
    return matrix[:, :, cols].permute(2, 0, 1, 3)


def single_prefix_scan(p: int):
    """The prefix recurrence for one query's ``[K]`` lanes, predicates
    already evaluated: ``scan(carry, bools [K, T, p], offs, ts, valid) ->
    (carry, PromoOutput)``."""
    def scan(carry: PrefixCarry, bools, offs, ts, valid):
        return prefix_recurrence(p, carry, bools, offs, ts, valid)

    return scan


def bank_prefix_scan(p: int):
    """The recurrence for a whole prefix group: ``scan(carries, bools_q,
    ev) -> (carries, PromoOutput)`` with a leading ``[Nq]`` query axis on
    the carries, ``bools_q [Nq, K, T, p]`` and the outputs, and the event
    batch shared.  The group's ``Nq * K`` lanes run as one recurrence."""
    def scan(carries: PrefixCarry, bools_q: torch.Tensor, ev: EventBatch
             ) -> Tuple[PrefixCarry, PromoOutput]:
        Nq, K, T = bools_q.shape[:3]

        def flat(x):
            return x.reshape((Nq * K,) + x.shape[2:])

        def rep(x):
            return x.to(I32)[None].expand(Nq, K, T).reshape(Nq * K, T)

        valid = ev.valid.to(torch.bool)[None].expand(Nq, K, T).reshape(Nq * K, T)
        carry, promo = prefix_recurrence(
            p, PrefixCarry(*(flat(x) for x in carries)), flat(bools_q),
            rep(ev.off), rep(ev.ts), valid,
        )

        def unflat(x):
            return x.reshape((Nq, K) + x.shape[1:])

        return (PrefixCarry(*(unflat(x) for x in carry)),
                PromoOutput(*(unflat(x) for x in promo)))

    return scan


def init_carries(num_queries: int, num_lanes: int, p: int, device) -> PrefixCarry:
    """``[Nq]``-stacked :class:`PrefixCarry`: per query, exactly
    ``StencilPrefix.init_carry`` (fresh screen, seed version 1)."""
    Nq, K = int(num_queries), int(num_lanes)
    z = torch.zeros((Nq, K), dtype=I32, device=device)
    return PrefixCarry(
        bools=torch.zeros((Nq, K, p - 1, p), dtype=torch.bool, device=device),
        offs=torch.full((Nq, K, p - 1), -1, dtype=I32, device=device),
        ts=torch.zeros((Nq, K, p - 1), dtype=I32, device=device),
        sver=torch.ones((Nq, K, p - 1), dtype=I32, device=device),
        cnt=z, screened=z.clone(), fires=z.clone(), promotions=z.clone(),
    )
