"""Multi-tenant query bank: one shared stencil screen for N queries.

The counterpart of ``kafkastreams_cep_tpu/parallel/tenantbank.py`` (whose
note gives the design).  The bank plan (``compiler/multitenant.py:
plan_bank``) is executed as:

* **One predicate matrix.**  Every distinct prefix predicate of the bank is
  one column of a ``[K, T, C]`` boolean matrix (``engine/predmatrix.py``),
  evaluated once per batch.
* **One stencil frontier per prefix length.**  Each non-NFA query's strict
  prefix is a path of column ids; all prefixes of one length advance as
  one recurrence over a leading query axis.  Whole-pattern stencil queries
  end there: their match grids are rendered without an engine
  (``engine/tiered.py: stencil_step_output_stacked``).
* **Grouped residuals.**  Hybrid queries' NFA suffixes stack into
  same-shape engine groups (``engine/matcher.py: _build_step`` stacked
  mode), fed by the stacked promotion (``engine/tiered.py:
  build_promote_stacked``); whole-NFA queries stack into seeded groups.
  Each group's step runs the walk-pass kernel once over all its lanes, and
  a hybrid group with no live run and no promotion this batch is skipped.

The hybrid gates and the usage bundle that the tenant quotas read leave the
device in one host read per scan (:func:`host_read`), as the JAX package's
single ``device_get`` does.

**Isolation** (:class:`TenantIsolation`): a query's declared
:class:`~kafkastreams_cep_tpu_torch.compiler.multitenant.TenantQuota` is
enforced as a mask on its prefix fires inside the screen, sheds counted in
``quota_shed``, with the JAX package's one-batch verdict lag; quarantine
gates the query's own matrix columns dark, invalidates its lanes' events in
its engine group and freezes its state for :meth:`TenantBankMatcher.
reinstate`.  The JAX package's failpoint hooks (no-ops unless armed) are not
part of the port.

Per query, matches, emission order and loss counters equal that query
alone on its own matcher, and the other tenants of a quarantined or shed
one equal a bank without it (``tests/test_torch_multitenant.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from kafkastreams_cep_tpu_torch.compiler.multitenant import (
    BankPlan,
    TenantQuota,
    plan_bank,
)
from kafkastreams_cep_tpu_torch.compiler.tiering import TIER_HYBRID, TIER_NFA
from kafkastreams_cep_tpu_torch.engine.matcher import (
    COUNTER_NAMES,
    HOT_COUNTER_NAMES,
    TIER_COUNTER_NAMES,
    WALK_COUNTER_NAMES,
    DrainOutput,
    EngineConfig,
    EngineState,
    EventBatch,
    StepOutput,
    _build_step,
    build_programs,
    counter_values,
    hot_counter_values,
    per_lane_counter_arrays,
    resolve_device,
    scan_steps,
    step_events,
    walk_counter_values,
)
from kafkastreams_cep_tpu_torch.engine.predmatrix import (
    bank_prefix_scan,
    build_matrix,
    group_bools,
    init_carries,
)
from kafkastreams_cep_tpu_torch.engine.stencil import PrefixCarry, PromoOutput
from kafkastreams_cep_tpu_torch.engine.tiered import (
    build_promote_stacked,
    seedless_init,
    stencil_step_output_stacked,
)
from kafkastreams_cep_tpu_torch.parallel.batch import sweep_lanes
from kafkastreams_cep_tpu_torch.parallel.stacked import replicate_events, tile_states
from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("parallel.tenantbank")

I32 = torch.int32


def host_read(packed: torch.Tensor) -> np.ndarray:
    """The bank scan's one device-to-host read: every hybrid gate and the
    quota usage bundle, packed into one int64 vector."""
    return packed.cpu().numpy()


class TenantState(NamedTuple):
    """Whole-bank state: one stacked ``[Qg * K]`` engine state per residual
    group and one ``[Nq, K]`` stencil carry per prefix-length group."""

    engine: Tuple[EngineState, ...]
    carry: Tuple[PrefixCarry, ...]


@dataclasses.dataclass
class _PrefixGroup:
    """All non-NFA queries whose prefixes have length ``p``: one
    ``[Nq, K]`` carry, one recurrence over the matrix."""

    p: int
    qids: List[int]  # original query ids, member order
    sigs: np.ndarray  # [Nq, p] column ids
    stencil_rows: List[int]  # member rows that are whole-pattern stencil
    stencil_qids: List[int]


@dataclasses.dataclass
class _EngineGroup:
    """One stacked residual group: same-shape queries, one step."""

    kind: str  # "hybrid" | "nfa"
    qids: List[int]
    tlist: list
    p: int  # shared prefix length (0 for nfa)
    pg: Optional[int]  # owning prefix-group index (hybrid only)
    rows: List[int]  # member rows inside the prefix group (hybrid only)
    programs: "_GroupPrograms" = None

    @property
    def Q(self) -> int:
        return len(self.qids)


def _stack_sig(t) -> tuple:
    """The same-shape key ``compiler/tables.py: stackable`` tests."""
    return (t.num_stages, t.max_hops, int(t.begin_pos), int(t.final_pos))


class TenantIsolation:
    """Host-side per-tenant enforcement: token buckets, throttle verdicts,
    quarantine flags and the per-tenant ``quota_shed`` ledger (the JAX
    package's class, verbatim: pure numpy bookkeeping).

    The device sees only the per-batch ``[Nq]`` enabled masks this produces
    and hands back the usage :meth:`observe` consumes, read with the hybrid
    gates, so throttling reacts with a one-batch lag; ``pred_eval_budget``
    usage (``K * T * prefix_len``) is known before dispatch and masks the
    offending batch itself.  :meth:`to_state`/:meth:`load_state` round-trip
    the ledger."""

    def __init__(self, quotas: Sequence[Optional[TenantQuota]], num_lanes: int,
                 config: EngineConfig):
        self.quotas: List[Optional[TenantQuota]] = list(quotas)
        N = len(self.quotas)
        self.K = int(num_lanes)
        self.config = config
        self.quota_shed = np.zeros(N, np.int64)
        self.offered_fires = np.zeros(N, np.int64)
        self.throttled = np.zeros(N, bool)
        self.quarantined = np.zeros(N, bool)
        self.over: List[Tuple[str, ...]] = [() for _ in range(N)]
        self.live_lanes = np.zeros(N, np.int64)
        self.ring_pending = np.zeros(N, np.int64)
        self.tokens = np.full(N, np.inf)
        self.throttle_transitions = 0
        for q, quota in enumerate(self.quotas):
            if quota is None or quota.match_rate_budget is None:
                continue
            self.tokens[q] = quota.burst
            if quota.burst < 1.0:
                # A budget below one fire sheds from the very first batch.
                self.throttled[q] = True
                self.over[q] = ("match_rate_budget",)

    def enabled(self, qids: Sequence[int], p: int, T: int) -> np.ndarray:
        """The ``[Nq]`` fire mask of one prefix group this batch."""
        m = np.ones(len(qids), bool)
        for i, q in enumerate(qids):
            if self.quarantined[q] or self.throttled[q]:
                m[i] = False
                continue
            quota = self.quotas[q]
            if (quota is not None and quota.pred_eval_budget is not None
                    and self.K * T * p > quota.pred_eval_budget):
                m[i] = False
        return m

    def observe(self, fires: np.ndarray, sheds: np.ndarray, live: np.ndarray,
                ring: np.ndarray) -> None:
        """Fold one batch's usage into the ledgers and re-verdict every
        quotaed tenant for the next batch."""
        fires = fires.astype(np.int64)
        sheds = sheds.astype(np.int64)
        self.offered_fires += fires + sheds
        self.quota_shed += sheds
        self.live_lanes = live.astype(np.int64)
        self.ring_pending = ring.astype(np.int64)
        for q, quota in enumerate(self.quotas):
            if quota is None or self.quarantined[q]:
                continue
            over: List[str] = []
            if quota.match_rate_budget is not None:
                self.tokens[q] = min(
                    quota.burst, self.tokens[q] + quota.match_rate_budget
                ) - float(fires[q])
                if self.tokens[q] < 1.0:
                    over.append("match_rate_budget")
            if quota.max_live_lanes is not None and self.live_lanes[q] > quota.max_live_lanes:
                over.append("max_live_lanes")
            if quota.handle_ring_share is not None and self.config.handle_ring > 0:
                cap = quota.handle_ring_share * self.K * self.config.handle_ring
                if self.ring_pending[q] > cap:
                    over.append("handle_ring_share")
            was = bool(self.throttled[q])
            self.throttled[q] = bool(over)
            self.over[q] = tuple(over)
            if was != self.throttled[q]:
                self.throttle_transitions += 1
                logger.warning("tenant q%d %s (over: %s)", q,
                               "throttled" if over else "unthrottled", over or "-")

    def to_state(self) -> Dict[str, object]:
        return {
            "quota_shed": self.quota_shed.copy(),
            "offered_fires": self.offered_fires.copy(),
            "throttled": self.throttled.copy(),
            "quarantined": self.quarantined.copy(),
            "tokens": self.tokens.copy(),
            "live_lanes": self.live_lanes.copy(),
            "ring_pending": self.ring_pending.copy(),
            "over": [tuple(o) for o in self.over],
            "throttle_transitions": self.throttle_transitions,
        }

    def load_state(self, state: Dict[str, object]) -> None:
        self.quota_shed = np.asarray(state["quota_shed"], np.int64).copy()
        self.offered_fires = np.asarray(state["offered_fires"], np.int64).copy()
        self.throttled = np.asarray(state["throttled"], bool).copy()
        self.quarantined = np.asarray(state["quarantined"], bool).copy()
        self.tokens = np.asarray(state["tokens"], np.float64).copy()
        self.live_lanes = np.asarray(state["live_lanes"], np.int64).copy()
        self.ring_pending = np.asarray(state["ring_pending"], np.int64).copy()
        self.over = [tuple(o) for o in state["over"]]
        self.throttle_transitions = int(state["throttle_transitions"])


class _GroupPrograms:
    """One engine group's step, scan and drain over its ``Qg * K`` lanes.

    Both scans take an ``active [Qg]`` member mask (quarantine): an
    inactive member's lanes see their events invalidated (and its
    promotion fires zeroed), which freezes its runs; lanes are
    qid-dispatched and independent, so the active members step exactly as
    in an all-active group."""

    def __init__(self, group: _EngineGroup, cfg: EngineConfig, K: int, device):
        self.group, self.K = group, K
        Qg = group.Q
        self.phases = _build_step(group.tlist, cfg, device)
        self.qids = torch.arange(Qg, dtype=I32, device=device).repeat_interleave(K)
        self.step, self.drain = build_programs(self.phases, cfg, self.qids)
        self.promote = (build_promote_stacked(group.tlist, cfg, group.p)
                        if group.kind == "hybrid" else None)
        self.rows = torch.as_tensor(group.rows, dtype=torch.int64, device=device)

    def init_state(self) -> EngineState:
        per_q = []
        for q in range(self.group.Q):
            s = self.phases.init_state(self.K, q)
            # A hybrid group's begin stage lives on the stencil tier, so its
            # queue starts empty (engine/tiered.py).
            per_q.append(s if self.group.kind == "nfa" else seedless_init(s))
        return tile_states(per_q)

    def _events(self, events: EventBatch, active: torch.Tensor):
        ev = replicate_events(events, self.group.Q)
        lane_on = active.repeat_interleave(self.K)[:, None]
        return ev._replace(valid=ev.valid & lane_on), lane_on

    def _unstack(self, out):
        return type(out)(*(x.reshape((self.group.Q, self.K) + x.shape[1:]) for x in out))

    def scan_nfa(self, state: EngineState, events: EventBatch, active):
        ev, _ = self._events(events, active)
        state, out = scan_steps(self.step, state, ev)
        return state, self._unstack(out)

    def scan_hybrid(self, state: EngineState, events: EventBatch, promo_pg: PromoOutput,
                    active):
        """Step, then promote, each step (a prefix completing at ``t``
        first evaluates at ``t + 1``, the untiered run's schedule)."""
        ev, lane_on = self._events(events, active)
        L = self.group.Q * self.K
        pr = PromoOutput(*(x[self.rows].reshape((L,) + x.shape[2:]) for x in promo_pg))
        fire = pr.fire & lane_on
        promoted = torch.zeros((L,), dtype=I32, device=lane_on.device)
        outs = []
        for t in range(ev.ts.shape[1]):
            state, out = self.step(state, step_events(ev, t))
            state, n = self.promote(state, fire[:, t], pr.offs[:, t], pr.anchor_ts[:, t],
                                    pr.sver[:, t], self.qids)
            promoted = promoted + n
            outs.append(out)
        out = StepOutput(*(torch.stack(x, dim=1) for x in zip(*outs)))
        return state, self._unstack(out), promoted.reshape(self.group.Q, self.K)


class TenantBankMatcher:
    """N queries x ``K`` lanes under one bank plan.

    The :class:`~kafkastreams_cep_tpu_torch.parallel.stacked.
    StackedBankMatcher` surface (``scan``, ``init_state``, ``drain``, the
    counters; outputs ``[N, K, T, R, W]`` decoded per query with
    :meth:`names_of`) without its same-shape requirement: queries group by
    shape inside, and the whole bank shares one prefix screen.  ``names``
    labels the queries for the per-query telemetry (``q0..qN-1`` by
    default); ``quotas`` (a dict by name, or a sequence aligned with
    ``patterns``) declares the enforced isolation contract."""

    def __init__(self, patterns: Sequence, lanes_per_query: int,
                 config: Optional[EngineConfig] = None, profile: Optional[Dict] = None,
                 reorder: bool = True, names: Optional[Sequence[str]] = None,
                 quotas=None, device="cuda"):
        self.config = config or EngineConfig()
        self.device = resolve_device(device)
        self.K = int(lanes_per_query)
        patterns = list(patterns)
        self.query_names = (list(names) if names is not None
                            else [f"q{q}" for q in range(len(patterns))])
        if len(self.query_names) != len(patterns):
            raise ValueError("names must have one entry per pattern")
        if quotas is None:
            qlist: List[Optional[TenantQuota]] = [None] * len(patterns)
        elif isinstance(quotas, dict):
            unknown = set(quotas) - set(self.query_names)
            if unknown:
                raise ValueError(f"quotas for unknown queries: {sorted(unknown)}")
            qlist = [quotas.get(n) for n in self.query_names]
        else:
            qlist = list(quotas)
            if len(qlist) != len(patterns):
                raise ValueError("quotas must have one entry per pattern")
        self.bank: BankPlan = plan_bank(patterns, self.config, profile, reorder, quotas=qlist)
        self.N = len(self.bank.queries)
        self.iso = TenantIsolation([qp.quota for qp in self.bank.queries], self.K,
                                   self.config)
        self.scan_calls = 0
        self.nfa_dispatches = 0

        # Prefix-length groups: the shared screen's frontier.
        by_p: Dict[int, List[int]] = {}
        for q, qp in enumerate(self.bank.queries):
            if qp.plan.tier != TIER_NFA:
                by_p.setdefault(qp.plan.prefix_len, []).append(q)
        self._pgroups: List[_PrefixGroup] = []
        for p in sorted(by_p):
            qids = by_p[p]
            srows = [i for i, q in enumerate(qids)
                     if self.bank.queries[q].plan.tier != TIER_HYBRID]
            self._pgroups.append(_PrefixGroup(
                p=p, qids=qids,
                sigs=np.asarray([self.bank.queries[q].prefix_cols for q in qids], np.int32),
                stencil_rows=srows, stencil_qids=[qids[i] for i in srows],
            ))
        member_row = {(i, q): r for i, pg in enumerate(self._pgroups)
                      for r, q in enumerate(pg.qids)}

        # Residual engine groups.
        groups: Dict[tuple, _EngineGroup] = {}
        for q, qp in enumerate(self.bank.queries):
            if qp.plan.tier == TIER_HYBRID:
                pgi = next(i for i, pg in enumerate(self._pgroups) if q in pg.qids)
                key = ("hybrid", qp.plan.prefix_len, _stack_sig(qp.tables))
                g = groups.setdefault(key, _EngineGroup(
                    kind="hybrid", qids=[], tlist=[], p=qp.plan.prefix_len, pg=pgi,
                    rows=[]))
                g.rows.append(member_row[(pgi, q)])
            elif qp.plan.tier == TIER_NFA:
                key = ("nfa", _stack_sig(qp.tables))
                g = groups.setdefault(key, _EngineGroup(
                    kind="nfa", qids=[], tlist=[], p=0, pg=None, rows=[]))
            else:
                continue
            g.qids.append(q)
            g.tlist.append(qp.tables)
        self._groups: List[_EngineGroup] = list(groups.values())
        for g in self._groups:
            g.programs = _GroupPrograms(g, self.config, self.K, self.device)
        self._hybrid_idx = [i for i, g in enumerate(self._groups) if g.kind == "hybrid"]
        logger.info(
            "tenant bank: %d queries -> %d prefix groups (%d columns, shared hit "
            "rate %.2f), %d engine groups (%d hybrid), predicate dedup %.2fx",
            self.N, len(self._pgroups), self.bank.stats["prefix_columns_distinct"],
            self.bank.stats["prefix_shared_hit_rate"], len(self._groups),
            len(self._hybrid_idx), self.bank.stats["pred_dedup_ratio"],
        )
        # Column -> the queries that use it: quarantine gates a column dark
        # only when every user of it is quarantined.
        self._col_users: Dict[int, set] = {}
        for q, qp in enumerate(self.bank.queries):
            for cid in qp.prefix_cols:
                self._col_users.setdefault(int(cid), set()).add(q)
        self._disabled_cols: frozenset = frozenset()
        self._gactive: List[np.ndarray] = [np.ones(g.Q, bool) for g in self._groups]
        self._screen = self._build_screen() if self._pgroups else None

    # -- the shared screen ---------------------------------------------------

    def _build_screen(self):
        """The whole-bank screen: matrix -> per-group recurrence -> fire
        masks -> stencil synthesis, hybrid gates and the usage bundle.

        ``masks[i]`` is prefix group ``i``'s ``[Nq]`` enabled mask; a
        masked member's fires are zeroed and counted as sheds.  ``hactive``
        keeps a quarantined member's frozen runs out of its group's gate.
        Returns the new carries, the (masked) promotion feeds, the stencil
        outputs and one packed int64 vector: the gates, then per prefix
        group the fires and sheds, then per engine group the live lanes and
        pending handles of each member."""
        matrix_fn = build_matrix(self.bank.columns, [qp.tables for qp in self.bank.queries],
                                 disabled=self._disabled_cols)
        scans = [bank_prefix_scan(pg.p) for pg in self._pgroups]
        synths = [
            (torch.as_tensor(pg.stencil_rows, dtype=torch.int64, device=self.device),
             stencil_step_output_stacked(
                 [self.bank.queries[q].tables for q in pg.stencil_qids], self.config, pg.p))
            if pg.stencil_qids else None
            for pg in self._pgroups
        ]
        hybrids = [(i, self._groups[i].pg, self._groups[i].programs.rows)
                   for i in self._hybrid_idx]
        K = self.K

        def screen(carries, galive, gring, ev: EventBatch, masks, hactive):
            mat = matrix_fn(ev)
            new_carries, promos, souts, usage = [], [], [], []
            sheds_u = []
            for i, pg in enumerate(self._pgroups):
                c2, promo = scans[i](carries[i], group_bools(mat, pg.sigs), ev)
                m3 = masks[i][:, None, None]
                sheds_u.append((promo.fire & ~m3).sum(dim=(1, 2)))
                promo = promo._replace(fire=promo.fire & m3)
                usage.append(promo.fire.sum(dim=(1, 2)))
                new_carries.append(c2)
                promos.append(promo)
                if synths[i] is None:
                    souts.append(None)
                else:
                    srows, synth = synths[i]
                    souts.append(synth(PromoOutput(*(x[srows] for x in promo))))
            gates = [
                (galive[gi] & hactive[h].repeat_interleave(K)[:, None]).any()
                | promos[pgi].fire[rows].any()
                for h, (gi, pgi, rows) in enumerate(hybrids)
            ]
            live = [a.any(dim=-1).reshape(-1, K).sum(dim=1) for a in galive]
            ring = [r.reshape(-1, K).sum(dim=1) for r in gring]
            packed = torch.cat(
                [torch.stack(gates).to(torch.int64) if gates
                 else torch.zeros((0,), dtype=torch.int64, device=self.device)]
                + [x.to(torch.int64) for x in usage + sheds_u + live + ring]
            )
            return new_carries, promos, souts, packed

        return screen

    def _unpack_usage(self, packed: np.ndarray):
        """Split the packed host vector into the gates and the per-query
        fires, sheds, live lanes and pending handles."""
        nh = len(self._hybrid_idx)
        gates, pos = packed[:nh].astype(bool), nh
        per_pg = []
        for _ in range(2):  # fires, then sheds
            vals = np.zeros(self.N, np.int64)
            for pg in self._pgroups:
                vals[pg.qids] = packed[pos:pos + len(pg.qids)]
                pos += len(pg.qids)
            per_pg.append(vals)
        per_g = []
        for _ in range(2):  # live lanes, then pending handles
            vals = np.zeros(self.N, np.int64)
            for g in self._groups:
                vals[g.qids] = packed[pos:pos + g.Q]
                pos += g.Q
            per_g.append(vals)
        return gates, per_pg[0], per_pg[1], per_g[0], per_g[1]

    # -- state ---------------------------------------------------------------

    def names_of(self, q: int) -> List[str]:
        return self.bank.queries[q].tables.names

    def tier_of(self, q: int) -> str:
        return self.bank.queries[q].plan.tier

    def init_state(self) -> TenantState:
        return TenantState(
            engine=tuple(g.programs.init_state() for g in self._groups),
            carry=tuple(init_carries(len(pg.qids), self.K, pg.p, self.device)
                        for pg in self._pgroups),
        )

    # -- the scan ------------------------------------------------------------

    def _zero_out(self, n: int, T: int) -> StepOutput:
        cfg = self.config
        K, R, W = self.K, cfg.max_runs, cfg.max_walk
        dev = self.device
        return StepOutput(
            stage=torch.full((n, K, T, R, W), -1, dtype=I32, device=dev),
            off=torch.full((n, K, T, R, W), -1, dtype=I32, device=dev),
            count=torch.zeros((n, K, T, R), dtype=I32, device=dev),
        )

    def _active(self, i: int) -> torch.Tensor:
        return torch.as_tensor(self._gactive[i], device=self.device)

    def scan(self, state: TenantState, events: EventBatch):
        """One ``[K, T]`` batch through the whole bank; every query sees
        every record.  Outputs ``[N, K, T, R, W]`` in query order."""
        T = int(events.ts.shape[1])
        self.scan_calls += 1
        carries: List[PrefixCarry] = list(state.carry)
        promos, gates = [], np.zeros(0, bool)
        blocks: List[Tuple[List[int], StepOutput]] = []
        if self._screen is not None:
            masks = [torch.as_tensor(self.iso.enabled(pg.qids, pg.p, T), device=self.device)
                     for pg in self._pgroups]
            hactive = [self._active(i) for i in self._hybrid_idx]
            carries, promos, souts, packed = self._screen(
                carries, [e.alive for e in state.engine],
                [e.hr_count for e in state.engine], events, masks, hactive)
            # One transfer: the hybrid gates and the quota usage together.
            gates, fires, sheds, live, ring = self._unpack_usage(host_read(packed))
            for pg, so in zip(self._pgroups, souts):
                if so is not None:
                    blocks.append((pg.stencil_qids, so))
        engines = list(state.engine)
        hseq = 0
        for i, g in enumerate(self._groups):
            progs = g.programs
            if g.kind == "nfa":
                self.nfa_dispatches += 1
                engines[i], out_g = progs.scan_nfa(engines[i], events, self._active(i))
                blocks.append((g.qids, out_g))
                continue
            gate = bool(gates[hseq])
            hseq += 1
            if not gate:
                # Exact skip: stepping an empty group with nothing to
                # promote changes only step_seq.
                engines[i] = engines[i]._replace(step_seq=engines[i].step_seq + T)
                blocks.append((g.qids, self._zero_out(g.Q, T)))
                continue
            self.nfa_dispatches += 1
            engines[i], out_g, promoted = progs.scan_hybrid(
                engines[i], events, promos[g.pg], self._active(i))
            c = carries[g.pg]
            carries[g.pg] = c._replace(
                promotions=c.promotions.index_add(0, progs.rows, promoted))
            blocks.append((g.qids, out_g))
        if self._screen is not None:
            self.iso.observe(fires, sheds, live, ring)
        return (TenantState(engine=tuple(engines), carry=tuple(carries)),
                self._assemble(blocks))

    def _assemble(self, blocks):
        """The per-group ``[n, ...]`` blocks concatenated and permuted back
        to query order along the leading axis."""
        order = np.concatenate([np.asarray(qids, np.int64) for qids, _ in blocks])
        inv = torch.as_tensor(np.argsort(order), device=self.device)
        parts = [out for _, out in blocks]
        return type(parts[0])(*(torch.cat(xs, dim=0)[inv] for xs in zip(*parts)))

    # -- quarantine ----------------------------------------------------------

    @property
    def quarantined_qids(self) -> List[int]:
        return [int(q) for q in np.nonzero(self.iso.quarantined)[0]]

    def quarantine(self, q: int) -> None:
        """Circuit-break query ``q``: the matrix columns only it (and other
        quarantined queries) use go dark, its lanes' events are invalidated
        in its engine group and its fires masked; its state freezes in
        place for :meth:`reinstate`.  Every other query then equals a bank
        built without ``q``."""
        q = int(q)
        if not 0 <= q < self.N:
            raise ValueError(f"no query {q} in a bank of {self.N}")
        if self.iso.quarantined[q]:
            return
        self.iso.quarantined[q] = True
        logger.warning("tenant %s (q%d) quarantined", self.query_names[q], q)
        self._rebuild_enforcement()

    def reinstate(self, q: int) -> None:
        """Lift query ``q``'s quarantine: columns re-enabled, lanes active
        again, its frozen state resumes; re-verdicted at the next batch."""
        q = int(q)
        if not 0 <= q < self.N or not self.iso.quarantined[q]:
            return
        self.iso.quarantined[q] = False
        self.iso.throttled[q] = False
        self.iso.over[q] = ()
        logger.info("tenant %s (q%d) reinstated", self.query_names[q], q)
        self._rebuild_enforcement()

    def _rebuild_enforcement(self) -> None:
        """Recompute the disabled columns (every user quarantined), the
        groups' member masks and the screen (the disabled set is part of
        the matrix evaluator)."""
        quarantined = set(self.quarantined_qids)
        self._disabled_cols = frozenset(
            cid for cid, users in self._col_users.items() if users and users <= quarantined)
        self._gactive = [np.asarray([q not in quarantined for q in g.qids], bool)
                         for g in self._groups]
        self._screen = self._build_screen() if self._pgroups else None

    def iso_state(self) -> Dict[str, object]:
        """The enforcement ledger, for a checkpoint."""
        return self.iso.to_state()

    def load_iso_state(self, state: Dict[str, object]) -> None:
        """Restore the enforcement ledger and rebuild what quarantine
        derives from it."""
        self.iso.load_state(state)
        self._rebuild_enforcement()

    # -- maintenance and drains ---------------------------------------------

    def sweep(self, state: TenantState) -> TenantState:
        """Each engine group's maintenance sweep; the stencil carries own no
        slab entries, so nothing else is swept."""
        depth, renorm = self.config.max_walk, self.config.renorm_versions
        return state._replace(engine=tuple(sweep_lanes(e, depth, renorm)
                                           for e in state.engine))

    def drain(self, state: TenantState):
        """Every engine group's pending lazy-extraction handles; returns
        ``[N, K, HB, ...]`` in query order (whole-pattern stencil queries
        own no handles: their rows are the empty drain)."""
        cfg = self.config
        HB, W, K = cfg.handle_ring, cfg.max_walk, self.K
        engines = list(state.engine)
        blocks: List[Tuple[List[int], DrainOutput]] = []
        covered: set = set()
        for i, g in enumerate(self._groups):
            engines[i], d = g.programs.drain(engines[i])
            blocks.append((g.qids, DrainOutput(*(x.reshape((g.Q, K) + x.shape[1:])
                                                 for x in d))))
            covered.update(g.qids)
        rest = [q for q in range(self.N) if q not in covered]
        if rest:
            n, dev = len(rest), self.device

            def full(shape):
                return torch.full(shape, -1, dtype=I32, device=dev)

            blocks.append((rest, DrainOutput(
                stage=full((n, K, HB, W)), off=full((n, K, HB, W)),
                count=torch.zeros((n, K, HB), dtype=I32, device=dev),
                seq=full((n, K, HB)), row=full((n, K, HB)), ts=full((n, K, HB)),
            )))
        return state._replace(engine=tuple(engines)), self._assemble(blocks)

    # -- telemetry -----------------------------------------------------------

    def _summed(self, state: TenantState, names, values_fn) -> Dict[str, int]:
        tot = dict.fromkeys(names, 0)
        for eng in state.engine:
            vals = torch.stack([v.reshape(-1).to(torch.int64).sum()
                                for v in values_fn(eng)]).tolist()
            for n, v in zip(names, vals):
                tot[n] += int(v)
        return tot

    def counters(self, state: TenantState) -> Dict[str, int]:
        return self._summed(state, COUNTER_NAMES, counter_values)

    def hot_counters(self, state: TenantState) -> Dict[str, int]:
        return self._summed(state, HOT_COUNTER_NAMES, hot_counter_values)

    def walk_counters(self, state: TenantState) -> Dict[str, int]:
        return self._summed(state, WALK_COUNTER_NAMES, walk_counter_values)

    def tier_counters(self, state: TenantState) -> Dict[str, int]:
        """Lane- and query-summed tier counters over every prefix group."""
        vals = [0, 0, 0]
        for c in state.carry:
            got = torch.stack([c.screened.to(torch.int64).sum(),
                               c.fires.to(torch.int64).sum(),
                               c.promotions.to(torch.int64).sum()]).tolist()
            vals = [a + int(b) for a, b in zip(vals, got)]
        return dict(zip(TIER_COUNTER_NAMES, vals))

    def per_query_counters(self, state: TenantState) -> Dict[str, Dict[str, int]]:
        """Per query: loss, hot-tier and walk counters over its ``K``-lane
        block of its group, its stencil-tier counters and its isolation
        ledger.  Whole-pattern stencil queries report zero engine
        counters."""
        names = COUNTER_NAMES + HOT_COUNTER_NAMES + WALK_COUNTER_NAMES
        per_q: Dict[int, Dict[str, int]] = {q: dict.fromkeys(names, 0)
                                            for q in range(self.N)}
        for g, eng in zip(self._groups, state.engine):
            arrays = per_lane_counter_arrays(eng)
            for r, q in enumerate(g.qids):
                for n, v in arrays.items():
                    per_q[q][n] = int(v.reshape(g.Q, self.K)[r].sum())
        for q in range(self.N):
            per_q[q].update(dict.fromkeys(TIER_COUNTER_NAMES, 0))
        for pg, c in zip(self._pgroups, state.carry):
            scr, fr, pr = (x.to(torch.int64).sum(dim=1).tolist()
                           for x in (c.screened, c.fires, c.promotions))
            for r, q in enumerate(pg.qids):
                per_q[q][TIER_COUNTER_NAMES[0]] = int(scr[r])
                per_q[q][TIER_COUNTER_NAMES[1]] = int(fr[r])
                per_q[q][TIER_COUNTER_NAMES[2]] = int(pr[r])
        for q in range(self.N):
            per_q[q]["quota_shed"] = int(self.iso.quota_shed[q])
            per_q[q]["quota_throttled"] = int(self.iso.throttled[q])
            per_q[q]["quarantined"] = int(self.iso.quarantined[q])
        return {self.query_names[q]: per_q[q] for q in range(self.N)}

    def metrics_snapshot(self, state: TenantState) -> Dict[str, object]:
        """Bank-wide telemetry: the summed engine and tier counters, the
        plan's sharing stats, the isolation totals, the dispatch gating and
        the ``per_query`` breakdown."""
        out: Dict[str, object] = {}
        out.update(self.counters(state))
        out.update(self.hot_counters(state))
        out.update(self.walk_counters(state))
        out.update(self.tier_counters(state))
        out["bank_queries"] = self.N
        out["bank_prefix_groups"] = len(self._pgroups)
        out["bank_engine_groups"] = len(self._groups)
        out["bank_pred_dedup_ratio"] = float(self.bank.stats["pred_dedup_ratio"])
        out["bank_prefix_shared_hit_rate"] = float(
            self.bank.stats["prefix_shared_hit_rate"])
        out["quota_shed_total"] = int(self.iso.quota_shed.sum())
        out["quota_throttled_queries"] = int(self.iso.throttled.sum())
        out["quarantined_queries"] = int(self.iso.quarantined.sum())
        out["quota_throttle_transitions"] = int(self.iso.throttle_transitions)
        out["bank_scan_calls"] = int(self.scan_calls)
        out["bank_nfa_dispatches"] = int(self.nfa_dispatches)
        opportunities = int(self.scan_calls) * max(len(self._groups), 1)
        out["bank_nfa_dispatch_fraction"] = (
            round(int(self.nfa_dispatches) / opportunities, 6) if opportunities else None)
        out["per_query"] = self.per_query_counters(state)
        return out
