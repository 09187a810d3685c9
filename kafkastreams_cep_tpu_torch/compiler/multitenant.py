"""Bank-level compile pass: the prefix trie and the deduplicated predicate
table of a multi-query bank.

The counterpart of ``kafkastreams_cep_tpu/compiler/multitenant.py`` (a host
module; the port keeps its own copy), whose note gives the reasoning:

* **Residual predicate dedup** (:func:`plan_step_predicates`).  The union of
  a step build's predicates is interned into one merged dispatch table with
  per-query id remaps, split into an *event-level* half (provably
  independent of per-run fold state: evaluated once per event and lane) and
  a *run-level* half (reads fold state: evaluated per run under the owning
  query's decode).  ``engine/matcher.py: _build_step`` consumes the plan
  for every matcher, single-query or stacked.
* **Prefix trie** (:func:`plan_bank`).  Each query's maximal strict prefix
  (``compiler/tiering.py: plan_tiering``) is a path of predicate *columns*;
  every distinct state-independent prefix predicate is one column of a
  bank-wide table, evaluated once per batch by the shared screen
  (``engine/predmatrix.py``, ``parallel/tenantbank.py``).

Sharing is proven, never assumed: a predicate is shared or hoisted to event
level only when :func:`reads_states` proves from its bytecode that the
``states`` argument is never touched, and two predicates unify only when
:func:`predicate_key` renders both to the same structural key (code,
constants, closure cell values, globals identity).
"""

from __future__ import annotations

import dataclasses
import dis
from typing import Any, Dict, Hashable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from kafkastreams_cep_tpu_torch.compiler.tables import TransitionTables, lower
from kafkastreams_cep_tpu_torch.compiler.tiering import (
    TIER_NFA,
    TieringPlan,
    apply_lazy_order,
    plan_tiering,
)
from kafkastreams_cep_tpu_torch.pattern.predicate import Matcher
from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("compiler.multitenant")

#: Positional index of the ``states`` parameter in the predicate calling
#: convention ``pr(key, value, timestamp, states)``.
_STATES_ARG = 3


# ---------------------------------------------------------------------------
# Predicate analysis: state independence + structural identity
# ---------------------------------------------------------------------------


def _code_reads_param(code, index: int) -> bool:
    """Whether ``code`` can observe its positional parameter ``index``.

    True when the parameter name is loaded anywhere (including the fused
    ``LOAD_FAST_LOAD_FAST``-style ops whose argval is a name tuple), or
    is captured by a nested function (``co_cellvars``); stores also count
    (shadowing analysis is not worth the risk).  Conservative: any doubt
    returns True.
    """
    if code.co_argcount <= index:
        # Fewer than 4 positionals: either *args absorbs the states
        # argument (opaque — assume read) or the call would not bind.
        return True
    name = code.co_varnames[index]
    if name in code.co_cellvars:
        return True
    try:
        instructions = list(dis.get_instructions(code))
    except Exception:  # pragma: no cover - dis failure on exotic code
        return True
    for ins in instructions:
        argval = ins.argval
        if argval == name:
            return True
        if isinstance(argval, tuple) and name in argval:
            return True
    return False


def reads_states(matcher: Matcher) -> bool:
    """Whether ``matcher`` can observe the per-run ``states`` argument.

    ``False`` is a *proof* (bytecode never references the parameter, no
    nested closure captures it) that the predicate's value depends only
    on ``(key, value, timestamp)`` — the property that licenses hoisting
    it to one-evaluation-per-event and sharing it across queries.
    Combinators (``and_``/``or_``/``not_``) are state-independent iff
    every operand is; anything without inspectable bytecode is
    conservatively stateful.
    """
    op = getattr(matcher, "op", None)
    parts = getattr(matcher, "parts", None)
    if op in ("and", "or", "not") and parts:
        return any(reads_states(p) for p in parts)
    fn = getattr(matcher, "fn", matcher)
    code = getattr(fn, "__code__", None)
    if code is None:
        return True
    if code.co_flags & 0x08:  # CO_VARKEYWORDS: states may land in **kw
        return True
    return _code_reads_param(code, _STATES_ARG)


class _Unkeyable(Exception):
    """A predicate component with no safe structural key."""


def _freeze(x) -> Hashable:
    """A hashable, type-tagged rendering of one closure/constant value.

    Scalars carry their type name so ``1``, ``1.0`` and ``True`` stay
    distinct (equal-hashing values with different trace dtypes must not
    unify).  Containers freeze element-wise; functions freeze
    structurally; anything else must be hashable or the predicate is
    unkeyable (kept private — correct, just unshared).
    """
    if x is None or isinstance(x, (str, bytes)):
        return x
    if isinstance(x, (bool, int, float, complex)):
        return (type(x).__name__, x)
    if isinstance(x, tuple):
        return ("tuple",) + tuple(_freeze(v) for v in x)
    if isinstance(x, frozenset):
        return ("frozenset", frozenset(_freeze(v) for v in x))
    if isinstance(x, Matcher):
        k = predicate_key(x)
        if k is None:
            raise _Unkeyable
        return ("matcher", k)
    if callable(x):
        return ("fn", _fn_key(x))
    try:
        hash(x)
    except TypeError:
        raise _Unkeyable from None
    return (type(x).__name__, x)


def _fn_key(fn) -> Hashable:
    """Structural identity of one plain function: bytecode, constants,
    referenced global names + the identity of the globals namespace they
    resolve in, defaults, and (recursively frozen) closure cell values."""
    code = getattr(fn, "__code__", None)
    if code is None:
        raise _Unkeyable
    consts = tuple(
        _freeze(c) if not isinstance(c, type(code)) else c.co_code
        for c in code.co_consts
    )
    closure = getattr(fn, "__closure__", None) or ()
    cells = tuple(_freeze(c.cell_contents) for c in closure)
    defaults = tuple(_freeze(d) for d in (fn.__defaults__ or ()))
    return (
        code.co_code,
        consts,
        code.co_names,
        code.co_varnames[: code.co_argcount],
        defaults,
        cells,
        id(getattr(fn, "__globals__", None)),
    )


def predicate_key(matcher: Matcher) -> Optional[Hashable]:
    """A structural identity for ``matcher``, or ``None`` when no safe key
    exists.  Two predicates with equal keys compute the same function of
    ``(key, value, timestamp, states)``: same bytecode, same constants,
    same closure values, same globals namespace.  Combinators key on
    their operator and operand keys (the combinator closures themselves
    are generated per-instance and would never unify)."""
    op = getattr(matcher, "op", None)
    parts = getattr(matcher, "parts", None)
    try:
        if op in ("and", "or", "not") and parts:
            child = tuple(predicate_key(p) for p in parts)
            if any(k is None for k in child):
                return None
            return (op, child)
        fn = getattr(matcher, "fn", None)
        if fn is None:
            return None
        return ("pred", _fn_key(fn))
    except _Unkeyable:
        return None


# ---------------------------------------------------------------------------
# Step-tier predicate plan: merged dispatch table + per-query remaps
# ---------------------------------------------------------------------------


class PredEntry(NamedTuple):
    """One merged-dispatch-table entry."""

    owner: int  # query whose dtype/state conventions decode for it
    pred: Matcher
    stateful: bool  # True: per-run evaluation under the owner's decode


class StepPredPlan(NamedTuple):
    """The merged predicate table for one (possibly stacked) step build.

    ``event_entries`` (ids ``[0, num_event)``) are provably independent
    of per-run fold state: the engine evaluates them ONCE per event (the
    dense predicate-matrix rows).  ``run_entries`` (ids ``[num_event,
    num_event + num_run)``) follow, evaluated per run.  ``remaps[q]``
    maps query ``q``'s local predicate ids into the merged table.
    """

    event_entries: Tuple[PredEntry, ...]
    run_entries: Tuple[PredEntry, ...]
    remaps: Tuple[np.ndarray, ...]
    stats: Dict[str, Any]

    @property
    def num_event(self) -> int:
        return len(self.event_entries)

    @property
    def num_run(self) -> int:
        return len(self.run_entries)


def plan_step_predicates(tlist: Sequence[TransitionTables]) -> StepPredPlan:
    """Dedup + split the union of ``tlist``'s predicate dispatch lists.

    State-independent predicates with a structural key unify across (and
    within) queries and move to the event-level half; everything else
    stays a private run-level entry under its owner's decode — exactly
    today's evaluation, minus the provably redundant copies.
    """
    event_entries: List[PredEntry] = []
    run_entries: List[PredEntry] = []
    interned: Dict[Hashable, int] = {}  # key -> event-entry index
    remaps: List[np.ndarray] = []
    total = 0
    for q, t in enumerate(tlist):
        remap = np.empty(len(t.predicates), dtype=np.int64)
        for pid, pred in enumerate(t.predicates):
            total += 1
            key = predicate_key(pred)
            if key is not None and not reads_states(pred):
                hit = interned.get(key)
                if hit is None:
                    hit = len(event_entries)
                    event_entries.append(PredEntry(q, pred, False))
                    interned[key] = hit
                remap[pid] = hit
            else:
                remap[pid] = -1 - len(run_entries)  # patched below
                run_entries.append(PredEntry(q, pred, True))
        remaps.append(remap)
    # Run-level ids follow the event block; patch the placeholders.
    g0 = len(event_entries)
    for remap in remaps:
        neg = remap < 0
        remap[neg] = g0 + (-1 - remap[neg])
    distinct = g0 + len(run_entries)
    stats = {
        "total_predicates": total,
        "distinct_predicates": distinct,
        "event_level": g0,
        "run_level": len(run_entries),
        "dedup_ratio": (total / distinct) if distinct else 1.0,
    }
    return StepPredPlan(
        tuple(event_entries), tuple(run_entries),
        tuple(remaps), stats,
    )


# ---------------------------------------------------------------------------
# Structural fingerprints (the process-level trace-cache key)
# ---------------------------------------------------------------------------


def tables_key(tables: TransitionTables) -> Optional[Hashable]:
    """A structural fingerprint of one compiled query, or ``None`` when
    any component resists safe hashing.  Two tables with equal keys
    compile to identical step programs, so jitted callables built from
    one serve the other — the process-level trace cache's key
    (``utils/tracecache.py``)."""
    try:
        arrays = tuple(
            np.asarray(a).tobytes()
            for a in (
                tables.types, tables.ident, tables.window_ms,
                tables.consume_op, tables.consume_pred,
                tables.consume_target, tables.ignore_pred,
                tables.proceed_pred, tables.proceed_target,
            )
        )
        preds = tuple(predicate_key(p) for p in tables.predicates)
        if any(k is None for k in preds):
            return None
        aggs = tuple(
            (a.stage, a.state, a.name, _fn_key(a.fn)) for a in tables.aggs
        )
        return (
            tuple(tables.names),
            arrays,
            preds,
            tuple(tables.state_names),
            tuple(_freeze(x) for x in tables.state_inits),
            tuple(tables.state_dtypes),
            aggs,
            int(tables.begin_pos),
            int(tables.final_pos),
            int(tables.max_hops),
            bool(tables.can_branch),
        )
    except _Unkeyable:
        return None


def bank_key(tlist: Sequence[TransitionTables]) -> Optional[Hashable]:
    """Fingerprint of a stacked bank: the tuple of member fingerprints."""
    keys = tuple(tables_key(t) for t in tlist)
    if any(k is None for k in keys):
        return None
    return keys


# ---------------------------------------------------------------------------
# The bank plan: prefix trie + shared column table
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PrefixColumn:
    """One column of the bank-wide prefix screen: a predicate plus the
    query whose fold-state inits form its evaluation environment (only
    observable when the predicate is stateful, i.e. private)."""

    pred: Matcher
    owner: int
    shared: bool  # interned across queries (state-independent + keyed)


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Declared per-query resource shares, enforced at runtime by
    ``parallel/tenantbank.py: TenantBankMatcher`` (the tenant-isolation
    contract — README "Multi-tenant execution").

    Every knob is optional (None = unlimited).  Enforcement is a
    gather-level mask over the shared screen's prefix fires: an
    over-quota tenant's completions are shed (counted per tenant in
    ``quota_shed``) while compliant tenants' screen math is bit-identical
    to an unquotaed bank.

    ``max_live_lanes``    — lanes this query may hold live NFA runs on;
                            measured from the stacked engine state each
                            batch (enforced with a one-batch lag — the
                            usage readback rides the existing gate
                            transfer, costing no extra device sync).
    ``handle_ring_share`` — fraction of the query's aggregate lazy-
                            extraction handle-ring capacity
                            (``K * EngineConfig.handle_ring``) it may
                            hold pending; same one-batch lag.
    ``match_rate_budget`` — token-bucket refill per batch on prefix
                            fires; an empty bucket masks NEW prefix
                            completions (runs already admitted finish).
                            ``match_rate_burst`` caps the bucket
                            (default ``2 * budget`` — a budget of 0
                            sheds from the very first batch).
    ``pred_eval_budget``  — per-batch bound on this query's screen work,
                            counted on offered slots (``K * T *
                            prefix_len`` — deterministic, known before
                            dispatch); an over-budget batch has the
                            query's fires masked for that batch.
    """

    max_live_lanes: Optional[int] = None
    handle_ring_share: Optional[float] = None
    match_rate_budget: Optional[float] = None
    match_rate_burst: Optional[float] = None
    pred_eval_budget: Optional[int] = None

    def __post_init__(self):
        if self.max_live_lanes is not None and self.max_live_lanes < 0:
            raise ValueError("max_live_lanes must be >= 0")
        if self.handle_ring_share is not None and not (
            0.0 < self.handle_ring_share <= 1.0
        ):
            raise ValueError("handle_ring_share must be in (0, 1]")
        if self.match_rate_budget is not None and self.match_rate_budget < 0:
            raise ValueError("match_rate_budget must be >= 0")
        if self.match_rate_burst is not None and self.match_rate_burst < 0:
            raise ValueError("match_rate_burst must be >= 0")
        if self.pred_eval_budget is not None and self.pred_eval_budget < 0:
            raise ValueError("pred_eval_budget must be >= 0")

    @property
    def burst(self) -> float:
        """Token-bucket cap for ``match_rate_budget`` (explicit
        ``match_rate_burst``, else ``2 * budget``)."""
        if self.match_rate_burst is not None:
            return float(self.match_rate_burst)
        return 2.0 * float(self.match_rate_budget or 0.0)


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """One query's routing inside the bank."""

    tables: TransitionTables  # post lazy-order
    plan: TieringPlan
    prefix_cols: Tuple[int, ...]  # column ids, one per prefix stage
    quota: Optional[TenantQuota] = None  # declared isolation contract


@dataclasses.dataclass
class BankPlan:
    """The compiled bank: per-query plans over one shared column table.

    ``trie`` maps every prefix-column path (tuple of column ids) to the
    number of queries whose prefix passes through it; ``groups`` maps
    each *complete* prefix signature to its member query ids — the
    prefix-overlap structure the shared screen exploits and the
    telemetry the docs/bench report."""

    queries: List[QueryPlan]
    columns: List[PrefixColumn]
    trie: Dict[Tuple[int, ...], int]
    groups: Dict[Tuple[int, ...], List[int]]
    stats: Dict[str, Any]


def plan_bank(
    patterns: Sequence,
    config=None,
    profile: Optional[Dict] = None,
    reorder: bool = True,
    quotas: Optional[Sequence[Optional[TenantQuota]]] = None,
) -> BankPlan:
    """Compile N query plans into one bank plan.

    Per query: lazy-chain conjunct ordering (when ``reorder``), then the
    tier split (``plan_tiering``).  Across queries: every distinct
    state-independent prefix predicate becomes ONE shared screen column;
    stateful or unkeyable prefix predicates get private columns under
    their owner's init environment (still evaluated in the same fused
    matrix pass, just not shared).  Residual-tier dedup is reported in
    ``stats`` (the engine applies it per stacked group at build time via
    :func:`plan_step_predicates`).
    """
    tlist = [
        p if isinstance(p, TransitionTables) else lower(p) for p in patterns
    ]
    if quotas is None:
        qlist: List[Optional[TenantQuota]] = [None] * len(tlist)
    else:
        qlist = list(quotas)
        if len(qlist) != len(tlist):
            raise ValueError(
                f"quotas must have one entry per pattern: got {len(qlist)} "
                f"for {len(tlist)} patterns"
            )
    queries: List[QueryPlan] = []
    columns: List[PrefixColumn] = []
    interned: Dict[Hashable, int] = {}
    trie: Dict[Tuple[int, ...], int] = {}
    groups: Dict[Tuple[int, ...], List[int]] = {}
    shared_hits = 0
    total_prefix = 0
    for q, t in enumerate(tlist):
        if reorder:
            t, _ = apply_lazy_order(t, profile)
        plan = plan_tiering(t, config, profile)
        cols: List[int] = []
        for j in range(plan.prefix_len):
            pred = t.predicates[int(t.consume_pred[j])]
            total_prefix += 1
            key = predicate_key(pred)
            if key is not None and not reads_states(pred):
                cid = interned.get(key)
                if cid is None:
                    cid = len(columns)
                    columns.append(PrefixColumn(pred, q, True))
                    interned[key] = cid
                else:
                    shared_hits += 1
                cols.append(cid)
            else:
                cols.append(len(columns))
                columns.append(PrefixColumn(pred, q, False))
        sig = tuple(cols)
        for depth in range(1, len(sig) + 1):
            node = sig[:depth]
            trie[node] = trie.get(node, 0) + 1
        if plan.tier != TIER_NFA:
            groups.setdefault(sig, []).append(q)
        queries.append(QueryPlan(t, plan, sig, quota=qlist[q]))
    pred_plan = plan_step_predicates([qp.tables for qp in queries])
    tiers = [qp.plan.tier for qp in queries]
    stats = {
        "num_queries": len(queries),
        "tiers": {tier: tiers.count(tier) for tier in set(tiers)},
        "prefix_columns_total": total_prefix,
        "prefix_columns_distinct": len(columns),
        "prefix_shared_hit_rate": (
            shared_hits / total_prefix if total_prefix else 0.0
        ),
        "prefix_groups": len(groups),
        "trie_nodes": len(trie),
        "quotas_declared": sum(1 for q in qlist if q is not None),
        **{f"pred_{k}": v for k, v in pred_plan.stats.items()},
    }
    logger.info(
        "bank plan: %d queries, %d/%d distinct prefix columns, "
        "%d prefix groups, predicate dedup %.2fx",
        stats["num_queries"], stats["prefix_columns_distinct"],
        stats["prefix_columns_total"] or 0, stats["prefix_groups"],
        pred_plan.stats["dedup_ratio"],
    )
    return BankPlan(queries, columns, trie, groups, stats)
