"""Compiler tiering: split each query at its maximal strict prefix, and
order each stage's conjuncts.

The counterpart of ``kafkastreams_cep_tpu/compiler/tiering.py`` (whose
module note gives the reasoning and the window no-prune proof):

* :func:`plan_tiering` splits a query into its **maximal strict prefix**
  (leading chain positions consuming via BEGIN with no IGNORE, no PROCEED
  and no fold; each is one stencil column, ``engine/stencil.py``) and the
  **residual suffix**, which keeps the full NFA semantics.  The hybrid
  matcher (``parallel/tiered.py``) runs the prefix over the whole
  ``[K, T]`` batch at once and promotes a run into the NFA tier only where
  the prefix completes.  Under ``EngineConfig.enforce_windows`` a windowed
  pattern stays on the NFA (:func:`check_no_prune`);
* :func:`apply_lazy_order` reorders every stage's commuting conjunct chain
  so cheap, selective conjuncts gate expensive ones (rank = selectivity x
  cost, ascending); selectivity comes from a measured ``per_stage``
  profile or ``selectivity_hint``, cost from ``cost_hint`` or the
  closure's bytecode length;
* under ``EngineConfig.stage_attribution`` every conjunct of every
  consuming-edge predicate is evaluated over each scanned batch
  (:func:`build_conjunct_tally`), so each one's marginal accept fraction is
  measured.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from kafkastreams_cep_tpu_torch.compiler.tables import (
    OP_BEGIN,
    TransitionTables,
    lower,
)
from kafkastreams_cep_tpu_torch.engine.stencil import init_states
from kafkastreams_cep_tpu_torch.pattern.predicate import Matcher, _normalize
from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("compiler.tiering")

# Tier labels.
TIER_STENCIL = "stencil"  # the whole pattern on the stencil tier, no NFA
TIER_HYBRID = "hybrid"  # strict prefix on the stencil, suffix on the NFA
TIER_NFA = "nfa"  # no usable prefix: the whole query on the NFA


@dataclasses.dataclass(frozen=True)
class TieringPlan:
    """One query's tier routing decision."""

    tier: str  # TIER_STENCIL | TIER_HYBRID | TIER_NFA
    prefix_len: int  # stages on the stencil tier (0 for TIER_NFA)
    reason: str  # why the plan is what it is

    def describe(self) -> Dict[str, Any]:
        return {"tier": self.tier, "prefix_len": self.prefix_len,
                "reason": self.reason}


def strict_prefix_len(tables: TransitionTables) -> int:
    """The maximal strict-contiguity prefix of ``tables``: leading chain
    positions consuming via BEGIN with no IGNORE edge, no PROCEED edge and
    no fold at the position."""
    agg_stages = {slot.stage for slot in tables.aggs}
    p = 0
    for j in range(tables.num_stages - 1):  # $final excluded
        if (
            tables.consume_op[j] != OP_BEGIN
            or tables.ignore_pred[j] >= 0
            or tables.proceed_pred[j] >= 0
            or j in agg_stages
        ):
            break
        p += 1
    return p


def check_no_prune(tables: TransitionTables, config) -> Optional[str]:
    """``None`` when the window no-prune proof holds for routing a prefix to
    the stencil tier, else why it fails: under ``enforce_windows`` any set
    window can prune a partial prefix, which the stencil cannot do."""
    if not getattr(config, "enforce_windows", False):
        return None
    if np.any(tables.window_ms != -1):
        w = int(tables.window_ms[tables.window_ms != -1].max())
        return (
            f"enforce_windows=True with a {w} ms within() window: "
            "functional pruning can fire inside the prefix, which the "
            "stencil tier cannot reproduce"
        )
    return None


def plan_tiering(pattern_or_tables, config=None,
                 profile: Optional[Dict] = None) -> TieringPlan:
    """The tier split of one compiled query under ``config``.

    Beyond :func:`strict_prefix_len`: the no-prune proof must hold (else
    the whole query stays NFA); ``prefix_len <= dewey_depth`` (a promoted
    run carries one version digit per prefix stage); the whole-pattern
    stencil needs ``prefix_len <= max_walk`` and no ``lazy_extraction``,
    else the plan is capped to a hybrid.  ``profile`` is accepted for
    parity with :func:`apply_lazy_order`; the split is structural."""
    tables = (pattern_or_tables if isinstance(pattern_or_tables, TransitionTables)
              else lower(pattern_or_tables))
    del profile
    n = tables.num_stages - 1
    p = strict_prefix_len(tables)
    if p == 0:
        return TieringPlan(TIER_NFA, 0, "no strict-contiguity prefix")
    no_prune = check_no_prune(tables, config) if config is not None else None
    if no_prune is not None:
        return TieringPlan(TIER_NFA, 0, f"no-prune proof failed: {no_prune}")
    reason = f"maximal strict prefix {p}/{n}"
    if config is not None and p > config.dewey_depth:
        p = int(config.dewey_depth)
        reason += f", capped to dewey_depth={p}"
        if p == 0:
            return TieringPlan(TIER_NFA, 0, reason)
    if p == n:
        if config is not None and getattr(config, "lazy_extraction", False):
            p = n - 1
            reason += ", capped below n (lazy_extraction drains via the NFA)"
        elif config is not None and p > config.max_walk:
            p = n - 1
            reason += f", capped below n (max_walk={config.max_walk} < n)"
        else:
            return TieringPlan(TIER_STENCIL, p, reason + " (whole pattern)")
    if p == 0:
        return TieringPlan(TIER_NFA, 0, reason)
    return TieringPlan(TIER_HYBRID, p, reason)


def conjuncts(matcher: Matcher) -> List[Matcher]:
    """Flatten an ``and_`` tree into its conjunct list (left to right).
    Anything that is not an ``and_`` node, ``or_``/``not_`` subtrees
    included, is one opaque conjunct."""
    if getattr(matcher, "op", None) == "and":
        out: List[Matcher] = []
        for part in matcher.parts:
            out.extend(conjuncts(part))
        return out
    return [matcher]


def predicate_cost(matcher: Matcher) -> float:
    """Static relative cost of one evaluation of ``matcher``: ``cost_hint``
    when declared, the sum of the parts for a combinator, else the bytecode
    length of its function (16 for a function without bytecode)."""
    if getattr(matcher, "cost_hint", None) is not None:
        return float(matcher.cost_hint)
    parts = getattr(matcher, "parts", ())
    if parts:
        return sum(predicate_cost(p) for p in parts)
    code = getattr(matcher.fn, "__code__", None)
    if code is None:
        return 16.0
    return float(len(code.co_code))


def conjunct_key(m: Matcher) -> str:
    """A stable, order-invariant name for one conjunct: its label and the
    code location of its function (labels alone collide: every lambda is
    ``<lambda>``)."""
    code = getattr(m.fn, "__code__", None)
    if code is None:
        return m.label
    return f"{m.label}@{os.path.basename(code.co_filename)}:{code.co_firstlineno}"


def conjunct_tally_plan(tables) -> List[Tuple[str, str, Matcher]]:
    """One ``(stage_name, key, matcher)`` slot per distinct conjunct of each
    consuming-edge predicate, in declaration order (a key repeated within
    a stage takes one slot)."""
    tables = tables if isinstance(tables, TransitionTables) else lower(tables)
    slots: List[Tuple[str, str, Matcher]] = []
    for j in range(tables.num_stages - 1):
        pid = int(tables.consume_pred[j])
        if pid < 0:
            continue
        seen = set()
        for m in conjuncts(tables.predicates[pid]):
            key = conjunct_key(m)
            if key not in seen:
                seen.add(key)
                slots.append((tables.names[j], key, m))
    return slots


def build_conjunct_tally(tables):
    """``(slots, tally)``: :func:`conjunct_tally_plan`'s layout and
    ``tally(counts, ev)``, which adds one ``[K, T]`` batch to a ``[2, P]``
    int32 count tensor — row 0 the valid events each conjunct was offered,
    row 1 its accepts.  Each conjunct sees every valid event against the
    fold states' declared initial values, so the measured rate is the
    marginal accept fraction.  Runs on the device of ``counts``."""
    tables = tables if isinstance(tables, TransitionTables) else lower(tables)
    slots = conjunct_tally_plan(tables)
    matchers = [m for _, _, m in slots]

    def tally(counts, ev):
        if not matchers:
            return counts
        dev = counts.device
        states = init_states(tables, dev)
        valid = ev.valid.to(torch.bool)
        evals = valid.sum(dtype=torch.int32)
        accepts = torch.stack([
            (torch.as_tensor(m(ev.key, ev.value, ev.ts, states), device=dev)
             .to(torch.bool).expand(valid.shape) & valid).sum(dtype=torch.int32)
            for m in matchers
        ])
        return counts + torch.stack([evals.expand(len(matchers)), accepts])

    return slots, tally


def _conjunct_selectivity(m: Matcher, stage_sel: Optional[float],
                          conjunct_sel: Optional[Dict[str, float]] = None) -> float:
    """Estimated accept fraction of one conjunct: its measured selectivity,
    else its ``selectivity_hint``, else the stage's measured selectivity,
    else 0.5."""
    if conjunct_sel:
        s = conjunct_sel.get(conjunct_key(m))
        if s is not None:
            return float(s)
    if getattr(m, "selectivity_hint", None) is not None:
        return float(m.selectivity_hint)
    if stage_sel is not None:
        return float(stage_sel)
    return 0.5


def order_conjuncts(matcher: Matcher, stage_sel: Optional[float] = None,
                    conjunct_sel: Optional[Dict[str, float]] = None
                    ) -> Tuple[List[Matcher], bool]:
    """One stage predicate's conjuncts ranked by estimated ``selectivity x
    cost`` ascending, stable within ties: ``(ordered, changed)``."""
    parts = conjuncts(matcher)
    if len(parts) < 2:
        return parts, False
    ranked = sorted(
        range(len(parts)),
        key=lambda i: (
            _conjunct_selectivity(parts[i], stage_sel, conjunct_sel)
            * predicate_cost(parts[i]),
            i,
        ),
    )
    return [parts[i] for i in ranked], ranked != list(range(len(parts)))


def _ordered_and(parts: List[Matcher]) -> Matcher:
    """A conjunction evaluating ``parts`` in list order: host bools
    short-circuit left to right, tensors (or the whole-scan code
    generator's traced values) combine with ``&`` in the same order."""

    def fn(key, value, timestamp, states):
        acc: Any = True
        for p in parts:
            v = _normalize(p(key, value, timestamp, states))
            if isinstance(acc, bool) and isinstance(v, bool):
                if not v:
                    return False
            else:
                acc = v if acc is True else acc & v
        return acc

    m = Matcher(fn, label="and(" + ",".join(p.label for p in parts) + ")")
    m.op = "and"
    m.parts = tuple(parts)
    return m


def _measured_conjuncts(row) -> Optional[Dict[str, float]]:
    """A profile row's measured per-conjunct selectivities (``{key:
    {"selectivity": s, ...}}`` or ``{key: s}``), or None."""
    cj = row.get("conjuncts")
    if not isinstance(cj, dict):
        return None
    out = {}
    for k, v in cj.items():
        s = v.get("selectivity") if isinstance(v, dict) else v
        if s is not None:
            out[k] = float(s)
    return out


def apply_lazy_order(tables: TransitionTables, profile: Optional[Dict] = None
                     ) -> Tuple[TransitionTables, Dict[str, Any]]:
    """Reorder every consuming-edge predicate's commuting conjunct chain by
    measured selectivity and static cost.  ``profile`` is a ``per_stage``
    snapshot (``{stage: {"selectivity": s, "conjuncts": {...}}}``).
    Returns ``(new_tables, report)`` with ``report[stage] = {"order",
    "costs", "reordered", "selectivity", "measured_conjuncts"}``."""
    preds = list(tables.predicates)
    report: Dict[str, Any] = {}
    changed_any = False
    for j in range(tables.num_stages - 1):
        pid = int(tables.consume_pred[j])
        if pid < 0:
            continue
        name = tables.names[j]
        stage_sel, conjunct_sel = None, None
        if profile and isinstance(profile.get(name), dict):
            stage_sel = profile[name].get("selectivity")
            conjunct_sel = _measured_conjuncts(profile[name])
        ordered, changed = order_conjuncts(preds[pid], stage_sel, conjunct_sel)
        report[name] = {
            "order": [m.label for m in ordered],
            "costs": [round(predicate_cost(m), 1) for m in ordered],
            "reordered": changed,
            "selectivity": stage_sel,
            "measured_conjuncts": sorted(conjunct_sel) if conjunct_sel else [],
        }
        if changed:
            preds[pid] = _ordered_and(ordered)
            changed_any = True
    if changed_any:
        logger.info("lazy-chain ordering reordered stages: %s",
                    [s for s, r in report.items() if r["reordered"]])
    return dataclasses.replace(tables, predicates=preds), report
