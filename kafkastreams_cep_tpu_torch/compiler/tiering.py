"""Measured per-conjunct selectivity — the part of the compiler's tiering
pass that stage attribution runs.

The counterpart of ``kafkastreams_cep_tpu/compiler/tiering.py``'s
``conjuncts``, ``conjunct_key``, ``conjunct_tally_plan`` and
``build_conjunct_tally``: under ``EngineConfig.stage_attribution`` every
conjunct of every consuming-edge predicate is evaluated over each scanned
batch, so each one's marginal (order-independent) accept fraction is
measured.  The rest of that module (tier planning, lazy-chain reordering)
is not ported yet.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import torch

from kafkastreams_cep_tpu_torch.compiler.tables import TransitionTables, lower
from kafkastreams_cep_tpu_torch.engine.matcher import ArrayStates
from kafkastreams_cep_tpu_torch.pattern.predicate import Matcher


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
        states = ArrayStates({
            name: torch.tensor(
                init, dtype=torch.float32 if dt == "float32" else torch.int32,
                device=dev,
            )
            for name, init, dt in zip(
                tables.state_names, tables.state_inits, tables.state_dtypes
            )
        })
        valid = ev.valid.to(torch.bool)
        evals = valid.sum(dtype=torch.int32)
        accepts = torch.stack([
            (torch.as_tensor(m(ev.key, ev.value, ev.ts, states), device=dev)
             .to(torch.bool).expand(valid.shape) & valid).sum(dtype=torch.int32)
            for m in matchers
        ])
        return counts + torch.stack([evals.expand(len(matchers)), accepts])

    return slots, tally
