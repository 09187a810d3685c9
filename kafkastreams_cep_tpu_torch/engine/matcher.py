"""The array NFA engine in PyTorch — the per-event step over ``[K]`` lanes.

The counterpart of ``kafkastreams_cep_tpu/engine/matcher.py`` (whose module
note explains the representation and cites the reference line by line):
``R`` run slots per lane stand for the reference's run queue
(``NFA.java:75``), each slot holding the wrapper's identity and eval stage,
a fixed-width Dewey version, its pointer event, window start, branch flag
and fold state; one step evaluates every run's unrolled PROCEED chain,
applies the folds innermost frame first, runs the shared-buffer phase
(consuming puts, then all walks) and compacts the next queue in the order
the reference appends it.

Where the JAX package ``vmap``s a one-lane step, every tensor here carries
the lane axis ``[K]`` in front and each run-level quantity is ``[K, R]``;
lookups into the transition tables are real gathers.  The numeric formats
are the JAX package's: time is rebased int32, fold states are stored as
int32 (float32 states as their bit pattern), offsets stay below 2^24.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from kafkastreams_cep_tpu_torch.compiler.tables import (
    OP_BEGIN,
    OP_TAKE,
    TYPE_BEGIN,
    TransitionTables,
    lower,
    stackable,
)
from kafkastreams_cep_tpu_torch.ops import dewey_ops
from kafkastreams_cep_tpu_torch.ops import slab as slab_mod
from kafkastreams_cep_tpu_torch.ops.walk_kernel import walk_pass
from kafkastreams_cep_tpu_torch.utils.events import Event, Sequence
from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("engine")

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static shape/feature knobs for one matcher — the same fields and
    defaults as the JAX package's ``EngineConfig``, so a config (or a
    checkpoint header's copy of one) means the same thing on both sides."""

    max_runs: int = 16  # R — run-queue slots (overflow counted in run_drops)
    slab_entries: int = 64  # E — shared-buffer slots per key
    # E_hot — the two-tier slab's hot window (0 = single tier): new entries
    # allocate hot and the least-recent hot entry demotes when it is full
    # (ops/slab.py); a multiple of 8 strictly below slab_entries.
    slab_hot_entries: int = 0
    slab_preds: int = 8  # MP — predecessor pointers per buffer entry
    dewey_depth: int = 12  # D — fixed Dewey width (overflow counted)
    max_walk: int = 16  # W — buffer walk bound = max match length
    # Walkers a lane's walk pass runs together in lockstep; 1 = the
    # reference's sequential order.  Wider batches can part from it where
    # two removal walkers meet at one entry in one hop (counted in
    # ``walk_collisions``).  The CUDA walk-pass kernel serves every walker
    # alone whatever the budget, as the JAX package's Pallas kernel does.
    walker_budget: int = 1
    renorm_versions: bool = True  # Dewey renormalization at sweep time
    enforce_windows: bool = False  # deviation: functional within() pruning
    # Apply the slab ops one run at a time, op by op (the reference's
    # literal order), instead of the batched walk pass; a switch for
    # differential testing that runs no walk kernel.
    sequential_slab: bool = False
    # Lazy extraction: a completed match leaves a handle in a per-lane ring
    # (its root pinned) instead of walking in-step; ``drain`` walks every
    # pending handle in one pass.
    lazy_extraction: bool = False
    handle_ring: int = 16  # HB — handle-ring slots (multiple of 8)
    # Per-stage tallies: frames evaluated/accepted/ignored/rejected per stage
    # (``stage_counts``) and walk hops by the walker's stage (``stage_hops``).
    stage_attribution: bool = False
    # Compiler tiering: ``CEPProcessor`` runs the query's maximal strict
    # prefix on the stencil tier and promotes runs into this engine only
    # where the prefix completes (``parallel/tiered.py``); ``TPUMatcher``
    # and ``BatchMatcher`` themselves ignore it, as in the JAX package.
    tiering: bool = False
    # The hybrid tier's per-step path gates its NFA work per chunk of this
    # many steps (any value gives the same results).
    gate_chunk: int = 32


def check_config(cfg: EngineConfig) -> None:
    """Refuse values the engine cannot run with."""
    if cfg.walker_budget < 1:
        raise ValueError(f"walker_budget={cfg.walker_budget} must be >= 1")
    EH = cfg.slab_hot_entries
    if EH and (EH % 8 or not 0 < EH < cfg.slab_entries):
        raise ValueError(
            f"slab_hot_entries={EH} must be a multiple of 8 strictly below "
            f"slab_entries={cfg.slab_entries} (0 disables the two-tier layout)"
        )
    if cfg.handle_ring <= 0 or cfg.handle_ring % 8:
        raise ValueError(
            f"handle_ring={cfg.handle_ring} must be a positive multiple of 8"
        )


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; CUDA must really be there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


class EventBatch(NamedTuple):
    """Events for ``[K]`` lanes (one step) or ``[K, T]`` (a scan).

    ``value`` is a pytree (dict / list / tuple) of numeric tensors — the
    object predicates receive.  ``valid`` masks padding steps."""

    key: torch.Tensor
    value: Any
    ts: torch.Tensor
    off: torch.Tensor
    valid: torch.Tensor


class EngineState(NamedTuple):
    """Full per-lane engine state; every field has the lane axis ``[K]``
    first and otherwise the JAX package's shape, dtype and name."""

    alive: torch.Tensor  # [K, R] bool
    id_pos: torch.Tensor  # [K, R] int32 — -1 = seed run
    eval_pos: torch.Tensor  # [K, R] int32
    ver: torch.Tensor  # [K, R, D] int32
    vlen: torch.Tensor  # [K, R] int32
    event_off: torch.Tensor  # [K, R] int32 — -1 = none
    start_ts: torch.Tensor  # [K, R] int32
    branching: torch.Tensor  # [K, R] bool
    agg: torch.Tensor  # [K, R, NS] int32 — typed-encoded fold state
    slab: slab_mod.SlabState
    run_drops: torch.Tensor  # [K] int32 — queue-overflow drops
    ver_overflows: torch.Tensor  # [K] int32 — Dewey add_stage overflows
    # Lazy-extraction handle ring (inert under the eager engine): slots
    # [0, hr_count) hold pending match handles in completion order.
    hr_stage: torch.Tensor  # [K, HB] int32
    hr_off: torch.Tensor  # [K, HB] int32
    hr_ver: torch.Tensor  # [K, HB, D] int32
    hr_vlen: torch.Tensor  # [K, HB] int32
    hr_ts: torch.Tensor  # [K, HB] int32
    hr_seq: torch.Tensor  # [K, HB] int32
    hr_row: torch.Tensor  # [K, HB] int32
    hr_count: torch.Tensor  # [K] int32
    step_seq: torch.Tensor  # [K] int32 — monotone per-lane step counter
    handle_overflows: torch.Tensor  # [K] int32
    stage_counts: torch.Tensor  # [K, 4, S] int32 — STAGE_TALLY_NAMES rows
    #   ([K, 4, 0] when attribution is off)


class StepOutput(NamedTuple):
    """Matches completed by one step (``[K, R, ...]``) or a scan
    (``[K, T, R, ...]``): ``stage``/``off`` hold each run slot's backward
    buffer walk (final stage first), ``count`` is 0 for slots that
    completed nothing."""

    stage: torch.Tensor
    off: torch.Tensor
    count: torch.Tensor


class DrainOutput(NamedTuple):
    """One drain pass's matches, in ring (completion) order, ``[K, HB, ...]``.

    ``count`` is 0 past each lane's pending prefix; ``seq`` (completing
    step) and ``row`` (run-queue row) recover the eager emission order,
    ``ts`` is the completing event's timestamp."""

    stage: torch.Tensor  # [K, HB, W] int32
    off: torch.Tensor  # [K, HB, W] int32
    count: torch.Tensor  # [K, HB] int32
    seq: torch.Tensor  # [K, HB] int32
    row: torch.Tensor  # [K, HB] int32
    ts: torch.Tensor  # [K, HB] int32


# Offsets must stay below 2^24 (the JAX package packs pointer rows into
# float32; the port keeps the same contract so states cross over).
OFFSET_LIMIT = 1 << 24


def check_offset(offset: int) -> int:
    if offset < 0:
        raise ValueError(
            f"event offset {offset} is negative; -1 is the engine's "
            "null-pointer sentinel, so offsets must be >= 0"
        )
    if offset >= OFFSET_LIMIT:
        raise ValueError(
            f"event offset {offset} >= 2^24; rebase source offsets to "
            "per-lane log positions before feeding the engine"
        )
    return int(offset)


COUNTER_NAMES = (
    "run_drops",
    "ver_overflows",
    "slab_full_drops",
    "slab_pred_drops",
    "slab_missing",
    "slab_trunc",
    "walk_collisions",
    "handle_overflows",
)

# Two-tier residency telemetry: where walk hops resolved, not loss.
HOT_COUNTER_NAMES = (
    "slab_hot_hits",
    "slab_hot_misses",
    "slab_overflow_walks",
    "slab_demotions",
)

WALK_COUNTER_NAMES = ("walk_hops", "extract_hops", "drain_hops")

# Compiler-tiering telemetry: events the stencil prefix screened, prefix
# completions, and runs promoted into the NFA tier (zeros untiered).
TIER_COUNTER_NAMES = (
    "prefix_events_screened",
    "prefix_fires",
    "tier_promotions",
)

# Row order of ``EngineState.stage_counts``.
STAGE_TALLY_NAMES = (
    "stage_evals",
    "stage_accepts",
    "stage_ignores",
    "stage_rejects",
)


def counter_values(state: EngineState):
    """The counters of ``state`` in ``COUNTER_NAMES`` order (``[K]`` each)."""
    return (
        state.run_drops,
        state.ver_overflows,
        state.slab.full_drops,
        state.slab.pred_drops,
        state.slab.missing,
        state.slab.trunc,
        state.slab.collisions,
        state.handle_overflows,
    )


def hot_counter_values(state: EngineState):
    """The two-tier counters of ``state`` in ``HOT_COUNTER_NAMES`` order."""
    return (
        state.slab.hot_hits,
        state.slab.hot_misses,
        state.slab.overflow_walks,
        state.slab.demotions,
    )


def walk_counter_values(state: EngineState):
    return (state.slab.walk_hops, state.slab.extract_hops, state.slab.drain_hops)


def per_lane_counter_arrays(state: EngineState) -> Dict[str, np.ndarray]:
    """The loss, hot-tier and walk counters of ``state`` per lane, one host
    int64 array per name (``[K]`` for a lane-batched state, a 0-d array
    for a single lane's), read from the device in one transfer."""
    names = COUNTER_NAMES + HOT_COUNTER_NAMES + WALK_COUNTER_NAMES
    values = counter_values(state) + hot_counter_values(state) + walk_counter_values(state)
    shape = tuple(values[0].shape)
    vals = torch.stack([v.reshape(-1).to(torch.int64) for v in values]).cpu().numpy()
    return {n: v.reshape(shape) for n, v in zip(names, vals)}


def stage_counter_arrays(state: EngineState) -> Dict[str, np.ndarray]:
    """The per-stage tallies as host int64 arrays ``[K, S]`` (the
    ``STAGE_TALLY_NAMES`` rows plus ``stage_walk_hops``); empty when
    attribution is off."""
    if state.stage_counts.shape[-1] == 0:
        return {}
    sc = state.stage_counts.cpu().numpy().astype(np.int64)
    out = {n: sc[..., i, :] for i, n in enumerate(STAGE_TALLY_NAMES)}
    out["stage_walk_hops"] = state.slab.stage_hops.cpu().numpy().astype(np.int64)
    return out


def stage_report(arrays: Dict[str, np.ndarray], names) -> Dict[str, Dict[str, Any]]:
    """``stage_counter_arrays`` output -> ``{stage_name: {tally: total,
    ..., selectivity}}``, lanes summed; ``selectivity`` is accepts / evals
    (rounded to 6 places, 0.0 for a stage never evaluated)."""
    if not arrays:
        return {}
    S = next(iter(arrays.values())).shape[-1]
    out: Dict[str, Dict[str, Any]] = {}
    for s in range(S):
        name = names[s] if s < len(names) else f"stage{s}"
        row: Dict[str, Any] = {
            metric: int(np.asarray(arr).reshape(-1, S)[:, s].sum())
            for metric, arr in arrays.items()
        }
        ev = row.get("stage_evals", 0)
        row["selectivity"] = round(row.get("stage_accepts", 0) / ev, 6) if ev else 0.0
        out[name] = row
    return out


def summed(names, values) -> Dict[str, int]:
    """Lane-summed counters as host ints (one device read)."""
    vals = torch.stack([v.reshape(-1).sum() for v in values]).tolist()
    return dict(zip(names, (int(v) for v in vals)))


class ArrayStates:
    """Read-only fold-state view handed to predicates: each state is a
    ``[K, R]`` tensor (``pattern/States.java:46-68``)."""

    __slots__ = ("_values",)

    def __init__(self, values: Dict[str, Any]):
        self._values = values

    def get(self, name: str):
        return self._values[name]

    def get_or_else(self, name: str, default):
        if name in self._values:
            return self._values[name]
        return default

    def __getitem__(self, name: str):
        return self.get(name)


def map_value(fn, value):
    """Apply ``fn`` to every leaf of an event-value pytree."""
    if isinstance(value, dict):
        return {k: map_value(fn, v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(map_value(fn, v) for v in value)
    return fn(value)


class _ChainRecord(NamedTuple):
    """Everything the runs' chains produced, consumed by the slab phase
    and the queue compaction (``[K, R]`` / ``[K, R, H]``)."""

    surv_alive: torch.Tensor
    surv_final: torch.Tensor
    surv_id: torch.Tensor
    surv_eval: torch.Tensor
    surv_ver: torch.Tensor
    surv_vlen: torch.Tensor
    surv_event: torch.Tensor
    surv_start: torch.Tensor
    surv_branching: torch.Tensor
    put_en: torch.Tensor
    put_cur: torch.Tensor
    put_prev: torch.Tensor  # -1 = put_first
    put_ver: torch.Tensor
    put_vlen: torch.Tensor
    br_en: torch.Tensor
    br_prev: torch.Tensor  # walk origin stage
    br_ver: torch.Tensor  # walk version (pre-add_run)
    br_vlen: torch.Tensor
    br_run_ver: torch.Tensor  # branch-run version (add_run)
    br_run_vlen: torch.Tensor
    br_id: torch.Tensor
    br_eval: torch.Tensor
    br_event: torch.Tensor
    br_start: torch.Tensor
    br_agg: torch.Tensor  # [K, R, H, NS]
    final_agg: torch.Tensor  # [K, R, NS]
    has_succ: torch.Tensor
    dead: torch.Tensor
    ovf: torch.Tensor  # [K, R] int32 — Dewey overflows in this chain
    stage_tally: torch.Tensor  # [K, R, 4, S] int32 ([K, R, 4, 0] when off)


class StepPhases(NamedTuple):
    """The step's phase functions and static shapes (``[K]``-batched)."""

    eval_chain: Callable
    build_puts: Callable
    build_walkers: Callable
    finish: Callable
    init_state: Callable
    out_base: int
    out_rows: int
    max_walk: int
    hot_entries: int
    pred_stats: Optional[Dict[str, Any]] = None  # merged-dispatch dedup stats


def _build_step(tables, cfg: EngineConfig, device) -> StepPhases:
    """Compile the per-event step for ``device``.

    ``tables`` is one :class:`TransitionTables` or a list of them sharing
    the compiled table shape: a *stacked bank*.  Stacked tables ride a
    leading query axis ``[Q, S]``; ``eval_chain`` and ``finish`` take a
    per-lane ``qids [K]`` tensor and each lane reads its own query's rows
    by gather.  The union of the queries' predicates is deduplicated and
    split (``compiler/multitenant.py: plan_step_predicates``): each
    event-level predicate is evaluated once per lane and broadcast over the
    runs, each run-level one per run under its owner query's decode, and
    every lane reads its query's predicate ids from the merged table.
    Every lane evaluates every query's folds and keeps its own query's
    (computed, then selected): folds and predicates must be total over
    other queries' fold states.
    """
    from kafkastreams_cep_tpu_torch.compiler.multitenant import plan_step_predicates

    tlist = list(tables) if isinstance(tables, (list, tuple)) else [tables]
    if not tlist:
        raise ValueError("a stacked bank needs at least one query")
    if not stackable(tlist):
        raise ValueError(
            "stacked patterns must share the compiled table shape "
            "(stage count, chain depth, begin/final positions); "
            "fall back to one matcher per query otherwise"
        )
    check_config(cfg)
    tables = tlist[0]
    Q = len(tlist)
    R, D, W = cfg.max_runs, cfg.dewey_depth, cfg.max_walk
    HB = cfg.handle_ring
    H = tables.max_hops
    NS = max(max(t.num_states for t in tlist), 1)
    RH = R * H
    # Attribution width: the pattern's stage count, 0 (zero-size) when off.
    S_AT = tables.num_stages if cfg.stage_attribution else 0

    pred_plan = plan_step_predicates(tlist)
    remaps = pred_plan.remaps

    def dev_table(get, remap=False):
        """``[Q * S]`` int64: the queries' rows of one table, flattened
        (lane ``k`` reads ``flat[qid[k] * S + idx]``); predicate ids remapped
        into the merged dispatch table."""
        rows = []
        for q, t in enumerate(tlist):
            a = np.asarray(get(t), dtype=np.int64)
            if remap and len(remaps[q]):
                a = np.where(a >= 0, remaps[q][np.maximum(a, 0)], a)
            rows.append(a)
        return torch.as_tensor(np.stack(rows).reshape(-1), device=device)

    S = tables.num_stages
    ident = dev_table(lambda t: t.ident)
    types = dev_table(lambda t: t.types)
    consume_op = dev_table(lambda t: t.consume_op)
    consume_pred = dev_table(lambda t: t.consume_pred, remap=True)
    consume_target = dev_table(lambda t: t.consume_target)
    ignore_pred = dev_table(lambda t: t.ignore_pred, remap=True)
    proceed_pred = dev_table(lambda t: t.proceed_pred, remap=True)
    proceed_target = dev_table(lambda t: t.proceed_target)
    for t in tlist:
        if t.window_ms.max(initial=-1) > np.iinfo(np.int32).max:
            raise ValueError(
                f"window of {int(t.window_ms.max())} ms exceeds int32 device "
                "time; windows up to ~24.8 days are supported"
            )
    window_ms = dev_table(lambda t: t.window_ms)
    final_pos = int(tables.final_pos)
    begin_pos = int(tables.begin_pos)
    is_float_q = [
        [d == "float32" for d in t.state_dtypes] + [False] * (NS - t.num_states)
        for t in tlist
    ]

    def _enc_host(x, flt):
        if flt:
            return int(np.float32(x).view(np.int32))
        return int(np.int32(x))

    inits = torch.tensor(
        [
            [
                _enc_host(x, f)
                for x, f in zip(list(t.state_inits) + [0] * (NS - t.num_states),
                                is_float_q[q])
            ]
            for q, t in enumerate(tlist)
        ],
        dtype=I32,
        device=device,
    )  # [Q, NS]

    def dec(v, flt):
        return v.view(torch.float32) if flt else v

    def enc(v, flt):
        v = torch.as_tensor(v, device=device)
        return v.to(torch.float32).view(I32) if flt else v.to(I32)

    def row_offset(qids):
        """The flat-table offset of each lane's query row (``[K, 1]``), 0
        for a single query."""
        if Q == 1:
            return 0
        if qids is None:
            raise ValueError(f"a stacked step over {Q} queries needs per-lane qids")
        return qids.to(device=device, dtype=torch.int64)[:, None] * S

    def lane_inits(qids):
        """Each lane's query's encoded fold inits, ``[NS]`` or ``[K, 1, NS]``."""
        if Q == 1:
            return inits[0]
        return inits[qids.long()][:, None, :]

    def as_bool(x, shape):
        return torch.as_tensor(x, device=device).to(torch.bool).expand(shape)

    def eval_preds(state: EngineState, ev: EventBatch):
        """The merged predicate frame ``[K, R, G]``: the event-level half
        evaluated once per lane (event fields ``[K, 1]``, an empty states
        view: they provably never read it) and broadcast over the runs,
        then the run-level half against each run's fold states decoded
        through the owner query's names and dtypes."""
        K = state.alive.shape[0]
        if not (pred_plan.num_event or pred_plan.num_run):
            return torch.zeros((K, R, 0), dtype=torch.bool, device=device)
        key = ev.key[:, None]
        value = map_value(lambda x: x[:, None], ev.value)
        ts = ev.ts[:, None]
        empty = ArrayStates({})
        cols = [as_bool(e.pred(key, value, ts, empty), (K, R))
                for e in pred_plan.event_entries]
        env: Dict[int, ArrayStates] = {}
        for e in pred_plan.run_entries:
            if e.owner not in env:
                t = tlist[e.owner]
                env[e.owner] = ArrayStates({
                    n: dec(state.agg[..., i], is_float_q[e.owner][i])
                    for i, n in enumerate(t.state_names)
                })
            cols.append(as_bool(e.pred(key, value, ts, env[e.owner]), (K, R)))
        return torch.stack(cols, dim=-1)

    def pv(preds, pid):
        """Predicate value by id; ``-1`` (absent edge) is False."""
        if preds.shape[-1] == 0:
            return torch.zeros(pid.shape, dtype=torch.bool, device=device)
        got = preds.gather(-1, pid.clamp(min=0).long()[..., None]).squeeze(-1)
        return got & (pid >= 0)

    def eval_chain(state: EngineState, ev: EventBatch, qids=None) -> _ChainRecord:
        """Predicates plus every run's unrolled chain (``NFA.evaluate``,
        recursion unrolled to the pattern depth); ``qids [K]`` selects each
        lane's query in a stacked bank."""
        qo = row_offset(qids)

        def tbl(table, idx):
            return table[qo + idx.long()].to(I32)

        K = state.alive.shape[0]
        preds = eval_preds(state, ev)
        ts = ev.ts[:, None]
        off = ev.off[:, None]
        alive, id_pos, eval_pos = state.alive, state.id_pos, state.eval_pos
        ver, vlen, event_off = state.ver, state.vlen, state.event_off
        start_ts0, branching = state.start_ts, state.branching
        seed = id_pos < 0
        idc = id_pos.clamp(min=0)
        # getFirstPatternTimestamp (NFA.java:347-349): BEGIN-typed runs
        # reset the window start to the current event's timestamp.
        id_type_begin = seed | (tbl(types, idc) == TYPE_BEGIN)
        start = torch.where(id_type_begin, ts, start_ts0)
        if cfg.enforce_windows:
            w = tbl(window_ms, eval_pos)
            out_w = ~id_type_begin & (w != -1) & (ts - start_ts0 > w)
            active = alive & ~out_w
        else:
            # Faithful: epsilon wrappers carry windowMs == -1
            # (Stage.java:41-46), so no run is ever out of window.
            active = alive

        # Epsilon-hop stage digit (NFA.java:185-188).
        do_add0 = active & ~seed & (tbl(ident, eval_pos) != idc) & ~branching
        _, vlen_a, ovf0 = dewey_ops.add_stage(ver, vlen)
        vl = torch.where(do_add0, vlen_a, vlen)
        vv = ver
        ovf = (do_add0 & ovf0).to(I32)
        cur = eval_pos
        prev = torch.where(seed, -1, id_pos)

        zi = torch.zeros((K, R), dtype=I32, device=device)
        zb = torch.zeros((K, R), dtype=torch.bool, device=device)
        surv_alive, surv_final, surv_branching = zb, zb, zb
        surv_id = surv_eval = surv_vlen = surv_event = surv_start = zi
        surv_ver = torch.zeros_like(ver)
        hops: Dict[str, List[torch.Tensor]] = {
            f: [] for f in (
                "put_en", "put_cur", "put_prev", "put_ver", "put_vlen",
                "br_en", "br_prev", "br_ver", "br_vlen", "br_run_ver",
                "br_run_vlen", "br_id", "br_eval", "br_event", "br_start",
            )
        }
        consumed_h, frame_pos = [], []
        tally = torch.zeros((K, R, 4, S_AT), dtype=I32, device=device)
        stage_ids = torch.arange(S_AT, device=device)

        for _h in range(H):
            cs = cur.clamp(min=0)
            cop = tbl(consume_op, cs)
            cp = pv(preds, tbl(consume_pred, cs))
            take_m = active & (cop == OP_TAKE) & cp
            begin_m = active & (cop == OP_BEGIN) & cp
            ig_m = active & pv(preds, tbl(ignore_pred, cs))
            pr_m = active & pv(preds, tbl(proceed_pred, cs))
            # The 4-pair nondeterministic branching rule (NFA.java:280-289).
            branch_m = (
                (pr_m & take_m) | (ig_m & take_m) | (ig_m & begin_m) | (ig_m & pr_m)
            ) & (prev >= 0)
            consumed = take_m | begin_m
            if S_AT:
                # Every frame that ran predicate dispatch at stage ``cs``:
                # one eval, plus an accept (consumed), an ignore, or a
                # reject (nothing fired) as applicable.
                rejected = active & ~consumed & ~ig_m & ~pr_m
                rows = torch.stack([active, consumed, ig_m, rejected], dim=2)
                oh = cs[..., None] == stage_ids
                tally += (rows[..., None] & oh[:, :, None, :]).to(I32)

            # Survivor: at most one across the chain.
            st = take_m & ~branch_m  # self-loop re-add (NFA.java:196-205)
            sb = begin_m  # advance (NFA.java:210-222)
            si = ig_m & ~branch_m  # unchanged re-add (NFA.java:223-227)
            fire = st | sb | si
            tgt = tbl(consume_target, cs)
            ident_cs = tbl(ident, cs)
            surv_id = torch.where(fire, torch.where(si, id_pos, ident_cs), surv_id)
            surv_eval = torch.where(
                fire,
                torch.where(st, cs, torch.where(sb, tgt, eval_pos)),
                surv_eval,
            )
            surv_ver = torch.where(fire[..., None], vv, surv_ver)
            surv_vlen = torch.where(fire, vl, surv_vlen)
            surv_event = torch.where(
                fire, torch.where(si, event_off, off), surv_event
            )
            surv_start = torch.where(
                fire, torch.where(si, start_ts0, start), surv_start
            )
            surv_branching = torch.where(fire, si & branching, surv_branching)
            surv_final = torch.where(fire, sb & (tgt == final_pos), surv_final)
            surv_alive = surv_alive | fire

            # Consuming put; a branching TAKE records the event under the
            # bumped version and emits no successor (NFA.java:206-208).
            ident_prev = tbl(ident, prev.clamp(min=0))
            run_ver = dewey_ops.add_run(vv, vl)
            hops["put_en"].append(consumed)
            hops["put_cur"].append(ident_cs)
            hops["put_prev"].append(torch.where(prev >= 0, ident_prev, -1))
            hops["put_ver"].append(
                torch.where((take_m & branch_m)[..., None], run_ver, vv)
            )
            hops["put_vlen"].append(vl)
            # Branch run (NFA.java:231-246).
            hops["br_en"].append(branch_m)
            hops["br_prev"].append(ident_prev)
            hops["br_ver"].append(vv)
            hops["br_vlen"].append(vl)
            hops["br_run_ver"].append(run_ver)
            hops["br_run_vlen"].append(vl)
            hops["br_id"].append(ident_prev)
            hops["br_eval"].append(cs)
            hops["br_event"].append(torch.where(ig_m, event_off, off))
            hops["br_start"].append(start)
            consumed_h.append(consumed)
            frame_pos.append(cs)

            # PROCEED recursion (NFA.java:182-190).
            ptc = tbl(proceed_target, cs).clamp(min=0)
            do_add = pr_m & (tbl(ident, ptc) != ident_cs) & ~branching
            _, vlen_b, ovf_b = dewey_ops.add_stage(vv, vl)
            vl = torch.where(do_add, vlen_b, vl)
            ovf = ovf + (do_add & ovf_b).to(I32)
            prev = torch.where(pr_m, cs, prev)
            cur = torch.where(pr_m, ptc, cur)
            active = pr_m

        # Folds, innermost frame first (they run on recursion unwind,
        # NFA.java:248); a branch copies the state before its own frame's
        # fold but after deeper frames' (NFA.java:243), restricted to the
        # states declared at the branching stage.
        key = ev.key[:, None]
        value = map_value(lambda x: x[:, None], ev.value)
        s = state.agg.clone()
        inits_l = lane_inits(qids)
        # In a stacked bank every query's folds run on every lane, masked
        # to the lanes of that query.
        folded = [(q, t) for q, t in enumerate(tlist) if t.aggs]
        qms = {q: None if Q == 1 else (qids == q)[:, None] for q, _ in folded}
        br_agg: List[Any] = [None] * H
        for h in range(H - 1, -1, -1):
            copy_mask = torch.zeros((K, R, NS), dtype=torch.bool, device=device)
            for q, t in folded:
                for slot in t.aggs:
                    m = frame_pos[h] == slot.stage
                    copy_mask[..., slot.state] |= m if qms[q] is None else m & qms[q]
            br_agg[h] = torch.where(copy_mask, s, inits_l)
            for q, t in folded:
                for slot in t.aggs:
                    cond = consumed_h[h] & (frame_pos[h] == slot.stage)
                    if qms[q] is not None:
                        cond = cond & qms[q]
                    flt = is_float_q[q][slot.state]
                    val = enc(slot.fn(key, value, dec(s[..., slot.state], flt)), flt)
                    s[..., slot.state] = torch.where(cond, val, s[..., slot.state])

        def stk(name):
            return torch.stack(hops[name], dim=2)

        br_en = stk("br_en")
        any_br = br_en.any(dim=2) if H else zb
        has_succ = surv_alive | any_br
        return _ChainRecord(
            surv_alive, surv_final, surv_id, surv_eval, surv_ver, surv_vlen,
            surv_event, surv_start, surv_branching,
            stk("put_en"), stk("put_cur"), stk("put_prev"), stk("put_ver"),
            stk("put_vlen"),
            br_en, stk("br_prev"), stk("br_ver"), stk("br_vlen"),
            stk("br_run_ver"), stk("br_run_vlen"), stk("br_id"),
            stk("br_eval"), stk("br_event"), stk("br_start"),
            torch.stack(br_agg, dim=2), s, has_succ,
            alive & ~seed & ~has_succ, ovf, tally,
        )

    def build_puts(state: EngineState, rec: _ChainRecord) -> slab_mod.PutOps:
        """The step's consuming puts, run-major and frame-ascending (the
        reference's op order)."""
        K = state.alive.shape[0]
        return slab_mod.PutOps(
            en=rec.put_en.reshape(K, RH),
            first=rec.put_prev.reshape(K, RH) < 0,
            cur_stage=rec.put_cur.reshape(K, RH),
            prev_stage=rec.put_prev.reshape(K, RH),
            prev_off=state.event_off.repeat_interleave(H, dim=1),
            ver=rec.put_ver.reshape(K, RH, D),
            vlen=rec.put_vlen.reshape(K, RH),
        )

    def build_walkers(state: EngineState, rec: _ChainRecord, ev: EventBatch):
        """The step's candidate walker queue: branch frames deepest-first
        per run ``[RH]``, dead-run removals ``[R]``, final extractions
        ``[R]`` — ``out_base = RH + R``, ``out_rows = R``."""
        K = state.alive.shape[0]
        final_en = rec.surv_alive & rec.surv_final & ev.valid[:, None]
        if cfg.lazy_extraction:
            # Completed matches become ring handles (``finish``) instead of
            # extraction walkers; the final segment keeps its rows.
            final_en = torch.zeros_like(final_en)

        def rev(f):
            return f.flip(2).reshape((K, RH) + f.shape[3:])

        dead_en = rec.dead & (state.event_off >= 0)
        remove = torch.zeros((K, RH + 2 * R), dtype=torch.bool, device=device)
        remove[:, RH:] = True
        out = torch.zeros_like(remove)
        out[:, RH + R:] = True
        return (
            torch.cat([rev(rec.br_en), dead_en, final_en], dim=1),
            torch.cat([rev(rec.br_prev), state.id_pos.clamp(min=0), rec.surv_id], dim=1),
            torch.cat(
                [
                    state.event_off.repeat_interleave(H, dim=1),
                    state.event_off,
                    ev.off[:, None].expand(K, R),
                ],
                dim=1,
            ),
            torch.cat([rev(rec.br_ver), state.ver, rec.surv_ver], dim=1),
            torch.cat([rev(rec.br_vlen), state.vlen, rec.surv_vlen], dim=1),
            remove,
            out,
        )

    S_CAND = 1 + H + 1  # survivor, branch per hop, re-seed
    RS = R * S_CAND

    def finish(state, ev, rec, slab, out_stage, out_off, out_count, qids=None):
        """Queue compaction and padding masking (``qids`` as in
        ``eval_chain``)."""
        K = state.alive.shape[0]
        valid = ev.valid
        seed_mask = state.alive & (state.id_pos < 0)
        reseed_ver = torch.where(
            rec.has_succ[..., None],
            dewey_ops.add_run(state.ver, state.vlen),
            state.ver,
        )

        def cand(surv, br, seed):
            # [K, R] / [K, R, H, ...] / [K, R] -> [K, R, S_CAND, ...]
            return torch.cat([surv[:, :, None], br.flip(2), seed[:, :, None]], dim=2)

        def full(v):
            return torch.full((K, R), v, dtype=I32, device=device)

        c_alive = cand(rec.surv_alive & ~rec.surv_final, rec.br_en, seed_mask)
        flat_alive = c_alive.reshape(K, RS)
        idx = torch.cumsum(flat_alive.to(I32), dim=1) - 1
        keep = flat_alive & (idx < R)
        dropped = (flat_alive & (idx >= R)).sum(dim=1, dtype=I32)
        dst = torch.where(keep, idx, R).long()

        def compact(c, fill):
            flat = c.reshape((K, RS) + c.shape[3:])
            buf = torch.full(
                (K, R + 1) + c.shape[3:], fill, dtype=c.dtype, device=device
            )
            i = dst.reshape(dst.shape + (1,) * (flat.dim() - 2)).expand(flat.shape)
            return buf.scatter_(1, i, flat)[:, :R]

        branch_flags = torch.ones((K, R, H), dtype=torch.bool, device=device)
        hr = dict(
            hr_stage=state.hr_stage, hr_off=state.hr_off, hr_ver=state.hr_ver,
            hr_vlen=state.hr_vlen, hr_ts=state.hr_ts, hr_seq=state.hr_seq,
            hr_row=state.hr_row, hr_count=state.hr_count,
            handle_overflows=state.handle_overflows,
        )
        if cfg.lazy_extraction:
            slab, hr = append_handles(state, ev, rec, slab)
        new_state = EngineState(
            alive=compact(c_alive, False),
            id_pos=compact(cand(rec.surv_id, rec.br_id, full(-1)), -1),
            eval_pos=compact(cand(rec.surv_eval, rec.br_eval, full(begin_pos)), 0),
            ver=compact(cand(rec.surv_ver, rec.br_run_ver, reseed_ver), 0),
            vlen=compact(cand(rec.surv_vlen, rec.br_run_vlen, state.vlen), 0),
            event_off=compact(cand(rec.surv_event, rec.br_event, full(-1)), -1),
            start_ts=compact(cand(rec.surv_start, rec.br_start, full(-1)), -1),
            branching=compact(
                cand(rec.surv_branching, branch_flags, torch.zeros_like(seed_mask)),
                False,
            ),
            agg=compact(
                cand(rec.final_agg, rec.br_agg, lane_inits(qids).expand(K, R, NS)), 0
            ),
            slab=slab,
            run_drops=state.run_drops + dropped,
            ver_overflows=state.ver_overflows + rec.ovf.sum(dim=1, dtype=I32),
            step_seq=state.step_seq,
            stage_counts=state.stage_counts + rec.stage_tally.sum(dim=1, dtype=I32),
            **hr,
        )
        # Padding steps leave the state untouched and emit nothing; the
        # step counter ticks on every step.
        new_state = tree_where(valid, new_state, state)
        new_state = new_state._replace(step_seq=state.step_seq + 1)
        out = StepOutput(
            stage=torch.where(valid[:, None, None], out_stage, -1),
            off=torch.where(valid[:, None, None], out_off, -1),
            count=torch.where(valid[:, None], out_count, 0),
        )
        return new_state, out

    def append_handles(state, ev, rec, slab):
        """Lazy extraction: each lane's completed matches, in run-queue
        order, append to its handle ring, and each root entry is pinned
        (refs + 1) so no removal walk deletes it before the drain.  A full
        ring drops the match and counts ``handle_overflows``."""
        K = state.alive.shape[0]
        final_en = rec.surv_alive & rec.surv_final & ev.valid[:, None]
        rank = torch.cumsum(final_en.to(I32), dim=1) - 1
        dst = state.hr_count[:, None] + rank
        fit = final_en & (dst < HB)
        col = torch.where(fit, dst, HB).long()  # column HB: dropped

        def ring_set(cur, val):
            buf = torch.cat([cur, cur[:, :1]], dim=1)
            idx = col.reshape(col.shape + (1,) * (val.dim() - 2)).expand(val.shape)
            return buf.scatter_(1, idx, val)[:, :HB]

        pin = (
            (slab.stage[:, None, :] == rec.surv_id[:, :, None])
            & (slab.off[:, None, :] == ev.off[:, None, None])
            & fit[:, :, None]
        ).sum(dim=1, dtype=I32)
        slab = slab._replace(refs=slab.refs + pin)
        rows = torch.arange(R, dtype=I32, device=device).expand(K, R)
        return slab, dict(
            hr_stage=ring_set(state.hr_stage, rec.surv_id),
            hr_off=ring_set(state.hr_off, ev.off[:, None].expand(K, R)),
            hr_ver=ring_set(state.hr_ver, rec.surv_ver),
            hr_vlen=ring_set(state.hr_vlen, rec.surv_vlen),
            hr_ts=ring_set(state.hr_ts, ev.ts[:, None].expand(K, R)),
            hr_seq=ring_set(state.hr_seq, state.step_seq[:, None].expand(K, R)),
            hr_row=ring_set(state.hr_row, rows),
            hr_count=state.hr_count + fit.sum(dim=1, dtype=I32),
            handle_overflows=state.handle_overflows
            + (final_en & ~fit).sum(dim=1, dtype=I32),
        )

    def init_state(num_lanes: int, q: int = 0) -> EngineState:
        """``num_lanes`` lanes of query ``q``'s initial state."""
        K = int(num_lanes)

        def full(shape, v, dtype=I32):
            return torch.full(shape, v, dtype=dtype, device=device)

        alive = full((K, R), False, torch.bool)
        alive[:, 0] = True
        ver = full((K, R, D), 0)
        ver[:, 0, 0] = 1
        vlen = full((K, R), 0)
        vlen[:, 0] = 1
        return EngineState(
            alive=alive,
            id_pos=full((K, R), -1),
            eval_pos=full((K, R), begin_pos),
            ver=ver,
            vlen=vlen,
            event_off=full((K, R), -1),
            start_ts=full((K, R), -1),
            branching=full((K, R), False, torch.bool),
            agg=inits[q].expand(K, R, NS).clone(),
            slab=slab_mod.make(
                K, cfg.slab_entries, cfg.slab_preds, D, num_stages=S_AT,
                device=device,
            ),
            run_drops=full((K,), 0),
            ver_overflows=full((K,), 0),
            hr_stage=full((K, HB), -1),
            hr_off=full((K, HB), -1),
            hr_ver=full((K, HB, D), 0),
            hr_vlen=full((K, HB), 0),
            hr_ts=full((K, HB), 0),
            hr_seq=full((K, HB), 0),
            hr_row=full((K, HB), 0),
            hr_count=full((K,), 0),
            step_seq=full((K,), 0),
            handle_overflows=full((K,), 0),
            stage_counts=full((K, 4, S_AT), 0),
        )

    return StepPhases(
        eval_chain=eval_chain,
        build_puts=build_puts,
        build_walkers=build_walkers,
        finish=finish,
        init_state=init_state,
        out_base=RH + R,
        out_rows=R,
        max_walk=W,
        hot_entries=cfg.slab_hot_entries,
        pred_stats=dict(pred_plan.stats),
    )


def build_drain(cfg: EngineConfig, walk_fn=walk_pass):
    """The ``[K]``-batched drain pass for ``cfg``: ``drain(state) -> (state,
    DrainOutput)``.

    Unpins every pending handle's root (the emission-time refs + 1), walks
    all handles through the walk pass in drain mode (``walk_fn``: the
    kernel on CUDA tensors by default) with full removal semantics, in ring
    order, and clears the ring.  A no-op on an empty ring, so callers may
    drain unconditionally."""
    HB, W, EH = cfg.handle_ring, cfg.max_walk, cfg.slab_hot_entries

    def drain(state: EngineState):
        dev = state.hr_count.device
        pending = torch.arange(HB, device=dev)[None, :] < state.hr_count[:, None]
        slab = state.slab
        unpin = (
            (slab.stage[:, None, :] == state.hr_stage[:, :, None])
            & (slab.off[:, None, :] == state.hr_off[:, :, None])
            & pending[:, :, None]
        ).sum(dim=1, dtype=I32)
        slab = slab._replace(refs=torch.clamp(slab.refs - unpin, min=0))
        ones = torch.ones_like(pending)
        slab, out_stage, out_off, count = walk_fn(
            slab, pending, state.hr_stage, state.hr_off, state.hr_ver,
            state.hr_vlen, ones, ones, W, 0, HB, hot_entries=EH, drain=True,
        )
        out = DrainOutput(
            stage=out_stage,
            off=out_off,
            count=torch.where(pending, count, 0),
            seq=torch.where(pending, state.hr_seq, -1),
            row=torch.where(pending, state.hr_row, -1),
            ts=torch.where(pending, state.hr_ts, -1),
        )
        state = state._replace(
            slab=slab,
            hr_stage=torch.full_like(state.hr_stage, -1),
            hr_off=torch.full_like(state.hr_off, -1),
            hr_ver=torch.zeros_like(state.hr_ver),
            hr_vlen=torch.zeros_like(state.hr_vlen),
            hr_ts=torch.zeros_like(state.hr_ts),
            hr_seq=torch.zeros_like(state.hr_seq),
            hr_row=torch.zeros_like(state.hr_row),
            hr_count=torch.zeros_like(state.hr_count),
        )
        return state, out

    return drain


def tree_where(valid, new, old):
    """Per lane: ``new`` where ``valid [K]``, else ``old`` (every leaf)."""
    if isinstance(new, tuple):
        return type(new)(*(tree_where(valid, n, o) for n, o in zip(new, old)))
    return torch.where(valid.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def step_events(events: EventBatch, t: int) -> EventBatch:
    """Step ``t`` of a ``[K, T]`` batch as a ``[K]`` batch."""
    return EventBatch(
        key=events.key[:, t],
        value=map_value(lambda x: x[:, t], events.value),
        ts=events.ts[:, t],
        off=events.off[:, t],
        valid=events.valid[:, t],
    )


def scan_steps(step, state: EngineState, events: EventBatch):
    """``step`` over each of a ``[K, T]`` batch's T steps; returns
    ``(state, StepOutput [K, T, ...])``."""
    outs = []
    for t in range(events.ts.shape[1]):
        state, out = step(state, step_events(events, t))
        outs.append(out)
    return state, StepOutput(*(torch.stack(x, dim=1) for x in zip(*outs)))


def make_step(phases: StepPhases, walk_fn=walk_pass, qids=None):
    """The ``[K]``-batched step: chain, puts and walkers, the slab phase
    through ``walk_fn`` (the kernel on CUDA tensors by default) over every
    lane at once, then the queue compaction.  ``qids [K]`` gives each
    lane's query in a stacked bank; the walk pass takes no tables, so one
    launch serves every query's lanes."""
    ph = phases

    def step(state: EngineState, ev: EventBatch):
        rec = ph.eval_chain(state, ev, qids)
        ops = ph.build_puts(state, rec)
        wk = ph.build_walkers(state, rec, ev)
        slab, out_stage, out_off, out_count = walk_fn(
            state.slab, *wk, ph.max_walk, ph.out_base, ph.out_rows,
            put_ops=ops, ev_off=ev.off, hot_entries=ph.hot_entries,
        )
        return ph.finish(state, ev, rec, slab, out_stage, out_off, out_count, qids)

    return step


def make_sequential_step(phases: StepPhases, cfg: EngineConfig, qids=None):
    """The ``sequential_slab`` step: the same chain and queue compaction as
    :func:`make_step`, with the slab ops applied one run at a time in the
    reference's literal order (``kafkastreams_cep_tpu/engine/matcher.py:
    1028-1100``).  Per run in queue order: its consuming puts frame by
    frame, its branch walks deepest first, then its removal walk if it
    died; after every run, each completed match's extraction walk in queue
    order (none under lazy extraction: ``finish`` appends handles).  Every
    op is masked by its enable flag, and a walk stops once no lane's walker
    is active (``ops/slab.py: _all_done``); no walk kernel runs."""
    ph = phases
    R, W, EH = cfg.max_runs, cfg.max_walk, cfg.slab_hot_entries

    def step(state: EngineState, ev: EventBatch):
        rec = ph.eval_chain(state, ev, qids)
        K, H = rec.put_en.shape[0], rec.put_en.shape[2]
        off = ev.off.to(I32)
        slab = slab_mod.clone(state.slab)
        for r in range(R):
            prev_off = state.event_off[:, r]
            for h in range(H):
                en, prev = rec.put_en[:, r, h], rec.put_prev[:, r, h]
                cur, ver, vlen = rec.put_cur[:, r, h], rec.put_ver[:, r, h], rec.put_vlen[:, r, h]
                slab_mod._put_first_(slab, cur, off, ver, vlen, en & (prev < 0), EH)
                slab_mod._put_(slab, cur, off, prev, prev_off, ver, vlen,
                               en & (prev >= 0), EH)
            for h in range(H - 1, -1, -1):
                slab = slab_mod.branch(
                    slab, rec.br_prev[:, r, h], prev_off, rec.br_ver[:, r, h],
                    rec.br_vlen[:, r, h], W, rec.br_en[:, r, h], hot_entries=EH,
                )
            slab, _, _, _ = slab_mod.peek(
                slab, state.id_pos[:, r].clamp(min=0), prev_off, state.ver[:, r],
                state.vlen[:, r], W, remove=True,
                enable=rec.dead[:, r] & (prev_off >= 0), hop_kind="walk",
                hot_entries=EH,
            )
        out_stage = torch.full((K, R, W), -1, dtype=I32, device=off.device)
        out_off = out_stage.clone()
        out_count = torch.zeros((K, R), dtype=I32, device=off.device)
        if not cfg.lazy_extraction:
            final_en = rec.surv_alive & rec.surv_final & ev.valid[:, None]
            for r in range(R):
                fe = final_en[:, r]
                slab, st_row, off_row, cnt = slab_mod.peek(
                    slab, rec.surv_id[:, r], off, rec.surv_ver[:, r],
                    rec.surv_vlen[:, r], W, remove=True, enable=fe, hot_entries=EH,
                )
                out_stage[:, r] = torch.where(fe[:, None], st_row, out_stage[:, r])
                out_off[:, r] = torch.where(fe[:, None], off_row, out_off[:, r])
                out_count[:, r] = torch.where(fe, cnt, out_count[:, r])
        return ph.finish(state, ev, rec, slab, out_stage, out_off, out_count, qids)

    return step


def build_programs(phases: StepPhases, cfg: EngineConfig, qids=None):
    """``(step, drain)`` for ``cfg``, chosen from the config alone as the
    JAX package's ``parallel/batch.py: _select_walk_kernel`` does.

    ``sequential_slab`` swaps the step for the per-op one
    (:func:`make_sequential_step`), which no kernel computes.  Every other
    step, and every drain, goes through :func:`walk_pass`: the kernel on
    CUDA tensors, where ``walker_budget`` changes nothing, and the plain
    pass on CPU tensors, where a budget above 1 runs its lockstep batches."""
    walk_fn = functools.partial(walk_pass, budget=cfg.walker_budget)
    if cfg.sequential_slab:
        logger.info("sequential_slab: per-op slab step, no walk kernel in the "
                    "step; the drain goes through the walk pass")
        step = make_sequential_step(phases, cfg, qids)
    else:
        step = make_step(phases, walk_fn, qids)
    return step, build_drain(cfg, walk_fn)


class TPUMatcher:
    """A compiled array matcher for one pattern, over any number of lanes.

    ``step(state, ev)`` advances ``[K]``-batched state by one event per
    lane; ``init_state(num_lanes)`` makes that state.  The name is kept
    from the JAX package so each module finds its counterpart."""

    def __init__(self, pattern, config: Optional[EngineConfig] = None,
                 device="cuda", phases: Optional[StepPhases] = None):
        self.device = resolve_device(device)
        self.tables: TransitionTables = (
            pattern if isinstance(pattern, TransitionTables) else lower(pattern)
        )
        self.config = config or EngineConfig()
        logger.info(
            "building matcher: %d stages %s, max_hops=%d, %s on %s",
            self.tables.num_stages, self.tables.names,
            self.tables.max_hops, self.config, self.device,
        )
        # ``phases`` hands over a build of the same tables, config and
        # device (``parallel/batch.py`` takes it from utils/tracecache.py);
        # the step and drain closures are made anew either way, so they
        # call the walk pass in effect now.
        self.phases = phases or _build_step(self.tables, self.config, self.device)
        self.step, self.drain = build_programs(self.phases, self.config)

    @property
    def names(self) -> List[str]:
        return self.tables.names

    def init_state(self, num_lanes: int = 1) -> EngineState:
        return self.phases.init_state(num_lanes)

    def counters(self, state: EngineState) -> Dict[str, int]:
        """Lane-summed overflow/drop counters."""
        return summed(COUNTER_NAMES, counter_values(state))

    def hot_counters(self, state: EngineState) -> Dict[str, int]:
        """Lane-summed two-tier residency counters (all 0 single-tier; not
        loss indicators)."""
        return summed(HOT_COUNTER_NAMES, hot_counter_values(state))

    def walk_counters(self, state: EngineState) -> Dict[str, int]:
        """Lane-summed walk-cost counters (not loss indicators)."""
        return summed(WALK_COUNTER_NAMES, walk_counter_values(state))

    def stage_counters(self, state: EngineState) -> Dict[str, Dict[str, Any]]:
        """Per-stage tallies ``{stage_name: {tally: total, ...,
        selectivity}}`` summed over lanes; empty when attribution is off."""
        return stage_report(stage_counter_arrays(state), self.names)


def _leaf_tensor(x, device) -> torch.Tensor:
    """A host scalar as a ``[1]`` tensor of the engine's event dtypes."""
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    elif not np.issubdtype(a.dtype, np.bool_):
        a = a.astype(np.int32)
    return torch.as_tensor(a, device=device).reshape(1)


class MatcherSession:
    """One partition stepped one event at a time, with the oracle's
    ``match()`` API: keeps the raw :class:`Event` objects keyed by offset
    and decodes each step's matches into :class:`Sequence` objects."""

    def __init__(self, matcher: TPUMatcher):
        self.matcher = matcher
        self.state = matcher.init_state(1)
        self._events: Dict[int, Event] = {}
        self._offset = 0

    def match(self, key, value, timestamp: int, topic: str = "test",
              partition: int = 0, offset: Optional[int] = None) -> List[Sequence]:
        if offset is None:
            offset = self._offset
        check_offset(offset)
        self._offset = max(self._offset, offset + 1)
        self._events[offset] = Event(key, value, timestamp, topic, partition, offset)
        dev = self.matcher.device
        ev = EventBatch(
            key=_leaf_tensor(0 if key is None else key, dev),
            value=map_value(lambda x: _leaf_tensor(x, dev), value),
            ts=torch.tensor([timestamp], dtype=I32, device=dev),
            off=torch.tensor([offset], dtype=I32, device=dev),
            valid=torch.ones((1,), dtype=torch.bool, device=dev),
        )
        self.state, out = self.matcher.step(self.state, ev)
        if self.matcher.config.lazy_extraction:
            # Drain at every event, so that match() returns a match at the
            # event that completes it, as the oracle does.
            self.state, drained = self.matcher.drain(self.state)
            return self.decode_drained(drained)
        return self.decode(out)

    def decode(self, out: StepOutput) -> List[Sequence]:
        """One step's matches of lane 0 as :class:`Sequence` objects."""
        return self._sequences(out.stage, out.off, out.count)

    def decode_drained(self, out: DrainOutput) -> List[Sequence]:
        """A drain pass's matches of lane 0, in completion (ring) order."""
        return self._sequences(out.stage, out.off, out.count)

    def _sequences(self, stage, off, count) -> List[Sequence]:
        stage, off, count = (x[0].cpu().numpy() for x in (stage, off, count))
        names = self.matcher.names
        matches: List[Sequence] = []
        for r in range(count.shape[0]):
            n = int(count[r])
            if n == 0:
                continue
            seq = Sequence()
            for w in range(n):
                seq.add(names[int(stage[r, w])], self._events[int(off[r, w])])
            matches.append(seq)
        return matches

    def counters(self) -> Dict[str, int]:
        return self.matcher.counters(self.state)
