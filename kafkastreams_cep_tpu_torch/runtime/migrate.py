"""Live-state surgery: widen a running processor onto a strictly wider
``EngineConfig``, re-plan a tiered one, and move lanes between positions.

The counterpart of ``kafkastreams_cep_tpu/runtime/migrate.py``, whose
module note proves, dimension by dimension, why widening is a pure
embedding: appended run slots are dead (``alive`` gates every use), an
appended slab row is free and allocation takes the first free row,
appended pointer slots lie past ``npreds``, a Dewey vector's tail past its
length is zero by construction, and the walk bound and the walker budget
shape no array.  So stepping the widened state on the wide engine gives
the narrow engine's run queues, slab, versions, matches and counters bit
for bit for as long as the narrow one would not have dropped, and past
that keeps what the narrow one lost.  Counters copy verbatim: a migration
never forgives past loss.

A lane permutation is a pure relabeling in the same way: every state
leaf has the lane axis ``[K]`` in front, no operation reads across lanes,
and records reach a lane only through the processor's host maps, so
permuting the state rows and every lane-indexed host structure by the same
permutation leaves matches, their order and every summed counter as they
were.

Every state function here returns host numpy trees; a processor puts one
on its device with :meth:`CEPProcessor.place`.  Meshes are not part of the
port yet: ``mesh=`` takes ``None`` (or, for :func:`move_lanes`, "keep the
current one") only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from kafkastreams_cep_tpu_torch.convert import _numpy, to_numpy
from kafkastreams_cep_tpu_torch.engine.matcher import EngineConfig, EngineState
from kafkastreams_cep_tpu_torch.ops.slab import SlabState
from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("runtime.migrate")

#: Sentinel for ``move_lanes(mesh=...)``: "keep the processor's placement".
_KEEP_MESH = object()

# Config fields that are array-shape dims (may only grow) vs semantic
# switches (must not change under a live migration: they change the match
# stream, or the state's shape, not its capacity).
_SHAPE_DIMS = (
    "max_runs", "slab_entries", "slab_preds", "dewey_depth", "max_walk",
    "handle_ring",
)
_SEMANTIC_FLAGS = (
    "renorm_versions", "enforce_windows", "sequential_slab", "walker_budget",
    "lazy_extraction",
    # Shapes the attribution arrays ([S] vs [0]): no embedding across it.
    "stage_attribution",
    # Shapes the state itself (the tiered state carries the prefix).
    "tiering",
)


def _no_mesh(mesh) -> None:
    if mesh is not None and mesh is not _KEEP_MESH:
        raise NotImplementedError(
            "meshes are not ported yet (ROADMAP.md §A item 8: the port's lane "
            "and device partition); pass mesh=None"
        )


def tree_map(fn, tree):
    """``fn`` over every array leaf of a state tree (NamedTuples, plain
    tuples and lists, dicts), keeping its structure and classes."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def check_widens(old: EngineConfig, new: EngineConfig) -> None:
    """Refuse a migration target that is not a pure widening of ``old``."""
    for f in _SHAPE_DIMS:
        o, n = getattr(old, f), getattr(new, f)
        if n < o:
            raise ValueError(
                f"migration cannot shrink {f}: {o} -> {n} (state embedding "
                "only exists into a strictly-wider config)"
            )
    for f in _SEMANTIC_FLAGS:
        o, n = getattr(old, f), getattr(new, f)
        if o != n:
            raise ValueError(
                f"migration cannot change {f} ({o} -> {n}): it alters match "
                "semantics, not capacity — restart the processor instead"
            )
    if new == old:
        raise ValueError("migration target equals the current config")


def _pad(arr: np.ndarray, axis: int, new_size: int, fill) -> np.ndarray:
    """Grow ``arr`` along ``axis`` (negative, from the end) to
    ``new_size``, new slots holding ``fill``."""
    ax = arr.ndim + axis
    grow = new_size - arr.shape[ax]
    if grow == 0:
        return arr
    shape = list(arr.shape)
    shape[ax] = grow
    return np.concatenate([arr, np.full(shape, fill, dtype=arr.dtype)], axis=ax)


def _is_bank_engines(inner) -> bool:
    """A tenant bank's plain tuple of group engines (an EngineState is a
    NamedTuple and is not one)."""
    return isinstance(inner, (tuple, list)) and not hasattr(inner, "_fields")


def widen_state(state, old: EngineConfig, new: EngineConfig):
    """Embed ``state`` (host or device leaves, lane axes in front) into the
    shapes of ``new``; returns a host numpy tree.

    A tiered state widens its engine half and copies the stencil prefix
    carry verbatim (its shape is the pattern's, not a capacity's); a tenant
    bank's state widens each group engine of its tuple."""
    inner = getattr(state, "engine", None)
    if inner is not None:
        engine = (tuple(widen_state(e, old, new) for e in inner)
                  if _is_bank_engines(inner) else widen_state(inner, old, new))
        return state._replace(engine=engine, carry=to_numpy(state.carry))
    check_widens(old, new)
    g = _numpy
    R2, E2, MP2, D2, HB2 = (new.max_runs, new.slab_entries, new.slab_preds,
                            new.dewey_depth, new.handle_ring)
    slab = state.slab
    # Dead run slots take the queue compaction's fill values, free slab
    # rows and pointer slots init_state's: the state a wide engine would
    # have built from the same history.
    new_slab = SlabState(
        stage=_pad(g(slab.stage), -1, E2, -1),
        off=_pad(g(slab.off), -1, E2, -1),
        refs=_pad(g(slab.refs), -1, E2, 0),
        npreds=_pad(g(slab.npreds), -1, E2, 0),
        pstage=_pad(_pad(g(slab.pstage), -1, MP2, -1), -2, E2, -1),
        poff=_pad(_pad(g(slab.poff), -1, MP2, -1), -2, E2, -1),
        pver=_pad(_pad(_pad(g(slab.pver), -1, D2, 0), -2, MP2, 0), -3, E2, 0),
        pvlen=_pad(_pad(g(slab.pvlen), -1, MP2, 0), -2, E2, 0),
        # Counters (and the pattern-shaped stage_hops) copy verbatim.
        **{f: g(getattr(slab, f)) for f in SlabState._fields[8:]},
    )
    # The handle ring's pending handles are a prefix [0, hr_count): appended
    # empty slots are what a wide ring would hold.
    return EngineState(
        alive=_pad(g(state.alive), -1, R2, False),
        id_pos=_pad(g(state.id_pos), -1, R2, -1),
        eval_pos=_pad(g(state.eval_pos), -1, R2, 0),
        ver=_pad(_pad(g(state.ver), -1, D2, 0), -2, R2, 0),
        vlen=_pad(g(state.vlen), -1, R2, 0),
        event_off=_pad(g(state.event_off), -1, R2, -1),
        start_ts=_pad(g(state.start_ts), -1, R2, -1),
        branching=_pad(g(state.branching), -1, R2, False),
        agg=_pad(g(state.agg), -2, R2, 0),
        slab=new_slab,
        run_drops=g(state.run_drops),
        ver_overflows=g(state.ver_overflows),
        hr_stage=_pad(g(state.hr_stage), -1, HB2, -1),
        hr_off=_pad(g(state.hr_off), -1, HB2, -1),
        hr_ver=_pad(_pad(g(state.hr_ver), -1, D2, 0), -2, HB2, 0),
        hr_vlen=_pad(g(state.hr_vlen), -1, HB2, 0),
        hr_ts=_pad(g(state.hr_ts), -1, HB2, 0),
        hr_seq=_pad(g(state.hr_seq), -1, HB2, 0),
        hr_row=_pad(g(state.hr_row), -1, HB2, 0),
        hr_count=g(state.hr_count),
        step_seq=g(state.step_seq),
        handle_overflows=g(state.handle_overflows),
        stage_counts=g(state.stage_counts),
    )


def canonical_state(state):
    """Project ``state`` onto what the engine can observe: dead run slots,
    free slab rows, pointer slots at or past ``npreds`` and ring slots past
    the pending prefix take canonical fill values (they hold residue that
    differs between walk implementations and across a migration).  Two
    states behave alike iff their projections are bit-equal.  Returns a
    host numpy tree; a tiered carry copies as it is (it holds no
    residue)."""
    inner = getattr(state, "engine", None)
    if inner is not None:
        engine = (tuple(canonical_state(e) for e in inner)
                  if _is_bank_engines(inner) else canonical_state(inner))
        return state._replace(engine=engine, carry=to_numpy(state.carry))
    g = _numpy
    alive = g(state.alive)
    slab = state.slab
    stage, npreds = g(slab.stage), g(slab.npreds)
    live_e = stage >= 0
    mp = g(slab.pstage).shape[-1]
    live_p = live_e[..., None] & (np.arange(mp, dtype=np.int32) < npreds[..., None])
    pend = (np.arange(g(state.hr_stage).shape[-1], dtype=np.int32)
            < g(state.hr_count)[..., None])

    def d(m, arr, fill):
        return np.where(m, g(arr), fill)

    host_slab = SlabState(*(g(x) for x in slab))
    return EngineState(
        alive=alive,
        id_pos=d(alive, state.id_pos, -1),
        eval_pos=d(alive, state.eval_pos, 0),
        ver=d(alive[..., None], state.ver, 0),
        vlen=d(alive, state.vlen, 0),
        event_off=d(alive, state.event_off, -1),
        start_ts=d(alive, state.start_ts, -1),
        branching=d(alive, state.branching, False),
        agg=d(alive[..., None], state.agg, 0),
        slab=host_slab._replace(
            off=d(live_e, slab.off, -1),
            refs=d(live_e, slab.refs, 0),
            npreds=d(live_e, npreds, 0),
            pstage=d(live_p, slab.pstage, -1),
            poff=d(live_p, slab.poff, -1),
            pver=d(live_p[..., None], slab.pver, 0),
            pvlen=d(live_p, slab.pvlen, 0),
        ),
        run_drops=g(state.run_drops),
        ver_overflows=g(state.ver_overflows),
        hr_stage=d(pend, state.hr_stage, -1),
        hr_off=d(pend, state.hr_off, -1),
        hr_ver=d(pend[..., None], state.hr_ver, 0),
        hr_vlen=d(pend, state.hr_vlen, 0),
        hr_ts=d(pend, state.hr_ts, 0),
        hr_seq=d(pend, state.hr_seq, 0),
        hr_row=d(pend, state.hr_row, 0),
        hr_count=g(state.hr_count),
        step_seq=g(state.step_seq),
        handle_overflows=g(state.handle_overflows),
        stage_counts=g(state.stage_counts),
    )


def _refuse_pending(proc, what: str) -> None:
    if getattr(proc, "_pending", None) is not None:
        raise ValueError(
            "pipelined processor holds an undecoded batch; call flush() "
            f"before {what} (device outputs are shaped by the old engine)"
        )


def _rebuild(pattern, proc, config: EngineConfig, **kw):
    """A processor of ``pattern`` on ``config`` with ``proc``'s settings,
    its stage names checked against the live one's."""
    from kafkastreams_cep_tpu_torch.runtime.processor import CEPProcessor

    new = CEPProcessor(
        pattern, proc.num_lanes, config, topic=proc.topic, epoch=proc.epoch,
        gc_events=proc.gc_events, dedup=proc.dedup, gc_interval=proc.gc_interval,
        gc_events_interval=proc.gc_events_interval, decode_budget=proc.decode_budget,
        pipeline=proc.pipeline, drain_interval=proc.drain_interval, name=proc.name,
        clock=proc._clock, device=proc.device, **kw,
    )
    if list(new.batch.names) != list(proc.batch.names):
        raise ValueError(
            "pattern topology changed across the rebuild: stages "
            f"{new.batch.names} vs live {proc.batch.names}"
        )
    return new


def _carry_host_state(new, proc) -> None:
    """Continuity of everything but the engine state: the host bookkeeping
    (by copy, as a checkpoint restore would), the metrics, the ingest guard
    and the clock (by reference: one stream, one meter)."""
    new._lane_of = dict(proc._lane_of)
    new._key_of = dict(proc._key_of)
    new._next_offset = proc._next_offset.copy()
    new._off_base = proc._off_base.copy()
    new._events = [dict(d) for d in proc._events]
    new._col_batches = list(proc._col_batches)
    new._value_proto = proc._value_proto
    new._step_base = proc._step_base  # pending-handle ordering base
    new._watermark = proc._watermark
    new._batch_seq = proc._batch_seq
    new.metrics = proc.metrics
    new._guard = proc._guard


def migrate_processor(pattern, proc, new_config: EngineConfig, mesh=None):
    """Rebuild a live :class:`CEPProcessor` on a strictly wider config.

    ``pattern`` is compiled fresh (code never migrates, only state); the
    widened state goes on the processor's device and the host bookkeeping
    carries over as a checkpoint restore would, without touching disk.
    The processor must hold no undecoded pipelined batch (``flush()``
    first)."""
    _no_mesh(mesh)
    _refuse_pending(proc, "migrating")
    old_config = proc.batch.matcher.config
    check_widens(old_config, new_config)
    new_proc = _rebuild(pattern, proc, new_config)
    new_proc.state = new_proc.place(widen_state(proc.state, old_config, new_config))
    _carry_host_state(new_proc, proc)
    logger.info(
        "migrated processor %s -> %s",
        {f: getattr(old_config, f) for f in _SHAPE_DIMS},
        {f: getattr(new_config, f) for f in _SHAPE_DIMS},
    )
    return new_proc


def replan_processor(pattern, proc, profile):
    """Swap a live tiered :class:`CEPProcessor` onto a plan re-derived from
    ``profile`` (a measured ``per_stage`` snapshot, optionally with
    per-conjunct rows).  The config is unchanged, conjunct reordering
    commutes and the tier split depends on pattern and config alone, so
    every state leaf transfers verbatim and the match stream is the same
    wherever the swap lands.  ``flush()`` a pipelined processor first."""
    _refuse_pending(proc, "replanning")
    config = proc.batch.matcher.config
    if not getattr(config, "tiering", False):
        raise ValueError("replan_processor requires a tiered processor")
    new_proc = _rebuild(pattern, proc, config, profile=profile)
    new_proc.state = new_proc.place(to_numpy(proc.state))
    _carry_host_state(new_proc, proc)
    logger.info(
        "replanned processor: tier=%s lazy_order=%s",
        new_proc.batch.plan.tier,
        {s: r.get("order") for s, r in getattr(new_proc.batch, "lazy_order", {}).items()
         if r.get("reordered")},
    )
    return new_proc


def repartition_state(state, perm: Sequence[int]):
    """Permute the lane axis ``[K]`` of every state leaf: ``new[i] =
    old[perm[i]]``.  Returns a host numpy tree (an engine, tiered or
    tenant bank state alike: the prefix carry is per lane too)."""
    perm = np.asarray(perm, dtype=np.int64).reshape(-1)
    k = perm.shape[0]
    if not np.array_equal(np.sort(perm), np.arange(k)):
        raise ValueError(f"perm is not a permutation of range({k}): {perm.tolist()}")

    def take(x):
        arr = _numpy(x)
        if arr.ndim == 0 or arr.shape[0] != k:
            raise ValueError(
                f"state leaf shape {arr.shape} has no leading [{k}] lane "
                "axis; repartition_state requires lane-batched state"
            )
        return arr[perm]

    return tree_map(take, state)


def plan_rebalance(loads: Sequence[int], num_shards: int) -> Optional[np.ndarray]:
    """A lane permutation that balances per-shard load, or ``None``.

    ``loads`` is a per-lane cost (walk + extract + drain hops over a
    window); shards own contiguous blocks of ``K / num_shards`` lanes.
    Greedy LPT: lanes in descending cost (stable), each to the least
    loaded shard with room (index tie-break); the permutation is the
    blocks concatenated.  ``None`` when the plan would not strictly lower
    the largest shard load (or ``K`` does not split evenly)."""
    loads = np.asarray(loads, dtype=np.int64).reshape(-1)
    k = loads.shape[0]
    n = int(num_shards)
    if n < 2 or k % n:
        return None
    per = k // n
    old_max = int(loads.reshape(n, per).sum(axis=1).max())
    shard_load = np.zeros(n, dtype=np.int64)
    blocks: list = [[] for _ in range(n)]
    for lane in np.argsort(-loads, kind="stable"):
        dest = min((s for s in range(n) if len(blocks[s]) < per),
                   key=lambda s: (int(shard_load[s]), s))
        blocks[dest].append(int(lane))
        shard_load[dest] += int(loads[lane])
    if int(shard_load.max()) >= old_max:
        return None
    return np.asarray([lane for b in blocks for lane in b], dtype=np.int64)


def move_lanes(pattern, proc, perm=None, mesh=_KEEP_MESH):
    """Rebuild a live :class:`CEPProcessor` under a new lane assignment:
    state rows permuted by ``perm`` (:func:`repartition_state`) and every
    lane-indexed host structure (key routing, offsets, the event mirror,
    queued column batches, the ingest guard's per-lane high-waters) by the
    same permutation.  On one device; ``flush()`` a pipelined processor
    first."""
    _no_mesh(mesh)
    _refuse_pending(proc, "moving lanes")
    k = proc.num_lanes
    perm = (np.arange(k, dtype=np.int64) if perm is None
            else np.asarray(perm, dtype=np.int64).reshape(-1))
    if perm.shape[0] != k or not np.array_equal(np.sort(perm), np.arange(k)):
        raise ValueError(f"perm must be a permutation of range({k}): {perm.tolist()}")
    inv = np.empty(k, dtype=np.int64)
    inv[perm] = np.arange(k, dtype=np.int64)
    new_proc = _rebuild(pattern, proc, proc.batch.matcher.config)
    new_proc.state = new_proc.place(repartition_state(proc.state, perm))
    _carry_host_state(new_proc, proc)
    # Old lane ``p`` becomes new lane ``inv[p]``.
    new_proc._lane_of = {key: int(inv[l]) for key, l in proc._lane_of.items()}
    new_proc._key_of = {int(inv[l]): key for l, key in proc._key_of.items()}
    new_proc._next_offset = proc._next_offset[perm].copy()
    new_proc._off_base = proc._off_base[perm].copy()
    new_proc._events = [dict(proc._events[int(p)]) for p in perm]
    new_proc._col_batches = [
        tuple([leaf[perm] for leaf in part] if isinstance(part, (list, tuple))
              else np.asarray(part)[perm] for part in entry)
        for entry in proc._col_batches
    ]
    if new_proc._guard is not None:
        new_proc._guard.source_hw = {
            int(inv[l]): hw for l, hw in new_proc._guard.source_hw.items()
        }
    logger.info("moved %d/%d lanes", int((perm != np.arange(k)).sum()), k)
    return new_proc
