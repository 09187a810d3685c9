"""The shared versioned buffer as a fixed slab of tensors, one per lane.

The PyTorch counterpart of ``kafkastreams_cep_tpu/ops/slab.py``: the same
representation, the same semantics and the same counters, with the lane
axis ``[K]`` written out in front of every field (the JAX package ``vmap``s
one lane's functions instead).

Representation (``E`` entries x ``MP`` predecessor pointers x depth ``D``):

* an *entry* is keyed by ``(stage, off)`` — the stage's canonical identity
  position and the event offset (``StackEventKey.java:28-54``);
  ``stage == -1`` marks a free slot;
* each entry carries a refcount and an ordered list of Dewey-versioned
  predecessor pointers (``TimedKeyValue.java:27-45``); a pointer with
  ``pstage == -1`` is the null-predecessor run origin
  (``KVSharedVersionedBuffer.java:117-128``).

Semantics (as in the reference, differentially tested against the JAX
package):

* ``put`` requires the predecessor entry to exist — the reference throws
  (``KVSharedVersionedBuffer.java:86-89``); here the miss is counted in
  ``missing`` and the write dropped;
* ``put_first`` overwrites unconditionally (``:117-128``);
* walks take, at each hop, the **first** pointer (insertion order) whose
  version is compatible with the walk version, then adopt that pointer's
  version (``TimedKeyValue.java:83-92``);
* refcount decrements floor at zero (``TimedKeyValue.java:59-61``); an entry
  is deleted only when removing, ``refs == 0`` and it has at most one
  predecessor; the traversed pointer is pruned when ``refs == 0``
  (``KVSharedVersionedBuffer.java:147-171``);
* capacity limits (slab full, pointer list full, walk bound) are counted,
  never raised.

Two-tier layout (``hot_entries > 0``, ``EngineConfig.slab_hot_entries``):
slots ``[0, hot_entries)`` are the hot tier.  A new entry takes the lowest
free hot slot; when the hot tier is full, the least-recent hot entry (least
``off``, lowest index on ties) moves with its whole row to the lowest free
overflow slot and its hot slot is reused (``demotions``).  An allocation
fails only when the whole slab is full, so every drop counter equals the
single tier's.  Lookups stay full-slab (keys are unique, so results do not
depend on placement); each walk hop is only *counted* by tier
(``hot_hits``, ``hot_misses``, ``overflow_walks``).

Every function here is functional: it returns new tensors and leaves its
arguments untouched (in-place updates only touch fresh clones).  Entry
keys are assumed unique per lane, as every engine-built slab's are.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kafkastreams_cep_tpu_torch.ops import dewey_ops

I32 = torch.int32


class SlabState(NamedTuple):
    stage: torch.Tensor  # [K, E] int32 — identity stage position; -1 free
    off: torch.Tensor  # [K, E] int32 — event offset
    refs: torch.Tensor  # [K, E] int32
    npreds: torch.Tensor  # [K, E] int32
    pstage: torch.Tensor  # [K, E, MP] int32 — -1 = null pointer (run origin)
    poff: torch.Tensor  # [K, E, MP] int32
    pver: torch.Tensor  # [K, E, MP, D] int32
    pvlen: torch.Tensor  # [K, E, MP] int32
    full_drops: torch.Tensor  # [K] int32 — entry allocation failures
    pred_drops: torch.Tensor  # [K] int32 — pointer-list overflow drops
    missing: torch.Tensor  # [K] int32 — lookups the reference would NPE on
    trunc: torch.Tensor  # [K] int32 — walks cut short by the walk bound
    collisions: torch.Tensor  # [K] int32 — lockstep walker meetings (0 here:
    #   walkers always run one at a time)
    hot_hits: torch.Tensor  # [K] int32 — two-tier telemetry (0: single tier)
    hot_misses: torch.Tensor  # [K] int32
    overflow_walks: torch.Tensor  # [K] int32
    demotions: torch.Tensor  # [K] int32
    walk_hops: torch.Tensor  # [K] int32 — branch/dead-removal walker hops
    extract_hops: torch.Tensor  # [K] int32 — in-step extraction hops
    drain_hops: torch.Tensor  # [K] int32 — lazy drain hops (0: eager engine)
    stage_hops: torch.Tensor  # [K, S] int32 — per-stage hops ([K, 0] when off)


#: The per-lane counters, in ``SlabState`` order.
COUNTERS = (
    "full_drops", "pred_drops", "missing", "trunc", "collisions",
    "hot_hits", "hot_misses", "overflow_walks", "demotions",
    "walk_hops", "extract_hops", "drain_hops",
)


def make(
    num_lanes: int, num_entries: int, max_preds: int, depth: int,
    num_stages: int = 0, device="cpu",
) -> SlabState:
    K, E, MP, D = num_lanes, num_entries, max_preds, depth

    def full(shape, v):
        return torch.full(shape, v, dtype=I32, device=device)

    return SlabState(
        stage=full((K, E), -1),
        off=full((K, E), -1),
        refs=full((K, E), 0),
        npreds=full((K, E), 0),
        pstage=full((K, E, MP), -1),
        poff=full((K, E, MP), -1),
        pver=full((K, E, MP, D), 0),
        pvlen=full((K, E, MP), 0),
        **{c: full((K,), 0) for c in COUNTERS},
        stage_hops=full((K, num_stages), 0),
    )


def clone(slab: SlabState) -> SlabState:
    return SlabState(*(x.clone() for x in slab))


def _count(mask: torch.Tensor, dim=None) -> torch.Tensor:
    """Number of True in ``mask`` (over ``dim``, or the last axis) as int32."""
    return mask.sum(dim=-1 if dim is None else dim, dtype=I32)


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return mask.to(I32).argmax(dim=-1)


def find(slab: SlabState, stage, off):
    """Entry index of ``(stage, off)`` per lane and whether it exists."""
    hit = (slab.stage == stage[:, None]) & (slab.off == off[:, None])
    return _first(hit), hit.any(dim=1)


def _lanes(slab: SlabState) -> torch.Tensor:
    return torch.arange(slab.stage.shape[0], device=slab.stage.device)


def _alloc_slot(slab: SlabState, hot_entries: int, want):
    """Allocation slot for one new entry per lane: ``(e, ok)``.

    Single tier: the lowest free slot.  Two-tier: the lowest free hot slot,
    else the least-recent hot entry, which ``want`` lanes first demote to
    the lowest free overflow slot (in place on ``slab``).  Pass ``want =
    enable & ~found`` so that a put onto an existing entry never demotes."""
    free = slab.stage < 0
    if not hot_entries:
        return _first(free), free.any(dim=1)
    EH = hot_entries
    ar = _lanes(slab)
    E = slab.stage.shape[1]
    is_hot = torch.arange(E, device=free.device) < EH
    any_fh = (free & is_hot).any(dim=1)
    any_fo = (free & ~is_hot).any(dim=1)
    e_hot = _first(free & is_hot)
    e_ov = _first(free & ~is_hot)
    # The victim: least event offset among occupied hot rows, first index
    # on ties (torch.argmin returns the first minimum).
    okey = torch.where(~free & is_hot, slab.off, 1 << 30)
    victim = okey.argmin(dim=1)
    demote = want & ~any_fh & any_fo
    for f in (slab.stage, slab.off, slab.refs, slab.npreds, slab.pstage,
              slab.poff, slab.pvlen, slab.pver):
        m = demote.reshape((-1,) + (1,) * (f.dim() - 2))
        f[ar, e_ov] = torch.where(m, f[ar, victim], f[ar, e_ov])
    for f in (slab.stage, slab.off):
        f[ar, victim] = torch.where(demote, -1, f[ar, victim])
    slab.demotions.add_(demote.to(I32))
    return torch.where(any_fh, e_hot, victim), any_fh | any_fo


def _hop_counts(slab: SlabState, active, stage, want_out=None,
                kind: str = "walk", hot_entries: int = 0, hit=None):
    """Count one hop of each lane's walker (in place on ``slab``).

    ``want_out`` splits the walkers: emitting ones count to ``kind``
    (``"extract"`` in-step, ``"drain"`` deferred), the others to
    ``walk_hops``; without it every walker counts to ``kind``.  With
    ``hot_entries`` the hop is also counted by the tier its entry (``hit
    [K, E]``) lies in; with stage attribution on (``stage_hops [K, S]``,
    ``S > 0``) it is tallied at the walker's current ``stage``."""
    emit = active if want_out is None else active & want_out
    if want_out is not None:
        slab.walk_hops.add_((active & ~want_out).to(I32))
    getattr(slab, f"{kind}_hops").add_(emit.to(I32))
    if hot_entries:
        found = hit.any(dim=1)
        found_hot = hit[:, :hot_entries].any(dim=1)
        slab.hot_hits.add_((active & found_hot).to(I32))
        slab.hot_misses.add_((active & ~found_hot).to(I32))
        slab.overflow_walks.add_((active & ~found_hot & found).to(I32))
    S = slab.stage_hops.shape[1]
    if S:
        oh = stage[:, None] == torch.arange(S, device=stage.device)
        slab.stage_hops.add_((oh & active[:, None]).to(I32))


def _append_pointer(slab, e, pstage, poff, ver, vlen, enable):
    """Append a pointer to entry ``e`` of each lane (in place on ``slab``);
    drops (counted) when the list is full."""
    ar = _lanes(slab)
    MP = slab.pstage.shape[2]
    n = slab.npreds[ar, e]
    full = n >= MP
    do = enable & ~full
    slot = torch.clamp(n, max=MP - 1)
    slab.pstage[ar, e, slot] = torch.where(do, pstage, slab.pstage[ar, e, slot])
    slab.poff[ar, e, slot] = torch.where(do, poff, slab.poff[ar, e, slot])
    slab.pvlen[ar, e, slot] = torch.where(do, vlen, slab.pvlen[ar, e, slot])
    slab.pver[ar, e, slot] = torch.where(
        do[:, None], ver, slab.pver[ar, e, slot]
    )
    slab.npreds[ar, e] = n + do.to(I32)
    slab.pred_drops.add_((enable & full).to(I32))


def put_first(slab: SlabState, stage, off, ver, vlen, enable,
              hot_entries: int = 0) -> SlabState:
    """First-stage put: a fresh entry whose single null-predecessor pointer
    records the run version; overwrites any existing entry
    (``KVSharedVersionedBuffer.java:117-128``).  One op per lane."""
    slab = clone(slab)
    _put_first_(slab, stage, off, ver, vlen, enable, hot_entries)
    return slab


def _put_first_(slab, stage, off, ver, vlen, enable, hot_entries):
    ar = _lanes(slab)
    existing, found = find(slab, stage, off)
    free_e, has_free = _alloc_slot(slab, hot_entries, enable & ~found)
    e = torch.where(found, existing, free_e)
    ok = enable & (found | has_free)
    slab.stage[ar, e] = torch.where(ok, stage, slab.stage[ar, e])
    slab.off[ar, e] = torch.where(ok, off, slab.off[ar, e])
    slab.refs[ar, e] = torch.where(ok, 1, slab.refs[ar, e])
    slab.npreds[ar, e] = torch.where(ok, 0, slab.npreds[ar, e])
    slab.full_drops.add_((enable & ~found & ~has_free).to(I32))
    null = torch.full_like(stage, -1)
    _append_pointer(slab, e, null, null, ver, vlen, ok)


def put(
    slab: SlabState, cur_stage, cur_off, prev_stage, prev_off, ver, vlen,
    enable, hot_entries: int = 0,
) -> SlabState:
    """Append a versioned predecessor pointer to ``(cur_stage, cur_off)``.

    The predecessor entry must exist (``KVSharedVersionedBuffer.java:86-89``);
    a miss is counted and the write dropped.  One op per lane."""
    slab = clone(slab)
    _put_(slab, cur_stage, cur_off, prev_stage, prev_off, ver, vlen, enable,
          hot_entries)
    return slab


def _put_(slab, cur_stage, cur_off, prev_stage, prev_off, ver, vlen, enable,
          hot_entries):
    ar = _lanes(slab)
    _, prev_found = find(slab, prev_stage, prev_off)
    slab.missing.add_((enable & ~prev_found).to(I32))
    enable = enable & prev_found
    existing, found = find(slab, cur_stage, cur_off)
    free_e, has_free = _alloc_slot(slab, hot_entries, enable & ~found)
    e = torch.where(found, existing, free_e)
    create = enable & ~found & has_free
    ok = enable & (found | has_free)
    slab.stage[ar, e] = torch.where(create, cur_stage, slab.stage[ar, e])
    slab.off[ar, e] = torch.where(create, cur_off, slab.off[ar, e])
    slab.refs[ar, e] = torch.where(create, 1, slab.refs[ar, e])
    slab.npreds[ar, e] = torch.where(create, 0, slab.npreds[ar, e])
    slab.full_drops.add_((enable & ~found & ~has_free).to(I32))
    _append_pointer(slab, e, prev_stage, prev_off, ver, vlen, ok)


def _select_pointer(slab, e, qver, qlen, live):
    """First version-compatible live pointer of entry ``e`` per lane
    (``TimedKeyValue.java:83-92``): ``(j, any)``."""
    ar = _lanes(slab)
    ok = dewey_ops.is_compatible(
        qver[:, None, :], qlen[:, None],
        slab.pver[ar, e], slab.pvlen[ar, e],
    ) & live
    return _first(ok), ok.any(dim=1)


def branch(slab: SlabState, stage, off, ver, vlen, max_walk: int, enable,
           hot_entries: int = 0):
    """Refcount-increment walk so shared prefixes survive sibling removal
    (``KVSharedVersionedBuffer.java:99-110``).  One walker per lane."""
    slab = clone(slab)
    ar = _lanes(slab)
    MP = slab.pstage.shape[2]
    slots = torch.arange(MP, device=stage.device)
    active = enable.clone()
    for _ in range(max_walk):
        hit = (slab.stage == stage[:, None]) & (slab.off == off[:, None])
        e, found = _first(hit), hit.any(dim=1)
        _hop_counts(slab, active, stage, hot_entries=hot_entries, hit=hit)
        slab.missing.add_((active & ~found).to(I32))
        active = active & found
        slab.refs[ar, e] += active.to(I32)
        live = slots[None, :] < slab.npreds[ar, e][:, None]
        j, sel = _select_pointer(slab, e, ver, vlen, live)
        nxt = slab.pstage[ar, e, j]
        active = active & sel & (nxt >= 0)
        stage = torch.where(active, nxt, stage)
        off = torch.where(active, slab.poff[ar, e, j], off)
        ver = torch.where(active[:, None], slab.pver[ar, e, j], ver)
        vlen = torch.where(active, slab.pvlen[ar, e, j], vlen)
    # A walk still active after max_walk hops was truncated.
    slab.trunc.add_(active.to(I32))
    return slab


def peek(
    slab: SlabState, stage, off, ver, vlen, max_walk: int, remove: bool,
    enable, hop_kind: str = "extract", hot_entries: int = 0,
):
    """Backward pointer walk assembling a match, final stage first; one
    walker per lane.  With ``remove`` this is ``SharedVersionedBuffer.remove``
    (refcount GC + physical pointer pruning); without, ``get``, which still
    decrements refcounts (``KVSharedVersionedBuffer.peek``, ``:156``).

    Returns ``(slab, out_stage [K, W], out_off [K, W], count [K])``."""
    slab = clone(slab)
    ar = _lanes(slab)
    K, MP = slab.stage.shape[0], slab.pstage.shape[2]
    slots = torch.arange(MP, device=stage.device)
    out_stage = torch.full((K, max_walk), -1, dtype=I32, device=stage.device)
    out_off = out_stage.clone()
    count = torch.zeros((K,), dtype=I32, device=stage.device)
    active = enable.clone()
    for i in range(max_walk):
        hit = (slab.stage == stage[:, None]) & (slab.off == off[:, None])
        e, found = _first(hit), hit.any(dim=1)
        _hop_counts(slab, active, stage, kind=hop_kind,
                    hot_entries=hot_entries, hit=hit)
        slab.missing.add_((active & ~found).to(I32))
        active = active & found
        refs_left = torch.clamp(slab.refs[ar, e] - 1, min=0)
        slab.refs[ar, e] = torch.where(active, refs_left, slab.refs[ar, e])
        npreds = slab.npreds[ar, e]
        delete = active & remove & (refs_left == 0) & (npreds <= 1)
        slab.stage[ar, e] = torch.where(delete, -1, slab.stage[ar, e])
        slab.off[ar, e] = torch.where(delete, -1, slab.off[ar, e])
        out_stage[:, i] = torch.where(active, stage, out_stage[:, i])
        out_off[:, i] = torch.where(active, off, out_off[:, i])
        count += active.to(I32)
        j, sel = _select_pointer(
            slab, e, ver, vlen, slots[None, :] < npreds[:, None]
        )
        sel = sel & active
        prune = sel & remove & (refs_left == 0)
        nxt_stage = slab.pstage[ar, e, j]
        nxt_off = slab.poff[ar, e, j]
        nxt_ver = slab.pver[ar, e, j]
        nxt_len = slab.pvlen[ar, e, j]
        # Physical prune: slots >= j shift left, the last keeping its own
        # value (TimedKeyValue.removePredecessor).
        shift = prune[:, None] & (slots[None, :] >= j[:, None])
        src = torch.clamp(slots + 1, max=MP - 1)
        for f in (slab.pstage, slab.poff, slab.pvlen, slab.pver):
            row = f[ar, e]
            m = shift if row.dim() == 2 else shift[:, :, None]
            f[ar, e] = torch.where(m, row[:, src], row)
        slab.npreds[ar, e] -= prune.to(I32)
        active = sel & (nxt_stage >= 0)
        stage = torch.where(active, nxt_stage, stage)
        off = torch.where(active, nxt_off, off)
        ver = torch.where(active[:, None], nxt_ver, ver)
        vlen = torch.where(active, nxt_len, vlen)
    slab.trunc.add_(active.to(I32))
    return slab, out_stage, out_off, count


def mark_sweep(slab: SlabState, run_off, depth: int) -> SlabState:
    """Free every entry unreachable from live run state, per lane (the
    deferred compaction scan of SURVEY §7 step 4; see the JAX package's
    ``ops/slab.py: mark_sweep`` for why this is observably equivalent to
    the reference's unbounded refcount GC).

    ``run_off`` is ``[K, N]``: the live runs' pointer-event offsets
    (``< 0`` rows ignored).  Roots are keyed by offset alone; marking
    follows every live pointer, whatever its version."""
    MP = slab.pstage.shape[2]
    live_entry = slab.stage >= 0
    root_hit = (slab.off[:, :, None] == run_off[:, None, :]) & (
        run_off[:, None, :] >= 0
    )  # [K, E, N]
    marked = root_hit.any(dim=2) & live_entry
    slots = torch.arange(MP, device=slab.stage.device)
    valid_ptr = (slots[None, None, :] < slab.npreds[:, :, None]) & (
        slab.pstage >= 0
    )  # [K, E, MP]
    # adj[k, e, e']: some live pointer of e keys (stage, off)[e'].
    adj = (
        (slab.pstage[:, :, :, None] == slab.stage[:, None, None, :])
        & (slab.poff[:, :, :, None] == slab.off[:, None, None, :])
        & valid_ptr[:, :, :, None]
    ).any(dim=2)  # [K, E, E']
    for _ in range(depth):
        reach = (adj & marked[:, :, None]).any(dim=1)
        marked = marked | (reach & live_entry)
    free = ~marked
    return slab._replace(
        stage=torch.where(free, -1, slab.stage),
        off=torch.where(free, -1, slab.off),
        refs=torch.where(free, 0, slab.refs),
        npreds=torch.where(free, 0, slab.npreds),
    )


class PutOps(NamedTuple):
    """One step's consuming puts per lane, flattened in reference order
    (queue order, then frame order within a run)."""

    en: torch.Tensor  # [K, P] bool
    first: torch.Tensor  # [K, P] bool — put_first (null-predecessor origin)
    cur_stage: torch.Tensor  # [K, P] int32 — target stage (identity position)
    prev_stage: torch.Tensor  # [K, P] int32 — -1 for first puts
    prev_off: torch.Tensor  # [K, P] int32
    ver: torch.Tensor  # [K, P, D] int32
    vlen: torch.Tensor  # [K, P] int32


def puts_batched(slab: SlabState, ops: PutOps, off,
                 hot_entries: int = 0) -> SlabState:
    """All of one step's consuming puts in one pass, per lane.

    The closed form of ``kafkastreams_cep_tpu/ops/slab.py: puts_batched``:
    chained puts need an existing predecessor (else counted ``missing``);
    the *last* ``put_first`` of a target group resets the entry and erases
    the group's earlier appends (the ``KVSharedVersionedBuffer.java:117-128``
    overwrite quirk); surviving appends take consecutive pointer slots in
    op order.  Every put of a step targets the current event ``off [K]``,
    so groups are keyed by ``cur_stage``; predecessors are older events,
    so no op's predecessor lookup sees another op of the step.

    Two-tier slabs (``hot_entries > 0``) take :func:`_puts_sequential`
    instead: the closed form ranks creators onto free slots, while two-tier
    allocation interleaves demotions between creations.
    """
    if hot_entries:
        return _puts_sequential(slab, ops, off, hot_entries)
    K, E = slab.stage.shape
    MP = slab.pstage.shape[2]
    P = ops.en.shape[1]
    dev = slab.stage.device
    pidx = torch.arange(P, device=dev)
    earlier = pidx[None, :] < pidx[:, None]  # [p, q]: q before p
    later = pidx[None, :] > pidx[:, None]
    cur = ops.cur_stage

    def per_group(mask):  # [K, P] -> [K, P, Q] as the q operand
        return mask[:, None, :]

    prev_hit = (slab.stage[:, None, :] == ops.prev_stage[:, :, None]) & (
        slab.off[:, None, :] == ops.prev_off[:, :, None]
    )
    prev_found = prev_hit.any(dim=2)
    miss = ops.en & ~ops.first & ~prev_found
    en = ops.en & (ops.first | prev_found)

    same = cur[:, None, :] == cur[:, :, None]  # [K, P, Q]
    cur_hit = (slab.stage[:, None, :] == cur[:, :, None]) & (
        slab.off[:, None, :] == off[:, None, None]
    )  # [K, P, E]
    exist0 = cur_hit.any(dim=2)
    e0 = _first(cur_hit)

    # The first enabled op of a group whose entry does not exist claims the
    # next free slot (creators ranked in op order).
    first_of_group = en & ~(same & earlier & per_group(en)).any(dim=2)
    creator = first_of_group & ~exist0
    crank = torch.cumsum(creator.to(I32), dim=1) - 1
    free = slab.stage < 0
    nfree = _count(free)
    free_rank = torch.cumsum(free.to(I32), dim=1) - 1
    alloc_hit = (
        free[:, None, :]
        & (free_rank[:, None, :] == crank[:, :, None])
        & creator[:, :, None]
    )
    has_free = creator & (crank < nfree[:, None])
    grp_creator = same & per_group(creator)
    e_created = torch.where(grp_creator, _first(alloc_hit)[:, None, :], 0).sum(
        dim=2, dtype=I32
    )
    grp_has_free = (grp_creator & per_group(has_free)).any(dim=2)
    e = torch.where(exist0, e0, e_created)
    entry_ok = en & (exist0 | grp_has_free)
    full = en & ~exist0 & ~grp_has_free

    # Reset segments: a landing put_first resets its entry's pointer list;
    # every segment's appends happen (and may overflow, counted), but only
    # the last segment's writes survive.
    isfirst_ok = entry_ok & ops.first
    reset_at_or_before = same & ~later & per_group(isfirst_ok)
    has_reset = reset_at_or_before.any(dim=2)
    seg_head = torch.where(reset_at_or_before, pidx, -1).amax(dim=2)
    seg_eq = same & (seg_head[:, None, :] == seg_head[:, :, None])
    npreds0 = torch.where(cur_hit, slab.npreds[:, None, :], 0).sum(
        dim=2, dtype=I32
    )
    base = torch.where(has_reset | ~exist0, 0, npreds0)
    prior = _count(seg_eq & earlier & per_group(entry_ok))
    slot = torch.clamp(base + prior, max=MP)
    pred_drop = entry_ok & (slot >= MP)
    last_seg = ~(same & later & per_group(isfirst_ok)).any(dim=2)
    fit = entry_ok & last_seg & (slot < MP)
    grp_has_first = (same & per_group(isfirst_ok)).any(dim=2)
    base_n = torch.where(grp_has_first | ~exist0, 0, npreds0)

    # Pointer writes: cell (e, slot) of every fitting op.
    cell = torch.where(fit, e * MP + slot, 0).long()  # [K, P]

    def write(field, val):
        flat = field.reshape(K, E * MP, -1)
        v = torch.where(fit, val, 0) if val.dim() == 2 else torch.where(
            fit[:, :, None], val, 0
        )
        v = v.reshape(K, P, -1)
        idx = cell[:, :, None].expand_as(v)
        upd = torch.zeros_like(flat).scatter_add_(1, idx, v)
        hit = torch.zeros_like(flat).scatter_add_(
            1, idx, fit[:, :, None].to(I32).expand_as(v)
        )
        return torch.where(hit > 0, upd, flat).reshape(field.shape)

    first = ops.first
    new_pstage = write(slab.pstage, torch.where(first, -1, ops.prev_stage))
    new_poff = write(slab.poff, torch.where(first, -1, ops.prev_off))
    new_pvlen = write(slab.pvlen, ops.vlen)
    new_pver = write(slab.pver, ops.ver)

    # Entry metadata, group-consistent.
    cnt = _count(same & per_group(fit))
    npreds_val = torch.clamp(base_n + cnt, max=MP)
    reset_refs = grp_has_first | ~exist0
    ge = (torch.arange(E, device=dev)[None, None, :] == e[:, :, None]) & (
        entry_ok[:, :, None]
    )  # [K, P, E]
    anyop = ge.any(dim=1)
    npreds_e = torch.where(ge, npreds_val[:, :, None], 0).amax(dim=1)
    setref_e = (ge & reset_refs[:, :, None]).any(dim=1)
    stage_e = torch.where(ge, cur[:, :, None], -1).amax(dim=1)
    return slab._replace(
        stage=torch.where(anyop, stage_e, slab.stage),
        off=torch.where(anyop, off[:, None], slab.off),
        refs=torch.where(anyop & setref_e, 1, slab.refs),
        npreds=torch.where(anyop, npreds_e, slab.npreds),
        pstage=new_pstage,
        poff=new_poff,
        pvlen=new_pvlen,
        pver=new_pver,
        missing=slab.missing + _count(miss),
        full_drops=slab.full_drops + _count(full),
        pred_drops=slab.pred_drops + _count(pred_drop),
    )


def _puts_sequential(slab: SlabState, ops: PutOps, off,
                     hot_entries: int) -> SlabState:
    """One step's consuming puts one op at a time, in queue order: each op
    is a ``put_first`` or a chained ``put``, allocating through
    :func:`_alloc_slot` (``kafkastreams_cep_tpu/ops/slab.py:
    _puts_sequential``)."""
    slab = clone(slab)
    for p in range(ops.en.shape[1]):
        en, first = ops.en[:, p], ops.first[:, p]
        if not bool(en.any()):
            continue  # a no-op for every lane
        cur, ver, vlen = ops.cur_stage[:, p], ops.ver[:, p], ops.vlen[:, p]
        _put_first_(slab, cur, off, ver, vlen, en & first, hot_entries)
        _put_(slab, cur, off, ops.prev_stage[:, p], ops.prev_off[:, p], ver,
              vlen, en & ~first, hot_entries)
    return slab


def walks_compacted(
    slab: SlabState, en, stage, off, ver, vlen, is_remove, want_out,
    max_walk: int, out_base: int, out_rows: int, hot_entries: int = 0,
    drain: bool = False,
):
    """The step's walk pass, per lane, one walker at a time in queue order.

    Every enabled candidate walker (branch refcount walks, dead-run
    removals, final-match extractions) is served in queue-order rank —
    the reference's sequential order, and the ``walker_budget=1`` form of
    ``kafkastreams_cep_tpu/ops/slab.py: walks_compacted``.  Lanes are
    independent: batch ``b`` serves every lane's rank-``b`` walker.

    A walker tombstones the pointers it prunes and reads the pointer lists
    as they stood when it started; when it ends, each entry it pruned is
    compacted (surviving pointers to the front in order, zeros behind) —
    exactly the JAX pass's bookkeeping, so every slab leaf agrees bit for
    bit.  Only candidate rows ``[out_base, out_base + out_rows)`` may
    emit.  Emitting hops count to ``drain_hops`` with ``drain`` (the lazy
    drain pass), else to ``extract_hops``; ``hot_entries`` adds the tier
    counts of each hop, and a slab with ``stage_hops [K, S > 0]`` tallies
    each hop at the walker's current stage.

    Returns ``(slab, out_stage [K, OR, W], out_off [K, OR, W],
    count [K, OR])``.
    """
    slab = clone(slab)
    K, E = slab.stage.shape
    MP = slab.pstage.shape[2]
    W, OR = max_walk, out_rows
    dev = slab.stage.device
    ar = _lanes(slab)
    slots = torch.arange(MP, device=dev)
    out_stage = torch.full((K, OR, W), -1, dtype=I32, device=dev)
    out_off = out_stage.clone()
    count = torch.zeros((K, OR), dtype=I32, device=dev)
    rank = torch.cumsum(en.to(I32), dim=1) - 1
    n_batches = int(_count(en).max()) if K else 0

    for b in range(n_batches):
        sel_p = en & (rank == b)
        served = sel_p.any(dim=1)
        p = _first(sel_p)
        cs, co = stage[ar, p], off[ar, p]
        qv, ql = ver[ar, p], vlen[ar, p]
        rem, wot = is_remove[ar, p], want_out[ar, p]
        valid0 = slots[None, None, :] < slab.npreds[:, :, None]  # [K, E, MP]
        dead = torch.zeros_like(valid0)
        active = served.clone()
        cnt = torch.zeros((K,), dtype=I32, device=dev)
        hop_stage = torch.full((K, W), -1, dtype=I32, device=dev)
        hop_off = hop_stage.clone()
        for _ in range(W):
            if not bool(active.any()):
                break
            hit = (slab.stage == cs[:, None]) & (slab.off == co[:, None])
            found = hit.any(dim=1)
            _hop_counts(slab, active, cs, wot, "drain" if drain else "extract",
                        hot_entries, hit)
            slab.missing.add_((active & ~found).to(I32))
            active = active & found
            e = _first(hit)
            refs_e = slab.refs[ar, e]
            newref = torch.where(rem, torch.clamp(refs_e - 1, min=0), refs_e + 1)
            slab.refs[ar, e] = torch.where(active, newref, refs_e)
            live = valid0[ar, e] & ~dead[ar, e]  # [K, MP]
            delete = active & rem & (newref == 0) & (_count(live) <= 1)
            slab.stage[ar, e] = torch.where(delete, -1, slab.stage[ar, e])
            slab.off[ar, e] = torch.where(delete, -1, slab.off[ar, e])

            emit = active & wot
            col = torch.clamp(cnt, max=W - 1)
            hop_stage[ar, col] = torch.where(emit, cs, hop_stage[ar, col])
            hop_off[ar, col] = torch.where(emit, co, hop_off[ar, col])
            cnt += emit.to(I32)

            j, sel = _select_pointer(slab, e, qv, ql, live)
            sel = sel & active
            prune = sel & rem & (newref == 0)
            dead[ar, e, j] |= prune
            slab.npreds[ar, e] -= prune.to(I32)
            ns = slab.pstage[ar, e, j]
            nactive = sel & (ns >= 0)
            cs = torch.where(nactive, ns, cs)
            co = torch.where(nactive, slab.poff[ar, e, j], co)
            ql = torch.where(nactive, slab.pvlen[ar, e, j], ql)
            qv = torch.where(nactive[:, None], slab.pver[ar, e, j], qv)
            # Extraction walkers get W emitting hops; both truncations are
            # counted.
            budget_out = emit & (cnt >= W)
            slab.trunc.add_((budget_out & nactive).to(I32))
            active = nactive & ~budget_out
        slab.trunc.add_(active.to(I32))

        any_dead = dead.any(dim=2)
        if bool(any_dead.any()):
            slab = _compact_pointers(slab, valid0 & ~dead, any_dead)

        row = p - out_base
        emits = served & (row >= 0) & (row < OR)
        r = torch.clamp(row, 0, OR - 1)
        out_stage[ar, r] = torch.where(emits[:, None], hop_stage, out_stage[ar, r])
        out_off[ar, r] = torch.where(emits[:, None], hop_off, out_off[ar, r])
        count[ar, r] = torch.where(emits, cnt, count[ar, r])
    return slab, out_stage, out_off, count


def _compact_pointers(slab: SlabState, live, rows) -> SlabState:
    """Move each ``rows`` entry's ``live`` pointers to the front, in order,
    and zero the slots behind them."""
    K, E, MP = live.shape
    tgt = torch.where(live, torch.cumsum(live.to(I32), dim=2) - 1, MP).long()

    def comp(field):
        extra = field.shape[3:]
        buf = torch.zeros((K, E, MP + 1) + extra, dtype=I32, device=field.device)
        idx = tgt.reshape(tgt.shape + (1,) * len(extra)).expand(field.shape)
        buf.scatter_(2, idx, field)
        m = rows.reshape(rows.shape + (1,) * (1 + len(extra)))
        return torch.where(m, buf[:, :, :MP], field)

    return slab._replace(
        pstage=comp(slab.pstage),
        poff=comp(slab.poff),
        pvlen=comp(slab.pvlen),
        pver=comp(slab.pver),
    )
