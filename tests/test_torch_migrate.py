"""The port's live-state surgery (``runtime/migrate.py``) against the JAX
package's, after ``tests/test_migrate.py`` and ``tests/test_shard_fault.py``.

* widening each dimension of ``tests/test_migrate.py``'s ``WIDENINGS`` (the
  combined one under ``-m slow``): the port's ``widen_state`` equals the
  JAX one leaf for leaf, and is a pure embedding on the port's engine
  (prefix narrow, widen, suffix wide == suffix narrow, and the widened
  final narrow state equals the final wide state through
  ``canonical_state``); the two-tier and handle-ring widenings too;
* a JAX-widened state stepped by the port, and a port-widened state stepped
  by the JAX package, agree;
* ``check_widens``' refusals; ``migrate_processor`` keeps counters, the
  lane map and offsets, equal to the JAX processor's migration; a pending
  pipelined batch is refused; ``replan_processor`` leaves the stream as it
  was;
* ``plan_rebalance`` on ``tests/test_shard_fault.py:143-165``'s cases;
  ``repartition_state`` (eager, two-tier, a live handle ring) and
  ``move_lanes`` (eager and tiered) on one device, as ``:60-130`` and
  ``:250-281`` hold them;
* a tenant bank's state (a plain tuple of group engines) widens as the JAX
  package widens it, and the JAX-widened state steps in the port;
* ``mesh=`` migrates and moves lanes onto a mesh of CPU placements (the
  mesh's own suites: ``tests/test_torch_sharding.py``,
  ``test_torch_shard_fault.py``).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.parallel.batch import BatchMatcher as JBatch
from kafkastreams_cep_tpu.runtime import CEPProcessor as JProcessor
from kafkastreams_cep_tpu.runtime import Record as JRecord
from kafkastreams_cep_tpu.runtime import migrate as jmigrate
from kafkastreams_cep_tpu_torch import BatchMatcher, CEPProcessor, EngineConfig, Record
from kafkastreams_cep_tpu_torch.convert import state_arrays, to_numpy, to_torch
from kafkastreams_cep_tpu_torch.engine.sizing import capacity_counters
from kafkastreams_cep_tpu_torch.parallel import key_mesh
from kafkastreams_cep_tpu_torch.runtime import (
    migrate_processor, move_lanes, plan_rebalance, repartition_state, widen_state,
)
from kafkastreams_cep_tpu_torch.runtime.migrate import (
    canonical_state, check_widens, replan_processor, tree_map,
)

from test_migrate import NARROW as J_NARROW
from test_migrate import WIDENINGS, stock_events

NARROW = EngineConfig(**dataclasses.asdict(J_NARROW))
K, T = 8, 12


def assert_trees_equal(a, b, msg=""):
    """Every leaf of two host trees (either package's classes) equal."""
    x, y = state_arrays(a), state_arrays(b)
    assert x.keys() == y.keys(), msg
    for name in x:
        assert x[name].dtype == y[name].dtype, f"{msg} {name} dtype"
        np.testing.assert_array_equal(x[name], y[name], err_msg=f"{msg} {name}")


def assert_canonical_equal(a, b, msg=""):
    assert_trees_equal(canonical_state(a), canonical_state(b), msg)


def events(seed, t0=0, k=K, t=T):
    return ts.from_jax(stock_events(k, t, seed, t0=t0))


@functools.lru_cache(maxsize=None)
def narrow_run(seed, cfg=NARROW):
    """The port's narrow engine over a prefix and a suffix: ``(mid, final,
    final output)``."""
    m = BatchMatcher(ts.stock(ts.TQuery), K, cfg, device="cpu")
    mid, _ = m.scan(m.init_state(), events(seed))
    st, out = m.scan(mid, events(seed + 100, t0=T))
    assert not any(capacity_counters(m.counters(st)).values()), (
        "precondition: the narrow run must be loss-free for bit-exactness")
    return mid, st, out


@functools.lru_cache(maxsize=None)
def jax_mid(seed):
    jb = JBatch(ts.stock(ts.JQuery), K, J_NARROW)
    mid, _ = jb.scan(jb.init_state(), stock_events(K, T, seed))
    return jax.tree_util.tree_map(np.asarray, mid)


@pytest.mark.parametrize("dim,seed", [
    (d, 3) if d != "combined" else pytest.param(d, 3, marks=pytest.mark.slow)
    for d in sorted(WIDENINGS)
] + [pytest.param("combined", 17, marks=pytest.mark.slow)])
def test_widening_is_pure_embedding(dim, seed):
    wide_cfg = dataclasses.replace(NARROW, **WIDENINGS[dim])
    mid, st_n, out_n = narrow_run(seed)
    jmid = jax_mid(seed)
    ts.assert_states_equal(jmid, mid, "narrow prefix")
    widened = widen_state(mid, NARROW, wide_cfg)
    assert_trees_equal(widened, jmigrate.widen_state(
        jmid, J_NARROW, dataclasses.replace(J_NARROW, **WIDENINGS[dim])), f"widen[{dim}]")
    wide = BatchMatcher(ts.stock(ts.TQuery), K, wide_cfg, device="cpu")
    st_w, out_w = wide.scan(to_torch(widened), events(seed + 100, t0=T))
    R, W = NARROW.max_runs, NARROW.max_walk
    assert torch.equal(out_n.count, out_w.count[..., :R])
    assert not out_w.count[..., R:].any()
    for f in ("stage", "off"):
        assert torch.equal(getattr(out_n, f), getattr(out_w, f)[..., :R, :W]), f
    assert_canonical_equal(widen_state(st_n, NARROW, wide_cfg), st_w, f"widen[{dim}]")


def test_states_widened_by_one_package_step_in_the_other():
    """The combined widening of the JAX prefix state, stepped by the port,
    equals the port's own; the port's widening stepped by the JAX package
    equals the port's wide run too."""
    wide_cfg = dataclasses.replace(NARROW, **WIDENINGS["combined"])
    j_wide_cfg = dataclasses.replace(J_NARROW, **WIDENINGS["combined"])
    mid, _, _ = narrow_run(3)
    suffix = events(103, t0=T)
    wide = BatchMatcher(ts.stock(ts.TQuery), K, wide_cfg, device="cpu")
    st_t, out_t = wide.scan(to_torch(jmigrate.widen_state(jax_mid(3), J_NARROW, j_wide_cfg)),
                            suffix)
    st_p, out_p = wide.scan(to_torch(widen_state(mid, NARROW, wide_cfg)), suffix)
    assert_trees_equal(st_t, st_p, "JAX-widened state stepped by the port")
    jb = JBatch(ts.stock(ts.JQuery), K, j_wide_cfg)
    from kafkastreams_cep_tpu.engine.matcher import EngineState as JState
    from kafkastreams_cep_tpu.ops.slab import SlabState as JSlab

    st_j, out_j = jb.scan(to_numpy(widen_state(mid, NARROW, wide_cfg),
                                   {"EngineState": JState, "SlabState": JSlab}),
                          ts.to_jax(suffix))
    assert_canonical_equal(st_p, jax.tree_util.tree_map(np.asarray, st_j),
                           "port-widened state stepped by JAX")
    for a, b in zip(out_j, out_p):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_two_tier_slab_widens_with_hot_window_intact():
    narrow = dataclasses.replace(NARROW, slab_hot_entries=8)
    wide_cfg = dataclasses.replace(narrow, slab_entries=64)
    mid, st_n, out_n = narrow_run(11, narrow)
    b = BatchMatcher(ts.stock(ts.TQuery), K, wide_cfg, device="cpu")
    st_w, out_w = b.scan(to_torch(widen_state(mid, narrow, wide_cfg)), events(111, t0=T))
    assert torch.equal(out_n.count, out_w.count)
    assert_canonical_equal(widen_state(st_n, narrow, wide_cfg), st_w, "two-tier")


def test_handle_ring_widens_with_pending_handles():
    lazy = dataclasses.replace(NARROW, lazy_extraction=True, handle_ring=64)
    narrow = BatchMatcher(ts.stock(ts.TQuery), K, lazy, device="cpu")
    mid, _ = narrow.scan(narrow.init_state(), events(23))  # not drained
    assert int(mid.hr_count.sum()) > 0
    st_n, _ = narrow.scan(mid, events(123, t0=T))
    st_n, d_n = narrow.drain(st_n)
    assert not any(capacity_counters(narrow.counters(st_n)).values())
    for name, w in (("ring", dict(handle_ring=96)),
                    ("combined", dict(handle_ring=96, **WIDENINGS["combined"]))):
        wide_cfg = dataclasses.replace(lazy, **w)
        wide = BatchMatcher(ts.stock(ts.TQuery), K, wide_cfg, device="cpu")
        st_w, _ = wide.scan(to_torch(widen_state(mid, lazy, wide_cfg)), events(123, t0=T))
        st_w, d_w = wide.drain(st_w)
        HB, W0 = lazy.handle_ring, lazy.max_walk
        for f in d_n._fields:
            a, b = getattr(d_n, f), getattr(d_w, f)
            if b.dim() == 3:
                assert (b[:, :HB, W0:] == -1).all(), f"{name}: drain.{f}"
                b = b[:, :HB, :W0]
            else:
                b = b[:, :HB]
            assert torch.equal(a, b), f"{name}: drain.{f}"
        assert narrow.counters(st_n) == wide.counters(st_w), name
        assert_canonical_equal(widen_state(st_n, lazy, wide_cfg), st_w, name)


def test_check_widens_refusals():
    with pytest.raises(ValueError, match="shrink"):
        check_widens(NARROW, dataclasses.replace(NARROW, max_runs=8))
    with pytest.raises(ValueError, match="semantics"):
        check_widens(NARROW, dataclasses.replace(NARROW, max_runs=32, enforce_windows=True))
    for flag in (dict(sequential_slab=True), dict(walker_budget=2)):
        with pytest.raises(ValueError, match="semantics"):
            check_widens(NARROW, dataclasses.replace(NARROW, max_runs=32, **flag))
    with pytest.raises(ValueError, match="equals"):
        check_widens(NARROW, NARROW)


TINY = dict(max_runs=4, slab_entries=16, slab_preds=2, dewey_depth=8, max_walk=8)
WIDE = dict(max_runs=32, slab_entries=64, slab_preds=8, dewey_depth=16, max_walk=16)
STORM = [ts.A, ts.B] + [ts.C, ts.D] * 4


def test_migrate_processor_preserves_history_and_counters():
    """A processor that already dropped keeps its counters (a migration
    never forgives loss), its lane map, offsets and events, and matches on
    at the new width exactly as the JAX processor's migration does."""
    streams = []
    for Proc, Rec, Config, Q, mig, kw in (
        (CEPProcessor, Record, EngineConfig, ts.TQuery, migrate_processor,
         dict(device="cpu")),
        (JProcessor, JRecord, JConfig, ts.JQuery, jmigrate.migrate_processor, {}),
    ):
        proc = Proc(ts.skip_till_any(Q), 2, Config(**TINY), gc_interval=0, **kw)
        for i, v in enumerate(STORM):
            proc.process([Rec("k", v, 1000 + i, offset=i)])
        before = proc.counters()
        assert before["run_drops"] > 0
        proc2 = mig(ts.skip_till_any(Q), proc, Config(**WIDE))
        assert proc2.counters() == before
        assert proc2._lane_of == proc._lane_of
        assert proc2._next_offset.tolist() == proc._next_offset.tolist()
        assert proc2.metrics is proc.metrics
        out = []
        n = len(STORM)
        for i, v in enumerate([ts.A, ts.B, ts.C, ts.D]):
            out += proc2.process([Rec("k", v, 5000 + i, offset=n + i)])
        assert out and proc2.counters()["run_drops"] == before["run_drops"]
        streams.append((ts.canon_matches(out), proc2.counters()))
        if Proc is CEPProcessor:
            tproc = proc2
    assert streams[0] == streams[1]
    assert tproc.batch.matcher.config == EngineConfig(**WIDE)


def test_migrate_refuses_pending_pipelined_batch():
    cfg = EngineConfig(max_runs=16, slab_entries=48, slab_preds=6, dewey_depth=10, max_walk=10)
    proc = CEPProcessor(ts.strict3(ts.TQuery), 1, cfg, pipeline=True, gc_interval=0,
                        device="cpu")
    proc.process([Record("k", ts.A, 1, offset=0)])
    wide = dataclasses.replace(cfg, max_runs=64)
    with pytest.raises(ValueError, match="flush"):
        migrate_processor(ts.strict3(ts.TQuery), proc, wide)
    proc.flush()
    flat = migrate_processor(ts.strict3(ts.TQuery), proc, wide)
    meshed = migrate_processor(ts.strict3(ts.TQuery), proc, wide, mesh=key_mesh(["cpu"]))
    assert meshed.mesh.size == 1 and meshed.batch.matcher.config == wide
    assert_trees_equal(canonical_state(flat.host_state()), canonical_state(meshed.host_state()),
                       "migrated onto a mesh")
    rest = [Record("k", ts.B, 2, offset=1), Record("k", ts.C, 3, offset=2)]
    assert canon(flat.process(rest)) == canon(meshed.process(rest))


TIERED = dict(max_runs=32, slab_entries=96, slab_preds=12, dewey_depth=20, max_walk=12,
              tiering=True, stage_attribution=True)


def letter_stream(keys, n, seed, start=0):
    rng = np.random.default_rng(seed)
    offs = {k: start for k in keys}
    out = []
    for i in range(n):
        k = keys[int(rng.integers(len(keys)))]
        out.append(Record(k, int(rng.integers(0, 5)), 1000 + start * 8 + i, offset=offs[k]))
        offs[k] += 1
    return out


def canon(matches):
    return sorted((k, tuple(sorted((stage, tuple(e.offset for e in evs))
                                   for stage, evs in seq.as_map().items())))
                  for k, seq in matches)


def test_replan_processor_leaves_the_stream_as_it_was():
    """A tiered processor re-planned mid-stream from its own measured
    profile emits the stream of the one left alone; the state moves
    verbatim and the metrics carry over."""
    keys = ["k0", "k1", "k2", "k3"]
    head, tail = letter_stream(keys, 32, 5), letter_stream(keys, 32, 6, start=8)
    a = CEPProcessor(ts.skip_till_any(ts.TQuery), 4, EngineConfig(**TIERED), gc_interval=0,
                     device="cpu")
    b = CEPProcessor(ts.skip_till_any(ts.TQuery), 4, EngineConfig(**TIERED), gc_interval=0,
                     device="cpu")
    ma, mb = a.process(head), b.process(head)
    profile = b.metrics_snapshot()["per_stage"]
    b2 = replan_processor(ts.skip_till_any(ts.TQuery), b, profile)
    assert_trees_equal(b2.state, b.state, "verbatim")
    assert b2.metrics is b.metrics
    ma += a.process(tail)
    mb += b2.process(tail)
    assert canon(ma) == canon(mb) and ma
    assert a.counters() == b2.counters()
    with pytest.raises(ValueError, match="tiered"):
        replan_processor(ts.skip_till_any(ts.TQuery),
                         CEPProcessor(ts.skip_till_any(ts.TQuery), 4, NARROW, device="cpu"),
                         profile)


# -- lanes ---------------------------------------------------------------------

def test_plan_rebalance_cases():
    perm = plan_rebalance([50, 50, 1, 1], 2)
    assert perm is not None and sorted(perm.tolist()) == [0, 1, 2, 3]
    assert np.array([50, 50, 1, 1])[perm].reshape(2, 2).sum(axis=1).max() == 51
    assert plan_rebalance([1, 1, 1, 1], 2) is None
    assert plan_rebalance([100, 1, 1, 1], 2) is None
    assert plan_rebalance([5, 4, 3], 2) is None
    assert plan_rebalance([5, 4], 1) is None
    loads = [9, 9, 2, 2, 1, 1, 0, 0]
    assert np.array_equal(plan_rebalance(loads, 4), jmigrate.plan_rebalance(loads, 4))
    rng = np.random.default_rng(3)
    for _ in range(5):
        loads = rng.integers(0, 100, size=16)
        got, want = plan_rebalance(loads, 4), jmigrate.plan_rebalance(loads, 4)
        assert (got is None and want is None) or np.array_equal(got, want)


@pytest.mark.parametrize("cfg,drain", [
    (NARROW, False),
    (dataclasses.replace(NARROW, slab_hot_entries=8), False),
    (dataclasses.replace(NARROW, lazy_extraction=True, handle_ring=64), True),
], ids=["eager", "two_tier", "live_ring"])
def test_repartition_parity(cfg, drain):
    """Continuing a permuted state on permuted events equals the permuted
    continuation of the original; the port's permutation equals JAX's."""
    perm = np.random.default_rng(K).permutation(K)
    m = BatchMatcher(ts.stock(ts.TQuery), K, cfg, device="cpu")
    mid, _ = m.scan(m.init_state(), events(31, k=K, t=10))
    suffix = events(131, t0=10, k=K, t=10)
    st_a, out_a = m.scan(mid, suffix)
    moved = repartition_state(mid, perm)
    assert_trees_equal(moved, jmigrate.repartition_state(to_numpy(mid), perm), "perm")
    st_b, out_b = m.scan(to_torch(moved), to_torch(repartition_state(suffix, perm)))
    for f in ("count", "stage", "off"):
        assert torch.equal(getattr(out_a, f)[perm], getattr(out_b, f)), f
    assert_canonical_equal(repartition_state(st_a, perm), st_b, "repart")
    assert m.counters(st_a) == m.counters(st_b)
    if drain:
        st_a, d_a = m.drain(st_a)
        st_b, d_b = m.drain(st_b)
        for f in d_a._fields:
            assert torch.equal(getattr(d_a, f)[perm], getattr(d_b, f)), f
        assert_canonical_equal(repartition_state(st_a, perm), st_b, "drained")


def test_repartition_rejects_non_permutations():
    st = BatchMatcher(ts.stock(ts.TQuery), 4, NARROW, device="cpu").init_state()
    with pytest.raises(ValueError, match="permutation"):
        repartition_state(st, [0, 1, 1, 2])
    with pytest.raises(ValueError, match="lane axis"):
        repartition_state(st, [0, 1])


@pytest.mark.parametrize("tiered", [False, True])
def test_move_lanes_processor_parity(tiered):
    """A moved processor matches the unmoved one: same emissions, the same
    canonical state with its rows permuted, the same counters."""
    cfg = EngineConfig(max_runs=64, slab_entries=96, slab_preds=12, dewey_depth=24,
                       max_walk=12, tiering=tiered)
    keys = ["k0", "k1", "k2", "k3"]
    a = CEPProcessor(ts.skip_till_any(ts.TQuery), 4, cfg, gc_interval=0, device="cpu")
    b = CEPProcessor(ts.skip_till_any(ts.TQuery), 4, cfg, gc_interval=0, device="cpu")
    head, tail = letter_stream(keys, 24, 5), letter_stream(keys, 24, 6, start=6)
    ma, mb = list(a.process(head)), list(b.process(head))
    if tiered:
        assert getattr(a.state, "carry", None) is not None
    perm = np.array([2, 0, 3, 1])
    b = move_lanes(ts.skip_till_any(ts.TQuery), b, perm)
    assert b._lane_of == {k: int(np.argsort(perm)[a._lane_of[k]]) for k in keys}
    ma += a.process(tail) + a.flush()
    mb += b.process(tail) + b.flush()
    assert canon(ma) == canon(mb) and ma
    assert_trees_equal(repartition_state(canonical_state(a.state), perm),
                       canonical_state(b.state), "move_lanes")
    assert a.counters() == b.counters() and not any(b.counters().values())
    mesh = key_mesh(["cpu"] * 2)
    if tiered:
        with pytest.raises(ValueError, match="single-chip"):
            move_lanes(ts.skip_till_any(ts.TQuery), b, perm, mesh=mesh)
        return
    # Back to a's lane order, onto two shards: a's canonical state and stream.
    c = move_lanes(ts.skip_till_any(ts.TQuery), b, np.argsort(perm), mesh=mesh)
    assert c.mesh is mesh and c._lane_of == a._lane_of
    assert_trees_equal(canonical_state(a.state), canonical_state(c.host_state()),
                       "move_lanes onto a mesh")
    more = letter_stream(keys, 16, 7, start=12)
    assert canon(a.process(more) + a.flush()) == canon(c.process(more) + c.flush())


def leaves(tree):
    """Every array leaf of a state tree (plain tuples too), in order."""
    out = []
    tree_map(lambda x: out.append(np.asarray(x.numpy() if torch.is_tensor(x) else x)), tree)
    return out


def test_tenant_bank_state_widens_in_both_packages(monkeypatch):
    """A tenant bank's state (a plain tuple of group engines and the prefix
    carries): the port widens it as the JAX package does, the JAX-widened
    state steps in the port, and the embedding holds one batch on."""
    from kafkastreams_cep_tpu.utils import tracecache
    from kafkastreams_cep_tpu.parallel.tenantbank import TenantBankMatcher as JTenant
    from kafkastreams_cep_tpu_torch.parallel.tenantbank import TenantBankMatcher

    from test_torch_multitenant import CFG as BANK, mixed, trace

    monkeypatch.setenv("CEP_WALK_KERNEL", "0")
    tracecache.clear()
    k, t = 6, 24
    grow = dict(max_runs=16, slab_entries=32, slab_preds=8, max_walk=12)
    narrow, wide = EngineConfig(**BANK), EngineConfig(**dict(BANK, **grow))
    tb = TenantBankMatcher(mixed(ts.TQuery), k, narrow, device="cpu")
    jb = JTenant(mixed(ts.JQuery), k, JConfig(**BANK))
    ev, ev2 = trace(k, t, 31), trace(k, t, 32)
    mid, _ = tb.scan(tb.init_state(), ev)
    jmid, _ = jb.scan(jb.init_state(), ts.to_jax(ev))
    widened = widen_state(mid, narrow, wide)
    j_widened = jmigrate.widen_state(jmid, JConfig(**BANK), JConfig(**dict(BANK, **grow)))
    for a, b in zip(leaves(widened), leaves(j_widened), strict=True):
        np.testing.assert_array_equal(a, b)
    end, _ = tb.scan(mid, ev2)
    assert not any(capacity_counters(tb.counters(end)).values())
    wb = TenantBankMatcher(mixed(ts.TQuery), k, wide, device="cpu")
    w_end, _ = wb.scan(to_torch(j_widened), ev2)
    for a, b in zip(leaves(canonical_state(widen_state(end, narrow, wide))),
                    leaves(canonical_state(w_end)), strict=True):
        np.testing.assert_array_equal(a, b)
