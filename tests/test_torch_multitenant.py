"""The port's multi-tenant bank against the JAX package's, after
``tests/test_multitenant.py`` and ``tests/test_tenant_isolation.py`` and at
their sizes.

The same numpy-seeded events go through the JAX package (jnp walks,
``CEP_WALK_KERNEL=0``) and through the port on the CPU, and are held equal
bit for bit:

* ``plan_bank``: columns (by structural key), trie, groups, tiers, prefix
  column paths and stats;
* ``build_matrix`` (with ``disabled=``), ``group_bools`` and
  ``bank_prefix_scan`` over several batches, carries included;
* ``TenantBankMatcher`` on the mixed bank (two stencil, two hybrid and one
  folded query; K=6, T=24, 3 batches, seed 31): outputs, every engine and
  carry leaf, the counters, tier and per-query counters, and each query
  equal to its own serial port matcher; and its lazy drain.

The quotas and quarantine are in ``tests/test_torch_tenant_isolation.py``.
"""

import numpy as np
import pytest
import torch

import torch_scenarios as ts
from kafkastreams_cep_tpu.compiler.multitenant import (
    plan_bank as j_plan_bank,
    predicate_key as j_key,
)
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.engine.predmatrix import (
    bank_prefix_scan as j_bank_prefix_scan,
    build_matrix as j_build_matrix,
    group_bools as j_group_bools,
    init_carries as j_init_carries,
)
from kafkastreams_cep_tpu.parallel.tenantbank import TenantBankMatcher as JTenant
from kafkastreams_cep_tpu_torch import BatchMatcher, EngineConfig
from kafkastreams_cep_tpu_torch.compiler.multitenant import (
    TenantQuota,
    plan_bank,
    predicate_key,
)
from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch
from kafkastreams_cep_tpu_torch.engine.predmatrix import (
    bank_prefix_scan,
    build_matrix,
    group_bools,
    init_carries,
    single_prefix_scan,
)
from kafkastreams_cep_tpu_torch.parallel import tenantbank as tenant_mod
from kafkastreams_cep_tpu_torch.parallel.tenantbank import TenantBankMatcher

# tests/test_multitenant.py's config: loss-free on every trace below.
CFG = dict(max_runs=8, slab_entries=24, slab_preds=4, dewey_depth=32, max_walk=8)
CAPACITY_COUNTERS = ("run_drops", "ver_overflows", "slab_full_drops", "slab_pred_drops",
                     "slab_trunc", "handle_overflows")


def ge(th):
    return lambda k, v, ts_, st, th=th: v["x"] >= th


def lt(th):
    return lambda k, v, ts_, st, th=th: v["x"] < th


def q_stencil(Q, a, b, c):
    return (Q().select("a").where(ge(a)).then()
            .select("b").where(lt(b)).then()
            .select("c").where(ge(c)).build())


def q_hybrid(Q, a, b, z):
    return (Q().select("a").where(ge(a)).then()
            .select("b").where(lt(b)).then()
            .select("z").skip_till_next_match().where(ge(z)).build())


def q_folded(Q):
    return (Q().select("a").where(ge(8))
            .fold("acc", lambda k, v, curr: curr + v["x"], init=0)
            .then().select("b").skip_till_next_match()
            .where(lambda k, v, ts_, st: v["x"] > st.get("acc") % 4).build())


def mixed(Q):
    """``tests/test_multitenant.py: MIXED``."""
    return [q_stencil(Q, 8, 3, 7), q_hybrid(Q, 8, 3, 9), q_hybrid(Q, 9, 1, 7),
            q_stencil(Q, 9, 2, 8), q_folded(Q)]


def trace(K, T, seed):
    """``tests/test_multitenant.py: trace`` as a port batch."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 10, size=(K, T)).astype(np.int32)
    base = torch.arange(T, dtype=torch.int32)[None, :].expand(K, T)
    return EventBatch(key=torch.arange(K, dtype=torch.int32)[:, None].expand(K, T),
                      value={"x": torch.as_tensor(xs)}, ts=base, off=base,
                      valid=torch.ones((K, T), dtype=torch.bool))


@pytest.fixture
def jnp_path(monkeypatch):
    from kafkastreams_cep_tpu.utils import tracecache

    monkeypatch.setenv("CEP_WALK_KERNEL", "0")
    monkeypatch.delenv("CEP_SCAN_KERNEL", raising=False)
    tracecache.clear()


def assert_tenant_states_equal(js, tst, msg):
    assert len(js.engine) == len(tst.engine) and len(js.carry) == len(tst.carry)
    for i, (a, b) in enumerate(zip(js.engine, tst.engine)):
        ts.assert_states_equal(a, b, f"{msg} engine {i}")
    for i, (a, b) in enumerate(zip(js.carry, tst.carry)):
        ts.assert_states_equal(a, b, f"{msg} carry {i}")


def assert_out_equal(jout, tout, msg, rows=None):
    for f in tout._fields:
        a, b = np.asarray(getattr(jout, f)), getattr(tout, f).numpy()
        if rows is not None:
            a, b = a[rows], b[rows]
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {f}")


# -- the plan ------------------------------------------------------------------

def test_plan_bank_equals_jax():
    eq = lambda th: lambda k, v, ts_, st, th=th: v["x"] == th

    def q_custom(Q, pa, pb, z):
        return (Q().select("a").where(pa).then().select("b").where(pb).then()
                .select("z").skip_till_next_match().where(ge(z)).build())

    banks = {
        "mixed": mixed,
        "pairs": lambda Q: [q_hybrid(Q, 8, 3, 9), q_hybrid(Q, 8, 3, 8),
                            q_hybrid(Q, 9, 1, 9), q_hybrid(Q, 9, 1, 8)],
        "none": lambda Q: [q_custom(Q, ge(8), lt(1), 9), q_custom(Q, eq(8), lt(3), 9)],
    }
    for name, mk in banks.items():
        for conf in (CFG, dict(CFG, lazy_extraction=True, handle_ring=16)):
            jp = j_plan_bank(mk(ts.JQuery), JConfig(**conf))
            tp = plan_bank(mk(ts.TQuery), EngineConfig(**conf))
            assert tp.stats == jp.stats, name
            assert tp.trie == jp.trie and tp.groups == jp.groups, name
            assert [(c.owner, c.shared, predicate_key(c.pred)) for c in tp.columns] == \
                [(c.owner, c.shared, j_key(c.pred)) for c in jp.columns], name
            assert [(q.prefix_cols, q.plan.describe()) for q in tp.queries] == \
                [(q.prefix_cols, q.plan.describe()) for q in jp.queries], name
    quotas = [None, TenantQuota(match_rate_budget=1.0), None, None, None]
    tp = plan_bank(mixed(ts.TQuery), EngineConfig(**CFG), quotas=quotas)
    assert tp.stats["quotas_declared"] == 1 and tp.queries[1].quota.burst == 2.0
    with pytest.raises(ValueError, match="one entry per pattern"):
        plan_bank(mixed(ts.TQuery), EngineConfig(**CFG), quotas=quotas[:2])
    with pytest.raises(ValueError):
        TenantQuota(handle_ring_share=0.0)


def test_predmatrix_equals_jax():
    """The matrix (with one column disabled), the group gathers and the
    prefix recurrence over three batches, carries crossing them."""
    jp = j_plan_bank(mixed(ts.JQuery), JConfig(**CFG))
    tp = plan_bank(mixed(ts.TQuery), EngineConfig(**CFG))
    disabled = (len(tp.columns) - 1,)
    jm = j_build_matrix(jp.columns, [q.tables for q in jp.queries], disabled=disabled)
    tm = build_matrix(tp.columns, [q.tables for q in tp.queries], disabled=disabled)
    K, T, p = 6, 24, 2
    sigs = np.asarray([q.prefix_cols for q in tp.queries if len(q.prefix_cols) == p])
    assert len(sigs) >= 2
    jc, tc = j_init_carries(len(sigs), K, p), init_carries(len(sigs), K, p, "cpu")
    jscan, tscan = j_bank_prefix_scan(p), bank_prefix_scan(p)
    one, one_c = single_prefix_scan(p), init_carries(1, K, p, "cpu")
    fires = 0
    for b in range(3):
        ev = trace(K, T, 31 + b)
        jev = ts.to_jax(ev)
        jmat, tmat = jm(jev), tm(ev)
        np.testing.assert_array_equal(np.asarray(jmat), tmat.numpy())
        assert not tmat[..., disabled[0]].any()
        jb, tb = j_group_bools(jmat, sigs), group_bools(tmat, sigs)
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
        jc, jpromo = jscan(jc, jb, jev)
        tc, tpromo = tscan(tc, tb, ev)
        ts.assert_states_equal(jc, tc, f"carry {b}")
        ts.assert_states_equal(jpromo, tpromo, f"promo {b}")
        # One query alone through the single-query recurrence: its row.
        one_c, promo1 = one(type(one_c)(*(x[0] for x in one_c)), tb[0], ev.off, ev.ts,
                            ev.valid)
        for a, c in zip(promo1, tpromo):
            assert torch.equal(a, c[0])
        one_c = type(one_c)(*(x[None] for x in one_c))
        fires += int(tpromo.fire.sum())
    assert fires > 0


# -- the bank ------------------------------------------------------------------

def test_tenant_bank_equals_jax_and_serial(jnp_path, monkeypatch):
    """MIXED at K=6, T=24, 3 batches from seed 31, with a sweep after the
    second: every output, state leaf and counter equal JAX's bank, each
    query equal to its own serial matcher, one host read per scan."""
    reads = []
    monkeypatch.setattr(tenant_mod, "host_read",
                        lambda x: reads.append(1) or x.cpu().numpy())
    K, T = 6, 24
    jb = JTenant(mixed(ts.JQuery), K, JConfig(**CFG))
    tb = TenantBankMatcher(mixed(ts.TQuery), K, EngineConfig(**CFG), device="cpu")
    assert [tb.tier_of(q) for q in range(5)] == [jb.tier_of(q) for q in range(5)]
    assert {"stencil", "hybrid", "nfa"} <= {tb.tier_of(q) for q in range(5)}
    serial = [BatchMatcher(p, K, EngineConfig(**CFG), device="cpu") for p in mixed(ts.TQuery)]
    js, tst = jb.init_state(), tb.init_state()
    ss = [m.init_state() for m in serial]
    assert_tenant_states_equal(js, tst, "init")
    for b in range(3):
        ev = trace(K, T, 31 + b)
        js, jo = jb.scan(js, ts.to_jax(ev))
        tst, to = tb.scan(tst, ev)
        assert_tenant_states_equal(js, tst, f"batch {b}")
        assert_out_equal(jo, to, f"batch {b}")
        for q, m in enumerate(serial):
            ss[q], o1 = m.scan(ss[q], ev)
            for f in o1._fields:
                np.testing.assert_array_equal(getattr(to, f)[q].numpy(),
                                              getattr(o1, f).numpy(),
                                              err_msg=f"batch {b} q{q} {f}")
        if b == 1:
            js, tst = jb.sweep(js), tb.sweep(tst)
            assert_tenant_states_equal(js, tst, "sweep")
    assert len(reads) == 3
    bc = tb.counters(tst)
    assert bc == jb.counters(js)
    assert all(bc[n] == 0 for n in CAPACITY_COUNTERS), bc
    drop = lambda d: {k: v for k, v in d.items() if k != "slab_missing"}
    summed = {k: sum(m.counters(s)[k] for m, s in zip(serial, ss)) for k in bc}
    assert drop(bc) == drop(summed)
    assert tb.hot_counters(tst) == jb.hot_counters(js)
    assert tb.walk_counters(tst) == jb.walk_counters(js)
    tc = tb.tier_counters(tst)
    assert tc == jb.tier_counters(js) and tc["tier_promotions"] > 0
    assert tb.per_query_counters(tst) == jb.per_query_counters(js)
    tsnap, jsnap = tb.metrics_snapshot(tst), jb.metrics_snapshot(js)
    assert tsnap == {k: v for k, v in jsnap.items() if k in tsnap}


def test_tenant_bank_lazy_drain_equals_jax(jnp_path):
    conf = dict(CFG, lazy_extraction=True, handle_ring=16)
    K, T = 4, 12
    # A stencil query (the empty drain rows), a hybrid group and an nfa group.
    pick = lambda Q: [mixed(Q)[i] for i in (0, 1, 4)]
    jb = JTenant(pick(ts.JQuery), K, JConfig(**conf))
    tb = TenantBankMatcher(pick(ts.TQuery), K, EngineConfig(**conf), device="cpu")
    js, tst = jb.init_state(), tb.init_state()
    for b in range(2):
        ev = trace(K, T, 61 + b)
        js, jo = jb.scan(js, ts.to_jax(ev))
        tst, to = tb.scan(tst, ev)
        assert_out_equal(jo, to, f"batch {b}")
        js, jd = jb.drain(js)
        tst, td = tb.drain(tst)
        assert_out_equal(jd, td, f"drain {b}")
        assert_tenant_states_equal(js, tst, f"drain {b}")
