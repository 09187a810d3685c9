"""The port's stage attribution (``EngineConfig.stage_attribution``) against
the JAX package's, after ``tests/test_stage_attribution.py``.

Off, every attribution tensor has zero size and the reports are empty.  On,
``stage_counts [K, 4, S]`` and ``stage_hops [K, S]`` equal the JAX engine's
after every step (two-tier slab included), ``stage_counters()`` and the
measured ``conjunct_counters()`` equal the JAX reports, every walk hop is
attributed once (``sum(stage_hops) == walk + extract + drain hops``), the
drain's hops included, and attribution never changes what matches.
"""

import numpy as np
import pytest

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.parallel import BatchMatcher as JBatch
from kafkastreams_cep_tpu.pattern.predicate import and_ as j_and
from kafkastreams_cep_tpu.pattern.predicate import hint as j_hint
from kafkastreams_cep_tpu_torch import BatchMatcher, EngineConfig
from kafkastreams_cep_tpu_torch.pattern.predicate import and_ as t_and
from kafkastreams_cep_tpu_torch.pattern.predicate import hint as t_hint

from test_torch_engine import run_both

ATTR = dict(max_runs=8, slab_entries=16, slab_hot_entries=8, slab_preds=4,
            dewey_depth=8, max_walk=8, stage_attribution=True)


def conserved(batch, state):
    """Every walk hop is attributed to exactly one stage."""
    return int(state.slab.stage_hops.sum()) == sum(batch.walk_counters(state).values())


def test_disabled_attribution_is_zero_size():
    m = BatchMatcher(ts.stock(ts.TQuery), 4, EngineConfig(
        **dict(ATTR, stage_attribution=False)), device="cpu")
    st = m.init_state()
    assert tuple(st.stage_counts.shape) == (4, 4, 0)
    assert tuple(st.slab.stage_hops.shape) == (4, 0)
    assert m.stage_counters(st) == {} and m.matcher.stage_counters(st) == {}
    assert m.conjunct_counters() == {}


@pytest.mark.parametrize("name", ["stock", "skip_any", "kleene"])
def test_stage_tallies_equal_jax_per_step(name):
    tb, tst, jb, js = run_both(name, K=4, T=24, seed=5, **ATTR)
    assert int(tst.stage_counts.sum()) > 0 and int(tst.slab.stage_hops.sum()) > 0
    assert tb.stage_counters(tst) == jb.stage_counters(js)
    assert tb.matcher.stage_counters(tst) == jb.matcher.stage_counters(js)
    assert conserved(tb, tst)


def test_attribution_never_changes_matching():
    K, T = 6, 24
    events = ts.events("stock", np.random.default_rng(5), K, T)
    off = BatchMatcher(ts.stock(ts.TQuery), K, EngineConfig(
        **dict(ATTR, stage_attribution=False)), device="cpu")
    on = BatchMatcher(ts.stock(ts.TQuery), K, EngineConfig(**ATTR), device="cpu")
    st0, out0 = off.scan(off.init_state(), events)
    st1, out1 = on.scan(on.init_state(), events)
    for a, b in zip(out0, out1):
        assert a.equal(b)
    assert off.counters(st0) == on.counters(st1)
    assert off.hot_counters(st0) == on.hot_counters(st1)
    report = on.stage_counters(st1)
    ev = st1.stage_counts[:, 0]
    assert all((st1.stage_counts[:, i] <= ev).all() for i in (1, 2, 3))
    assert all("selectivity" in row for row in report.values())
    assert conserved(on, st1)


def test_lazy_drain_hops_are_attributed():
    cfg = dict(ATTR, lazy_extraction=True, handle_ring=64, slab_entries=32)
    tb, tst, jb, js = run_both("stock", K=4, T=24, seed=11, **cfg)
    t_state, _ = tb.drain(tst)
    j_state, _ = jb.drain(js)
    ts.assert_states_equal(j_state, t_state, "after drain")
    assert tb.walk_counters(t_state)["drain_hops"] > 0
    assert conserved(tb, t_state)


def _pricey(k, v, ts_, st):
    return v["price"] * 7 % 5 != 2


def _cheap(k, v, ts_, st):
    return v["price"] > 110


def conjunct_pattern(Q, and_, hint):
    """``tests/test_stage_attribution.py``'s two-conjunct stock query."""
    return (
        Q().select("rise")
        .where(and_(hint(_pricey, cost=50.0), hint(_cheap, cost=1.0)))
        .then().select("dip").skip_till_next_match()
        .where(lambda k, v, ts_, st: v["price"] < 100)
        .build()
    )


def test_conjunct_counters_equal_jax():
    K, T = 4, 24
    tb = BatchMatcher(conjunct_pattern(ts.TQuery, t_and, t_hint), K,
                      EngineConfig(**ATTR), device="cpu")
    jb = JBatch(conjunct_pattern(ts.JQuery, j_and, j_hint), K, JConfig(**ATTR))
    assert tb.conjunct_counters() == jb.conjunct_counters()  # before any batch
    tst, jst = tb.init_state(), jb.init_state()
    prices = []
    for seed in (1, 2):
        ev = ts.events("stock", np.random.default_rng(seed), K, T)
        prices.append(ev.value["price"].numpy())
        tst, _ = tb.scan(tst, ev)
        jst, _ = jb.scan(jst, ts.to_jax(ev))
    ts.assert_states_equal(jst, tst)
    report = tb.stage_counters(tst)
    assert report == jb.stage_counters(jst)
    rows = report["rise"]["conjuncts"]
    allp = np.concatenate(prices, axis=None).astype(np.int64)
    by = {("pricey" if "_pricey" in key else "cheap"): row for key, row in rows.items()}
    assert all(row["evals"] == allp.size for row in by.values())
    assert by["cheap"]["accepts"] == int((allp > 110).sum())
    assert by["pricey"]["accepts"] == int((allp * 7 % 5 != 2).sum())
    assert len(report["dip"]["conjuncts"]) == 1
