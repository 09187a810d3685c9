"""``EngineConfig(sequential_slab=True)``: the port's per-op slab step
against the JAX package's, every counter exact (``slab_missing`` too).

* the branching-heavy trace of ``tests/test_slab_batched.py:340`` through
  ``MatcherSession``: the port's sequential matcher equals the JAX one on
  every match and counter, and equals the port's batched path on the
  matches and on every counter but ``slab_missing`` (the per-op order
  reaches more lookups of deleted entries, the reference's NPE states);
* the lazy engine of ``tests/test_lazy_extraction.py:187`` (K=4, T=24):
  state after the scan, the drain and its matches equal JAX's;
* the two-tier slab of ``tests/test_two_tier.py:362``: state, outputs and
  counters equal JAX's, and placement equals the batched path's;
* a stacked bank and a per-step comparison of two scenarios.

The sequential step runs no walk kernel on any device: it is chosen from
the config when the matcher is built, and logged.  Its drain goes through
the walk pass, the kernel on the card.
"""

import logging

import numpy as np
import pytest
import torch

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.engine import TPUMatcher as JTPUMatcher
from kafkastreams_cep_tpu.engine.matcher import MatcherSession as JSession
from kafkastreams_cep_tpu.parallel.batch import BatchMatcher as JBatch
from kafkastreams_cep_tpu_torch import BatchMatcher, EngineConfig, TPUMatcher
from kafkastreams_cep_tpu_torch.engine.matcher import MatcherSession
from kafkastreams_cep_tpu_torch.engine import matcher as tmatcher

from test_torch_engine import run_both

AB_CFG = dict(max_runs=24, slab_entries=96, slab_preds=8, dewey_depth=12, max_walk=12)


def mod3(Q):
    """``tests/test_slab_batched.py: test_ab_engine_paths``' query."""
    return (
        Q().select("a").skip_till_any_match()
        .where(lambda k, v, ts_, st: (v % 3) == 0)
        .then().select("b").skip_till_any_match()
        .where(lambda k, v, ts_, st: (v % 3) == 1)
        .then().select("c")
        .where(lambda k, v, ts_, st: (v % 3) == 2)
        .build()
    )


def run_matcher(sess, values):
    got = []
    for i, v in enumerate(values):
        for s in sess.match(None, int(v), 1000 + i, offset=i):
            got.append(tuple((n, tuple(e.offset for e in evs))
                             for n, evs in s.as_map().items()))
    return got, sess.counters()


def test_ab_trace_equals_jax_sequential():
    values = np.random.default_rng(7).integers(0, 6, size=40).tolist()
    j_got, j_c = run_matcher(
        JSession(JTPUMatcher(mod3(ts.JQuery), JConfig(sequential_slab=True, **AB_CFG))),
        values)
    t_got, t_c = run_matcher(
        MatcherSession(TPUMatcher(mod3(ts.TQuery), EngineConfig(sequential_slab=True, **AB_CFG),
                                  device="cpu")), values)
    assert t_got == j_got and t_c == j_c
    assert len(t_got) > 0
    b_got, b_c = run_matcher(
        MatcherSession(TPUMatcher(mod3(ts.TQuery), EngineConfig(**AB_CFG), device="cpu")),
        values)
    assert b_got == t_got
    assert {k: v for k, v in b_c.items() if k != "slab_missing"} == {
        k: v for k, v in t_c.items() if k != "slab_missing"}


LAZY = dict(max_runs=16, slab_entries=64, slab_preds=8, dewey_depth=12, max_walk=12,
            handle_ring=64, lazy_extraction=True, sequential_slab=True)


def stock_events(K, T, seed):
    """``tests/test_lazy_extraction.py: stock_events`` (ts = 2t, off = t)."""
    ev = ts.events("stock", np.random.default_rng(seed), K, T)
    return ev._replace(ts=ev.ts // 3 * 2)


def test_lazy_sequential_equals_jax():
    K, T = 4, 24
    events = stock_events(K, T, 17)
    jb = JBatch(ts.stock(ts.JQuery), K, JConfig(**LAZY))
    tb = BatchMatcher(ts.stock(ts.TQuery), K, EngineConfig(**LAZY), device="cpu")
    js, _ = jb.scan(jb.init_state(), ts.to_jax(events))
    tst, _ = tb.scan(tb.init_state(), events)
    ts.assert_states_equal(js, tst, "lazy sequential scan")
    assert int(tst.hr_count.sum()) > 0
    js, jd = jb.drain(js)
    tst, td = tb.drain(tst)
    ts.assert_states_equal(js, tst, "after drain")
    for f in jd._fields:
        np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)),
                                      err_msg=f)
    assert tb.counters(tst) == jb.counters(js)
    # The batched lazy path drains the same matches.
    bb = BatchMatcher(ts.stock(ts.TQuery), K,
                      EngineConfig(**dict(LAZY, sequential_slab=False)), device="cpu")
    bs, _ = bb.scan(bb.init_state(), events)
    bs, bd = bb.drain(bs)
    for f in ("count", "stage", "off", "seq", "row"):
        assert torch.equal(getattr(bd, f), getattr(td, f)), f


PRESSURE = dict(max_runs=8, slab_entries=16, slab_hot_entries=8, slab_preds=4,
                dewey_depth=8, max_walk=8)


def test_two_tier_sequential_equals_jax():
    K, T = 4, 32
    events = stock_events(K, T, 9)
    conf = dict(PRESSURE, sequential_slab=True)
    jb = JBatch(ts.stock(ts.JQuery), K, JConfig(**conf))
    tb = BatchMatcher(ts.stock(ts.TQuery), K, EngineConfig(**conf), device="cpu")
    js, jo = jb.scan(jb.init_state(), ts.to_jax(events))
    tst, to = tb.scan(tb.init_state(), events)
    ts.assert_states_equal(js, tst, "two-tier sequential")
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tb.counters(tst) == jb.counters(js)
    assert tb.hot_counters(tst) == jb.hot_counters(js)
    assert int(tst.slab.demotions.sum()) > 0
    bb = BatchMatcher(ts.stock(ts.TQuery), K, EngineConfig(**PRESSURE), device="cpu")
    bs, bo = bb.scan(bb.init_state(), events)
    for f in ("count", "stage", "off"):
        assert torch.equal(getattr(bo, f), getattr(to, f)), f
    assert torch.equal(bs.slab.stage, tst.slab.stage)
    assert torch.equal(bs.slab.off, tst.slab.off)
    assert bb.counters(bs) == tb.counters(tst)


@pytest.mark.parametrize("name", ["skip_any", "stock"])
def test_per_step_sequential_equals_jax(name):
    run_both(name, K=3, T=12, seed=2, sequential_slab=True)


def test_sequential_runs_no_walk_pass_and_logs(monkeypatch, caplog):
    """The choice is made from the config when the matcher is built, and
    logged; no step goes through the walk pass, and every drain does (the
    kernel on the card, as at ``sequential_slab=False``)."""
    calls = []
    real = tmatcher.walk_pass

    def spy(*a, **k):
        calls.append(bool(k.get("drain")))
        return real(*a, **k)

    monkeypatch.setattr(tmatcher, "walk_pass", spy)
    with caplog.at_level(logging.INFO):
        m = TPUMatcher(ts.stock(ts.TQuery), EngineConfig(**dict(LAZY, max_runs=8)),
                       device="cpu")
    assert any("sequential_slab" in r.getMessage() for r in caplog.records)
    s = MatcherSession(m)
    got = [x for i, v in enumerate(ts.STOCKS) for x in s.match(None, v, 1000 * i, offset=i)]
    assert len(got) == 4
    assert calls and all(calls)


def test_stacked_bank_sequential_equals_batched():
    from kafkastreams_cep_tpu_torch.parallel.stacked import StackedBankMatcher

    pat = ts.skip_till_any(ts.TQuery)
    conf = dict(max_runs=12, slab_entries=32, slab_preds=6, dewey_depth=10, max_walk=10)
    K, T = 4, 32
    ev = ts.events("letters", np.random.default_rng(4), K, T)
    seq = StackedBankMatcher([pat, pat], K, EngineConfig(**conf, sequential_slab=True),
                             device="cpu")
    bat = StackedBankMatcher([pat, pat], K, EngineConfig(**conf), device="cpu")
    ss, so = seq.scan(seq.init_state(), ev)
    bs, bo = bat.scan(bat.init_state(), ev)
    assert int(bo.count.sum()) > 0
    for f in ("count", "stage", "off"):
        assert torch.equal(getattr(so, f), getattr(bo, f)), f
    c_s, c_b = seq.counters(ss), bat.counters(bs)
    c_s.pop("slab_missing"), c_b.pop("slab_missing")
    assert c_s == c_b


def test_scan_kernel_switch_serves_scans_in_the_batched_order(monkeypatch):
    """Under ``CEP_SCAN_KERNEL=1`` scans take the whole-scan kernel (its
    plain version on the CPU), which the JAX package builds without reading
    ``sequential_slab``: they equal the batched engine's scans, while
    ``step`` stays per op."""
    monkeypatch.setenv("CEP_SCAN_KERNEL", "1")
    K, T = 4, 16
    events = stock_events(K, T, 9)
    seq = BatchMatcher(ts.stock(ts.TQuery), K, EngineConfig(**PRESSURE, sequential_slab=True),
                       device="cpu")
    assert seq.uses_scan_kernel
    monkeypatch.delenv("CEP_SCAN_KERNEL")
    bat = BatchMatcher(ts.stock(ts.TQuery), K, EngineConfig(**PRESSURE), device="cpu")
    s1, o1 = seq.scan(seq.init_state(), events)
    s2, o2 = bat.scan(bat.init_state(), events)
    ts.assert_states_equal(s1, s2, "scan kernel vs batched")
    for a, b in zip(o1, o2):
        assert torch.equal(a, b)
    assert seq.step.__qualname__.startswith("make_sequential_step")
