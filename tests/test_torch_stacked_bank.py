"""The port's stacked multi-query bank against the JAX package's, after
``tests/test_stacked_bank.py`` and at its sizes.

The same numpy-seeded events go through the JAX package (jnp walks,
``CEP_WALK_KERNEL=0``) and through the port on the CPU, and are held equal
bit for bit:

* the stacked step of ``engine/matcher.py: _build_step`` over random
  per-lane query ids, every state leaf and output after each step;
* ``StackedBankMatcher`` on the ``q_threshold`` and ``q_folded`` banks:
  outputs, every state leaf, counters, per-query counters and
  ``pred_stats``; and each query's block equal to the port's own
  single-query ``BatchMatcher``, eagerly, lazily (with ``drain``), with the
  two-tier slab and with stage attribution;
* unstackable shapes raise, and ``choose_bank`` picks a mode.

The walk-pass kernel these paths launch on the card is held against its
plain version there by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenarios as ts
from kafkastreams_cep_tpu.compiler.tables import lower as jlower
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.engine.matcher import _build_step as j_build_step
from kafkastreams_cep_tpu.parallel.stacked import StackedBankMatcher as JStacked
from kafkastreams_cep_tpu_torch import BatchMatcher, EngineConfig
from kafkastreams_cep_tpu_torch.compiler.multitenant import plan_step_predicates
from kafkastreams_cep_tpu_torch.compiler.tables import lower, stackable
from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch, _build_step, make_step
from kafkastreams_cep_tpu_torch.parallel.stacked import (
    StackedBankMatcher,
    choose_bank,
    tile_states,
)

# tests/test_stacked_bank.py's config.
CFG = dict(max_runs=8, slab_entries=24, slab_preds=4, dewey_depth=8, max_walk=8)
MODES = {
    "default": {},
    "lazy": dict(lazy_extraction=True, handle_ring=64),
    "two_tier": dict(slab_hot_entries=8),
    "attribution": dict(stage_attribution=True),
}


def q_threshold(Q, lo, hi):
    """A parameterized two-stage query: the typical bank member."""
    return (
        Q().select("a").where(lambda k, v, ts_, st, lo=lo: v["x"] < lo)
        .then().select("b").skip_till_next_match()
        .where(lambda k, v, ts_, st, hi=hi: v["x"] > hi)
        .build()
    )


def q_folded(Q, mult):
    """Same shape, with a fold read by the next stage's predicate."""
    return (
        Q().select("a").where(lambda k, v, ts_, st: v["x"] < 3)
        .fold("acc", lambda k, v, curr, m=mult: curr + m * v["x"], init=0)
        .then().select("b").skip_till_next_match()
        .where(lambda k, v, ts_, st: v["x"] > st.get("acc"))
        .build()
    )


def q_float(Q, scale):
    """Same shape with a float32 fold state (typed agg bit patterns under
    other queries' int decodes)."""
    return (
        Q().select("a").where(lambda k, v, ts_, st: v["x"] < 4)
        .fold("m", lambda k, v, curr, s=scale: curr + s * v["x"], init=0.5)
        .then().select("b").skip_till_next_match()
        .where(lambda k, v, ts_, st: v["x"] > st.get("m"))
        .build()
    )


BANKS = {
    "threshold": (q_threshold, [(2, 6), (3, 7), (4, 5)]),
    "folded": (q_folded, [(1,), (2,), (3,)]),
}


def bank(Q, name):
    mk, params = BANKS[name]
    return [mk(Q, *p) for p in params]


def trace(K, T, seed):
    """``tests/test_stacked_bank.py: trace`` as a port batch."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 10, size=(K, T)).astype(np.int32)
    i32 = torch.int32
    return EventBatch(
        key=torch.arange(K, dtype=i32)[:, None].expand(K, T),
        value={"x": torch.as_tensor(xs)},
        ts=torch.arange(T, dtype=i32)[None, :].expand(K, T),
        off=torch.arange(T, dtype=i32)[None, :].expand(K, T),
        valid=torch.ones((K, T), dtype=torch.bool),
    )


def lane(ev, t):
    return EventBatch(ev.key[:, t], {"x": ev.value["x"][:, t]}, ev.ts[:, t],
                      ev.off[:, t], ev.valid[:, t])


@pytest.fixture
def jnp_path(monkeypatch):
    monkeypatch.setenv("CEP_WALK_KERNEL", "0")
    monkeypatch.delenv("CEP_SCAN_KERNEL", raising=False)


def assert_out_equal(jout, tout, msg):
    for f in tout._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jout, f)),
                                      getattr(tout, f).numpy(), err_msg=f"{msg} {f}")


@pytest.mark.parametrize("name", ["threshold", "folded", "float"])
def test_stacked_step_random_qids_equals_jax(jnp_path, name):
    """One stacked step per event, each lane on a random query: every
    state leaf and output equal to JAX's vmapped stacked step."""
    if name == "float":
        pats = [(q_float(ts.JQuery, s), q_float(ts.TQuery, s)) for s in (0.5, 1.25, 2.0)]
    else:
        mk, params = BANKS[name]
        pats = [(mk(ts.JQuery, *p), mk(ts.TQuery, *p)) for p in params]
    K, T = 10, 16
    qids = np.random.default_rng(5).integers(0, len(pats), size=K).astype(np.int32)
    jstep, jinit, jph = j_build_step([jlower(j) for j, _ in pats], JConfig(**CFG))
    ph = _build_step([lower(t) for _, t in pats], EngineConfig(**CFG), "cpu")
    assert ph.pred_stats == jph.pred_stats
    step = make_step(ph, qids=torch.as_tensor(qids))
    js = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[jinit(int(q)) for q in qids])
    tst = tile_states([ph.init_state(1, int(q)) for q in qids])
    ts.assert_states_equal(js, tst, "init")
    jvstep = jax.jit(jax.vmap(jstep))
    ev = trace(K, T, seed=21)
    jev = ts.to_jax(ev)
    for t in range(T):
        js, jo = jvstep(js, jax.tree_util.tree_map(lambda x: x[:, t], jev), jnp.asarray(qids))
        tst, to = step(tst, lane(ev, t))
        ts.assert_states_equal(js, tst, f"step {t}")
        assert_out_equal(jo, to, f"step {t}")
    assert int(tst.slab.extract_hops.sum()) > 0, "no lane completed a match"


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(BANKS))
def test_stacked_bank_equals_jax_and_serial(jnp_path, name, mode):
    """Two batches through the bank: outputs, state leaves and counters
    equal JAX's stacked bank, and each query's block equals the port's
    single-query matcher on the same events."""
    K, T = 8, 24
    conf = dict(CFG, **MODES[mode])
    jb = JStacked(bank(ts.JQuery, name), K, JConfig(**conf))
    tb = StackedBankMatcher(bank(ts.TQuery, name), K, EngineConfig(**conf), device="cpu")
    assert tb.pred_stats == jb.pred_stats
    serial = [BatchMatcher(p, K, EngineConfig(**conf), device="cpu")
              for p in bank(ts.TQuery, name)]
    js, tst = jb.init_state(), tb.init_state()
    ss = [m.init_state() for m in serial]
    ts.assert_states_equal(js, tst, "init")
    for b in range(2):
        ev = trace(K, T, seed=21 + b)
        js, jo = jb.scan(js, ts.to_jax(ev))
        tst, to = tb.scan(tst, ev)
        ts.assert_states_equal(js, tst, f"batch {b}")
        assert_out_equal(jo, to, f"batch {b}")
        for q, m in enumerate(serial):
            ss[q], o1 = m.scan(ss[q], ev)
            for f in o1._fields:
                np.testing.assert_array_equal(getattr(to, f)[q].numpy(),
                                              getattr(o1, f).numpy(),
                                              err_msg=f"{mode} batch {b} q{q} {f}")
        if mode == "lazy":
            js, jd = jb.drain(js)
            tst, td = tb.drain(tst)
            ts.assert_states_equal(js, tst, f"drain {b}")
            assert_out_equal(jd, td, f"drain {b}")
            assert int(td.count.sum()) > 0 or b == 0
            drained = []
            for q, m in enumerate(serial):
                ss[q], d1 = m.drain(ss[q])
                drained.append(d1)
            for f in td._fields:
                np.testing.assert_array_equal(
                    getattr(td, f).numpy(),
                    torch.cat([getattr(d, f) for d in drained]).numpy(),
                    err_msg=f"drain {b} {f}")
    assert tb.counters(tst) == jb.counters(js)
    assert tb.hot_counters(tst) == jb.hot_counters(js)
    assert tb.walk_counters(tst) == jb.walk_counters(js)
    assert tb.per_query_counters(tst) == jb.per_query_counters(js)
    assert tb.stage_counters(tst) == jb.stage_counters(js)
    summed = {k: sum(m.counters(s)[k] for m, s in zip(serial, ss)) for k in tb.counters(tst)}
    assert tb.counters(tst) == summed
    snap = tb.metrics_snapshot(tst)
    assert snap["per_pattern"] == tb.per_query_counters(tst)
    if (name, mode) == ("threshold", "two_tier"):
        assert tb.hot_counters(tst)["slab_demotions"] > 0
    if mode == "attribution":
        assert snap["per_stage"]


def test_pred_stats_equal_jax():
    """The merged dispatch table's counts, for stacked and single builds,
    on banks with shared, private and state-reading predicates."""
    for name in ("threshold", "folded"):
        jt = [jlower(p) for p in bank(ts.JQuery, name)]
        tt = [lower(p) for p in bank(ts.TQuery, name)]
        for sub in (tt[:1], tt):
            want = j_plan_step(jt[:len(sub)])
            got = plan_step_predicates(sub).stats
            assert got == want, name
    # Identical predicates across queries intern to one entry.
    same = [lower(q_threshold(ts.TQuery, 3, 7)) for _ in range(4)]
    stats = plan_step_predicates(same).stats
    assert stats["total_predicates"] == 4 * stats["distinct_predicates"]
    assert stats["dedup_ratio"] == 4.0 and stats["run_level"] == 0
    folded = plan_step_predicates([lower(p) for p in bank(ts.TQuery, "folded")]).stats
    assert folded["run_level"] > 0 and folded["event_level"] == 1


def j_plan_step(tlist):
    from kafkastreams_cep_tpu.compiler.multitenant import plan_step_predicates as jplan

    return jplan(tlist).stats


def test_unstackable_shapes_rejected():
    p2 = q_threshold(ts.TQuery, 2, 6)
    p3 = ts.strict3(ts.TQuery)
    assert not stackable([lower(p2), lower(p3)])
    with pytest.raises(ValueError, match="stackable"):
        StackedBankMatcher([p2, p3], 8, EngineConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="stacked patterns"):
        _build_step([lower(p2), lower(p3)], EngineConfig(**CFG), "cpu")
    # A walker budget is no shape: same-shape queries stack at any budget.
    assert StackedBankMatcher([p2, p2], 8, EngineConfig(**CFG, walker_budget=2),
                              device="cpu").Q == 2


def test_choose_bank_modes():
    def q(i):
        return q_threshold(ts.TQuery, 3 + i, 6)

    mode, det = choose_bank([q(0), ts.strict3(ts.TQuery)], EngineConfig(**CFG), device="cpu")
    assert mode == "serial" and det["reason"] == "not stackable"
    mode, det = choose_bank([q(0), q(1)], EngineConfig(**CFG), device="cpu")
    assert mode == "stacked"
    mode, det = choose_bank([q(0), q(1)], EngineConfig(**CFG), trace(8, 12, 3), reps=1,
                            device="cpu")
    assert mode in ("serial", "stacked")
    assert det["serial_s"] > 0 and det["stacked_s"] > 0
