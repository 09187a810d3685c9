"""The port's lazy extraction (``EngineConfig.lazy_extraction``) against the
JAX package's, after ``tests/test_lazy_extraction.py``.

* ``BatchMatcher.drain`` and ``TPUMatcher.drain``: the drained state and
  every ``DrainOutput`` leaf equal the JAX drain's, after a per-step
  comparison of the lazy scan;
* lazy equals eager on every ``tests/torch_scenarios.py`` query: the same
  matches in the same order, the same loss counters, and the eager
  extraction hops moved verbatim to the drain;
* ``MatcherSession`` under lazy against ``OracleNFA``;
* a sweep between completion and drain keeps the pinned matches;
* the processor's emission order equals the JAX processor's at
  ``drain_interval`` 1 and 3 (and pipelined), with ``flush``;
* a checkpoint with pending handles cross-loads both ways.
"""

import jax
import numpy as np
import pytest

import torch_scenarios as ts
from kafkastreams_cep_tpu.runtime import checkpoint as jckpt
from kafkastreams_cep_tpu_torch import BatchMatcher, CEPProcessor, EngineConfig, Record
from kafkastreams_cep_tpu_torch.runtime import checkpoint as tckpt

from test_torch_engine import CONFIG as ENGINE_CONFIG
from test_torch_engine import run_both, run_oracle_differential
from test_torch_processor import assert_same, feed, pair, stream

LAZY = dict(ENGINE_CONFIG, slab_entries=64, lazy_extraction=True,
            handle_ring=32)


def assert_drained_equal(j_out, t_out, msg=""):
    for f in j_out._fields:
        np.testing.assert_array_equal(getattr(t_out, f).numpy(),
                                      np.asarray(getattr(j_out, f)),
                                      err_msg=f"{msg} {f}")


@pytest.mark.parametrize("name", ["stock", "float_fold"])
def test_drain_state_and_output_equal_jax(name):
    tb, tst, jb, js = run_both(name, K=4, T=24, seed=3, **LAZY)
    assert int(tst.hr_count.sum()) > 0
    j_state, j_out = jb.drain(js)
    t_state, t_out = tb.drain(tst)
    ts.assert_states_equal(j_state, t_state, "after drain")
    assert_drained_equal(j_out, t_out, "BatchMatcher.drain")
    assert int(t_state.hr_count.sum()) == 0
    # The matcher's drain is the same pass (JAX: one lane, vmapped).
    m_state, m_out = tb.matcher.drain(tst)
    jm_state, jm_out = jax.vmap(jb.matcher._drain_fn)(js)
    ts.assert_states_equal(jm_state, m_state, "TPUMatcher.drain")
    assert_drained_equal(jm_out, m_out, "TPUMatcher.drain")
    # Draining an empty ring changes nothing.
    again, out2 = tb.drain(t_state)
    ts.assert_states_equal(j_state, again, "second drain")
    assert int(out2.count.sum()) == 0


def ordered_rows(count, stage, off):
    """Per lane, the ``(stages, offsets)`` of each match in row order of a
    ``[K, N]`` count grid."""
    c, st, of = count.numpy(), stage.numpy(), off.numpy()
    return [
        [(tuple(st[k, i, :n]), tuple(of[k, i, :n]))
         for i, n in enumerate(c[k]) if n]
        for k in range(c.shape[0])
    ]


# Loss-free for every scenario on the trace below (seed 8, K=6, T=16): the
# lazy slab holds completed chains until the drain, and the float-fold
# query completes up to 60 matches a lane.
LOSS_FREE = dict(max_runs=16, slab_entries=96, slab_preds=16, dewey_depth=12,
                 max_walk=10, handle_ring=128)


# float_fold is left out: its runs walk into entries that are gone (the
# reference's NPE states, counted in slab_missing), and a pinned root
# changes which lookups miss, so lazy and eager differ there on the JAX
# engine too.  Its lazy run is held against the JAX engine's above.
@pytest.mark.parametrize("name", sorted(set(ts.SCENARIOS) - {"float_fold"}))
def test_lazy_equals_eager(name):
    """The drained matches, in ring order, are the eager engine's matches
    in (step, run row) order; counters agree and the eager extraction hops
    all move to the drain."""
    builder, kind = ts.SCENARIOS[name]
    K, T = 6, 16
    events = ts.events(kind, np.random.default_rng(8), K, T)
    eager = BatchMatcher(builder(ts.TQuery), K, EngineConfig(**LOSS_FREE),
                         device="cpu")
    lazy = BatchMatcher(builder(ts.TQuery), K, EngineConfig(
        **LOSS_FREE, lazy_extraction=True), device="cpu")
    st_e, out_e = eager.scan(eager.init_state(), events)
    # Precondition: no capacity loss (slab_missing is the reference's own
    # NPE count, ver_overflows is renorm-bounded), and some matches.
    lossy = dict(eager.counters(st_e), slab_missing=0, ver_overflows=0)
    assert not any(lossy.values()) and int(out_e.count.sum()) > 0
    st_l, out_l = lazy.scan(lazy.init_state(), events)
    assert int(out_l.count.sum()) == 0  # nothing extracted in-step
    st_l, dout = lazy.drain(st_l)
    R, W = out_e.count.shape[2], out_e.stage.shape[-1]
    want = ordered_rows(out_e.count.reshape(K, T * R),
                        out_e.stage.reshape(K, T * R, W),
                        out_e.off.reshape(K, T * R, W))
    assert ordered_rows(dout.count, dout.stage, dout.off) == want
    assert eager.counters(st_e) == lazy.counters(st_l)
    we, wl = eager.walk_counters(st_e), lazy.walk_counters(st_l)
    assert wl["drain_hops"] == we["extract_hops"] and wl["extract_hops"] == 0
    assert wl["walk_hops"] == we["walk_hops"]


@pytest.mark.parametrize(
    "name,values,n",
    [
        ("strict3", [ts.A, ts.X, ts.B, ts.C, ts.A, ts.B, ts.C], 1),
        ("kleene", [ts.A, ts.B, ts.C, ts.C, ts.D], 1),
        ("skip_any", [ts.A, ts.B, ts.C, ts.C, ts.D], 2),
        ("stock", ts.STOCKS, 4),
    ],
)
def test_session_lazy_matches_oracle(name, values, n):
    """``MatcherSession`` drains per event, so under lazy extraction it
    returns the oracle's matches at the oracle's events."""
    cfg = EngineConfig(max_runs=24, slab_entries=64, slab_preds=8,
                       dewey_depth=12, max_walk=12, lazy_extraction=True,
                       handle_ring=32)
    matches = run_oracle_differential(ts.SCENARIOS[name][0], values, cfg)
    assert len(matches) == n


def test_sweep_preserves_pinned_handles():
    """A sweep between completion and drain (handles are mark-sweep roots
    and renormalize with the runs) keeps every pending match; the swept
    state equals the JAX sweep's."""
    tb, tst, jb, js = run_both("straddle", K=4, T=24, seed=13, **LAZY)
    assert int(tst.hr_count.sum()) > 0
    _, want = tb.drain(tst)
    swept = tb.sweep(tst)
    ts.assert_states_equal(jb.sweep(js), swept, "sweep")
    _, got = tb.drain(swept)
    assert ordered_rows(got.count, got.stage, got.off) == ordered_rows(
        want.count, want.stage, want.off)


LAZY_PROC = dict(lazy_extraction=True, handle_ring=64, slab_entries=64)


@pytest.mark.parametrize("drain_interval,batch", [(1, 8), (3, 2)])
def test_stock_demo_lazy_prints_expected_lines(drain_interval, batch):
    """``examples/stock_demo.py`` under lazy extraction: the same four
    lines, byte for byte, whether each batch drains or ``flush`` does."""
    import stock_demo

    proc = CEPProcessor(
        ts.stock(ts.TQuery), num_lanes=1,
        config=EngineConfig(max_runs=32, slab_entries=64, slab_preds=8,
                            dewey_depth=16, max_walk=16, lazy_extraction=True),
        topic="StockEvents", drain_interval=drain_interval, device="cpu",
    )
    name_of = {i: ev["name"] for i, ev in enumerate(stock_demo.STOCK_EVENTS)}
    records = [
        Record("stocks", {"price": ev["price"], "volume": ev["volume"]}, 1000 + i)
        for i, ev in enumerate(stock_demo.STOCK_EVENTS)
    ]
    got = []
    for i in range(0, len(records), batch):
        got += proc.process(records[i:i + batch])
    got += proc.flush()
    assert [stock_demo.format_match(seq, name_of) for _, seq in got] == stock_demo.EXPECTED
    assert all(v == 0 for v in proc.counters().values())


@pytest.mark.parametrize("drain_interval,pipeline,budget", [
    (1, False, 131072), (3, False, 131072), (3, True, 131072), (3, False, 2),
])
def test_processor_emission_order_equals_jax(drain_interval, pipeline, budget):
    """Budget 2 sends the drained decode down its full-pull fallback."""
    jproc, tproc = pair(config=LAZY_PROC, drain_interval=drain_interval,
                        pipeline=pipeline, gc_interval=2, decode_budget=budget)
    n = sum(feed(jproc, tproc, b) for b in stream(5, n_batches=5))
    j, t = jproc.flush(), tproc.flush()
    assert ts.canon_matches(j) == ts.canon_matches(t)
    assert n + len(t) > 0
    assert_same(jproc, tproc)
    assert int(tproc.state.hr_count.sum()) == 0
    assert tproc.hot_counters() == jproc.hot_counters()
    assert tproc.metrics.decode_fallbacks == jproc.metrics.decode_fallbacks
    assert (budget == 2) == (tproc.metrics.decode_fallbacks > 0)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_with_pending_handles_cross_loads(writer, tmp_path):
    """The snapshot carries a non-empty ring, a two-tier slab and the
    attribution tallies (``stage_counts [K, 4, S]``, ``stage_hops
    [K, S]``) under the same leaf names in both packages."""
    batches = stream(6, n_batches=5)
    jproc, tproc = pair(config=dict(LAZY_PROC, slab_hot_entries=16,
                                    stage_attribution=True), drain_interval=4)
    for b in batches[:2]:
        feed(jproc, tproc, b)
    assert int(tproc.state.hr_count.sum()) > 0  # handles wait for a drain
    path = str(tmp_path / "ring.ckpt")
    if writer == "jax":
        jckpt.save_checkpoint(jproc, path)
    else:
        tckpt.save_checkpoint(tproc, path)
    jproc = jckpt.restore_processor(ts.stock(ts.JQuery), path)
    tproc = tckpt.restore_processor(ts.stock(ts.TQuery), path, device="cpu")
    assert tproc.drain_interval == jproc.drain_interval == 4
    assert int(tproc.state.hr_count.sum()) > 0
    assert tproc.state.stage_counts.shape[-1] == len(tproc.batch.names) > 0
    assert int(tproc.state.slab.stage_hops.sum()) > 0
    assert_same(jproc, tproc)
    for b in batches[2:]:
        feed(jproc, tproc, b)
    j, t = jproc.flush(), tproc.flush()
    assert ts.canon_matches(j) == ts.canon_matches(t) and len(t) > 0
    assert_same(jproc, tproc)
