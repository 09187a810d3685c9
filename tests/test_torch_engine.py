"""The PyTorch engine against the JAX engine and the host oracle.

Per-step state equality: the same queries and the same numpy-seeded
``[K, T]`` traces go through the JAX ``BatchMatcher`` (its jnp path on the
CPU) and the port's ``BatchMatcher`` (``device="cpu"``, the plain walk
pass); after every step every state leaf and every output must be equal,
bit for bit.  The reference scenarios (``NFATest.java``, as in
``tests/test_engine_golden.py``) also run against ``OracleNFA`` through the
port's ``MatcherSession``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenarios as ts
from kafkastreams_cep_tpu import OracleNFA
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.engine import EventBatch as JEvents
from kafkastreams_cep_tpu.parallel import BatchMatcher as JBatch
from kafkastreams_cep_tpu_torch import BatchMatcher, CEPProcessor, EngineConfig
from kafkastreams_cep_tpu_torch import MatcherSession, TPUMatcher
from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch

A, B, C, D, X = ts.A, ts.B, ts.C, ts.D, ts.X

CONFIG = dict(max_runs=12, slab_entries=32, slab_preds=6, dewey_depth=10,
              max_walk=10)


def step_both(name, K=4, T=16, seed=0, **cfg):
    """``run_both``'s port side: ``(port BatchMatcher, port state)``."""
    tb, tst, _, _ = run_both(name, K, T, seed, **cfg)
    return tb, tst


def run_both(name, K=4, T=16, seed=0, **cfg):
    """One scenario through both packages' ``BatchMatcher`` step by step,
    states and outputs compared after every step; returns ``(port batch,
    port state, JAX batch, JAX state)``."""
    builder, kind = ts.SCENARIOS[name]
    jpat, tpat = ts.both(builder)
    conf = dict(CONFIG, **cfg)
    jb = JBatch(jpat, K, JConfig(**conf))
    tb = BatchMatcher(tpat, K, EngineConfig(**conf), device="cpu")
    rng = np.random.default_rng(seed)
    values = ts.trace(kind, rng, K, T)
    valid = rng.random((K, T)) < 0.9  # some padding steps
    js, tst = jb.init_state(), tb.init_state()
    ts.assert_states_equal(js, tst, "init")
    key = np.arange(K, dtype=np.int32)
    for t in range(T):
        col = (
            {f: v[:, t] for f, v in values.items()}
            if isinstance(values, dict) else values[:, t]
        )
        common = dict(ts=np.full(K, 3 * t, np.int32), off=np.full(K, t, np.int32),
                      valid=valid[:, t])
        jev = JEvents(key=jnp.asarray(key), value=(
            {f: jnp.asarray(v) for f, v in col.items()}
            if isinstance(col, dict) else jnp.asarray(col)
        ), **{k: jnp.asarray(v) for k, v in common.items()})
        tev = EventBatch(key=ts.to_t(key), value=(
            {f: ts.to_t(v) for f, v in col.items()}
            if isinstance(col, dict) else ts.to_t(col)
        ), **{k: ts.to_t(v) for k, v in common.items()})
        js, jout = jb.step(js, jev)
        tst, tout = tb.step(tst, tev)
        ts.assert_states_equal(js, tst, f"{name} step {t}")
        for a, b in zip(jout, tout):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"{name} step {t} output")
    return tb, tst, jb, js


@pytest.mark.parametrize("name", sorted(ts.SCENARIOS))
def test_per_step_state_equals_jax(name):
    step_both(name)


def test_stock_headline_shape_equals_jax():
    """The stock query at the headline widths (``bench.py``), with enough
    steps that runs overflow, versions grow and walks truncate."""
    tb, state = step_both(
        "stock", K=3, T=24, seed=7, max_runs=24, slab_entries=48,
        slab_preds=8, dewey_depth=12, max_walk=12,
    )
    assert tb.walk_counters(state)["extract_hops"] > 0


def test_tight_capacity_counters_equal_jax():
    """Undersized queue, slab and pointer lists: every loss counter fires
    and still agrees with the JAX engine."""
    tb, state = step_both(
        "skip_any", K=3, T=20, seed=3, max_runs=4, slab_entries=8,
        slab_preds=2, dewey_depth=4, max_walk=4,
    )
    c = tb.counters(state)
    assert c["run_drops"] > 0 and c["slab_full_drops"] + c["slab_pred_drops"] > 0


def test_enforce_windows_equals_jax():
    step_both("stock", K=2, T=12, seed=5, enforce_windows=True)


def run_oracle_differential(builder, values, config=None, ts0=1000):
    """The oracle and the port's session over one trace: identical match
    emission (count, order, content) at every event, counters at 0."""
    jpat, tpat = ts.both(builder)
    oracle = OracleNFA.from_pattern(jpat)
    session = MatcherSession(TPUMatcher(
        tpat, config or EngineConfig(**CONFIG), device="cpu"
    ))
    matches = []
    for i, v in enumerate(values):
        o = oracle.match(None, v, ts0 + i)
        e = session.match(None, v, ts0 + i)
        assert [ts.canon(s) for s in o] == [ts.canon(s) for s in e], f"event {i}"
        matches.extend(e)
    counters = session.counters()
    assert all(c == 0 for c in counters.values()), counters
    return matches


@pytest.mark.parametrize(
    "name,values,n",
    [
        ("strict3", [A, B, C], 1),
        ("strict3", [A, X, B, C, A, B, C], 1),
        ("kleene", [A, B, C, C, D], 1),
        ("skip_next", [A, B, C, C, D], 1),
        ("skip_any", [A, B, C, C, D], 2),
        ("stock", ts.STOCKS, 4),
    ],
)
def test_oracle_differential(name, values, n):
    cfg = EngineConfig(max_runs=24, slab_entries=64, slab_preds=8,
                       dewey_depth=12, max_walk=12)
    matches = run_oracle_differential(ts.SCENARIOS[name][0], values, cfg)
    assert len(matches) == n


def test_oracle_differential_random_letters():
    rng = np.random.default_rng(11)
    values = [int(v) for v in rng.integers(0, 5, size=40)]
    run_oracle_differential(ts.skip_till_any, values, EngineConfig(
        max_runs=64, slab_entries=128, slab_preds=16, dewey_depth=16,
        max_walk=16,
    ))


@pytest.mark.parametrize("field,value", [
    ("sequential_slab", True), ("walker_budget", 2),
])
def test_out_of_slice_configs_raise(field, value):
    """The two switches the port once refused build now, with the JAX
    engine's state (their runs are held against JAX in
    ``test_torch_sequential_slab.py`` and ``test_torch_walker_budget.py``);
    only a budget below 1 raises."""
    conf = dict(CONFIG, **{field: value})
    tb = BatchMatcher(ts.strict3(ts.TQuery), 3, EngineConfig(**conf), device="cpu")
    jb = JBatch(ts.strict3(ts.JQuery), 3, JConfig(**conf))
    ts.assert_states_equal(jb.init_state(), tb.init_state(), field)
    with pytest.raises(ValueError, match="walker_budget"):
        TPUMatcher(ts.strict3(ts.TQuery), EngineConfig(walker_budget=0), device="cpu")


@pytest.mark.parametrize("field,value", [
    ("lazy_extraction", True), ("slab_hot_entries", 8),
    ("stage_attribution", True),
])
def test_ported_configs_build_as_jax(field, value):
    """The modes this port serves build, with the JAX engine's state."""
    conf = dict(CONFIG, **{field: value})
    tb = BatchMatcher(ts.strict3(ts.TQuery), 3, EngineConfig(**conf), device="cpu")
    jb = JBatch(ts.strict3(ts.JQuery), 3, JConfig(**conf))
    ts.assert_states_equal(jb.init_state(), tb.init_state(), field)


def test_entry_points_need_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    pat = ts.strict3(ts.TQuery)
    for make in (
        lambda: TPUMatcher(pat),
        lambda: BatchMatcher(pat, 2),
        lambda: CEPProcessor(pat, 2),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
