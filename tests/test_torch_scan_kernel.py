"""The port's whole-scan path (``CEP_SCAN_KERNEL=1``) against the JAX
package, after ``tests/test_scan_kernel.py``.

On the CPU the port's ``BatchMatcher.scan`` traces the pattern into C++
(``ops/scan_codegen.py``) and then runs the kernel's plain version
(``ops/scan_kernel.py: scan_pass_plain``); every output, state leaf and
counter must equal the JAX package's, bit for bit:

* against JAX's own whole-scan kernel (``build_scan``, interpret mode) at
  K=128, for strict contiguity and typed float folds — the Pallas kernel
  prunes pointers in place, so storage behind ``npreds`` is masked
  (``test_slab_batched.canon_slab``) as in ``test_torch_walk_kernel.py``;
* against JAX's ``BatchMatcher`` (jnp path) for the stock query with
  padding holes, the Kleene skip-till-any query over two scans, version
  overflow without renormalization, ``enforce_windows``, and the stock
  query lazily (E=96, a 512-handle ring; the drain compared through
  ``decode.compact_drained``);
* for a JAX scan's state carried across by ``convert.py`` and continued on
  the port's scan path;
* in its tiered form (``promo=``), against JAX's tiered whole-scan kernel
  (``build_scan(..., promotion=p)``, interpret mode) at K=128.

It also pins the switch's contract: ``uses_scan_kernel`` is True on every
pattern above; a predicate that calls ``torch`` falls back to the per-step
path (logged, ``uses_scan_kernel`` False, results still equal to JAX); any
other failure of code generation or of the kernel call propagates.  The
same cases run in the two-tier, attribution and combined instances, eager
and lazy, with the hot-tier counters and the stage and conjunct reports.

The CUDA kernel itself runs only on a GPU (``chip_smoke.py``; the
``cuda``-marked test below skips without one).
"""

import dataclasses
import itertools
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenarios as ts
from kafkastreams_cep_tpu.compiler.tables import lower as jlower
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.ops import decode as jdecode
from kafkastreams_cep_tpu.ops.scan_kernel import build_scan
from kafkastreams_cep_tpu.parallel import BatchMatcher as JBatch
from kafkastreams_cep_tpu_torch import BatchMatcher, EngineConfig
from kafkastreams_cep_tpu_torch.convert import state_arrays, to_torch
from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch
from kafkastreams_cep_tpu_torch.ops import decode, scan_codegen, scan_kernel

from test_slab_batched import canon_slab

CFG = dict(max_runs=8, slab_entries=24, slab_preds=4, dewey_depth=8, max_walk=8)


# The queries of tests/test_scan_kernel.py, over {"x": int32} events.
def strict(Q):
    return (
        Q().select("a").where(lambda k, v, ts, st: v["x"] == 1)
        .then().select("b").where(lambda k, v, ts, st: v["x"] == 2)
        .then().select("c").where(lambda k, v, ts, st: v["x"] == 3)
        .build()
    )


def typed_float(Q):
    return (
        Q().select("a").where(lambda k, v, ts, st: v["x"] > 0)
        .fold("ema", lambda k, v, curr: 0.5 * curr + 0.25 * v["x"], init=0.0)
        .fold("n", lambda k, v, curr: curr + 1, init=0)
        .then().select("b").skip_till_next_match()
        .where(lambda k, v, ts, st: (st.get("ema") > 0.7) & (st.get("n") > 1))
        .build()
    )


def kleene_any(Q):
    return (
        Q().select("a").where(lambda k, v, ts, st: v["x"] == 0)
        .then().select("b").one_or_more().skip_till_any_match()
        .where(lambda k, v, ts, st: (0 < v["x"]) & (v["x"] < 8))
        .then().select("c").where(lambda k, v, ts, st: v["x"] >= 8)
        .build()
    )


def straddle(Q):
    return (
        Q().select("a").where(lambda k, v, ts, st: v["x"] == 0)
        .then().select("b").zero_or_more().skip_till_next_match()
        .where(lambda k, v, ts, st: (0 < v["x"]) & (v["x"] < 6))
        .then().select("c").skip_till_next_match()
        .where(lambda k, v, ts, st: v["x"] == 7)
        .build()
    )


def windowed(Q):
    return (
        Q().select("a").where(lambda k, v, ts, st: v["x"] == 1)
        .then().select("b").skip_till_next_match()
        .where(lambda k, v, ts, st: v["x"] == 2)
        .within(5, "ms")
        .build()
    )


def torch_call(Q):
    """A predicate the code generator refuses: it calls a torch function."""
    return (
        Q().select("a").where(lambda k, v, ts, st: torch.abs(v["x"] - 3) < 2)
        .then().select("b").skip_till_next_match()
        .where(lambda k, v, ts, st: v["x"] == 7)
        .build()
    )


def x_events(xs, valid=None, ts_mult=1) -> EventBatch:
    K, T = xs.shape
    i32 = torch.int32
    return EventBatch(
        key=torch.arange(K, dtype=i32)[:, None].expand(K, T),
        value={"x": torch.as_tensor(np.asarray(xs, np.int32))},
        ts=(torch.arange(T, dtype=i32) * ts_mult)[None, :].expand(K, T),
        off=torch.arange(T, dtype=i32)[None, :].expand(K, T),
        valid=(torch.ones((K, T), dtype=torch.bool) if valid is None
               else torch.as_tensor(valid)),
    )


def stock_events(K, T, seed, holes=True) -> EventBatch:
    """``test_scan_kernel.py``'s stock trace: the last two steps and every
    third lane's sixth step are padding."""
    rng = np.random.default_rng(seed)
    values = ts.trace("stock", rng, K, T)
    valid = np.ones((K, T), bool)
    if holes:
        valid[:, -2:] = False
        valid[::3, 5] = False
    i32 = torch.int32
    return EventBatch(
        key=torch.arange(K, dtype=i32)[:, None].expand(K, T),
        value={f: torch.as_tensor(v) for f, v in values.items()},
        ts=(torch.arange(T, dtype=i32) * 2)[None, :].expand(K, T),
        off=torch.arange(T, dtype=i32)[None, :].expand(K, T),
        valid=torch.as_tensor(valid),
    )


def advance(events: EventBatch) -> EventBatch:
    """The next batch of a stream: offsets and time move on."""
    T = events.ts.shape[1]
    return events._replace(off=events.off + T, ts=events.ts + 3 * T)


def port_batch(monkeypatch, builder, K, conf):
    monkeypatch.setenv("CEP_SCAN_KERNEL", "1")
    return BatchMatcher(builder(ts.TQuery), K, EngineConfig(**conf), device="cpu")


def jax_batch(monkeypatch, builder, K, conf):
    monkeypatch.delenv("CEP_SCAN_KERNEL", raising=False)
    monkeypatch.setenv("CEP_WALK_KERNEL", "0")
    return JBatch(builder(ts.JQuery), K, JConfig(**conf))


@pytest.fixture
def scan_calls(monkeypatch):
    """Counts the port's whole-scan calls (``scan_kernel.scan_pass``)."""
    calls = []
    real = scan_kernel.scan_pass

    def spy(*args):
        calls.append(args[0].tag)
        return real(*args)

    monkeypatch.setattr(scan_kernel, "scan_pass", spy)
    return calls


def assert_outputs_equal(j_out, t_out, msg=""):
    for f in j_out._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(j_out, f)), getattr(t_out, f).numpy(),
            err_msg=f"{msg} output {f}",
        )


def scan_case(name):
    """``(builder, config, events, scans)`` of the cases held against
    JAX's ``BatchMatcher``."""
    if name == "stock":
        return ts.stock, CFG, stock_events(8, 12, 3), 1
    if name == "kleene_any":
        xs = np.random.default_rng(7).choice([0, 1, 2, 3, 9, 9], size=(8, 16))
        conf = dict(max_runs=16, slab_entries=32, slab_preds=6, dewey_depth=10,
                    max_walk=12)
        return kleene_any, conf, x_events(xs), 2
    if name == "ver_overflow":
        xs = np.asarray([[0] + [6] * 10 + [1, 6, 7, 6, 6]] * 4)
        conf = dict(CFG, dewey_depth=4, max_walk=12, renorm_versions=False)
        return straddle, conf, x_events(xs), 1
    if name == "enforce_windows":
        xs = np.random.default_rng(13).integers(0, 4, size=(8, 16))
        return windowed, dict(CFG, enforce_windows=True), x_events(xs, ts_mult=3), 1
    assert name == "stock_lazy"
    conf = dict(max_runs=24, slab_entries=96, slab_preds=8, dewey_depth=12,
                max_walk=12, lazy_extraction=True, handle_ring=512)
    return ts.stock, conf, stock_events(4, 16, 5, holes=False), 2


#: The two-tier and attribution modes: an 8-row hot tier (the kleene and
#: lazy stock traces overflow it, so puts demote), stage attribution, and
#: both.
MODES = {
    "two_tier": lambda conf: dict(conf, slab_hot_entries=8),
    "attribution": lambda conf: dict(conf, stage_attribution=True),
    "two_tier+attribution": lambda conf: dict(
        conf, slab_hot_entries=8,
        stage_attribution=True),
}


@pytest.mark.parametrize(
    "name", ["stock", "kleene_any", "ver_overflow", "enforce_windows", "stock_lazy"]
)
def test_scan_path_equals_jax_batch(monkeypatch, scan_calls, name):
    check_scan_path(monkeypatch, scan_calls, name, None)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize(
    "name", ["stock", "kleene_any", "ver_overflow", "enforce_windows", "stock_lazy"]
)
def test_scan_path_modes_equal_jax_batch(monkeypatch, scan_calls, name, mode):
    """The two-tier, attribution and combined instances, eager and lazy:
    every state leaf (the hot-tier counters, ``stage_counts`` and
    ``stage_hops`` among them) and the stage and conjunct reports equal
    JAX's."""
    check_scan_path(monkeypatch, scan_calls, name, mode)


def check_scan_path(monkeypatch, scan_calls, name, mode):
    builder, conf, events, scans = scan_case(name)
    if mode is not None:
        conf = MODES[mode](conf)
    K = events.ts.shape[0]
    jb = jax_batch(monkeypatch, builder, K, conf)
    tb = port_batch(monkeypatch, builder, K, conf)
    assert tb.uses_scan_kernel
    js, tst = jb.init_state(), tb.init_state()
    for i in range(scans):
        js, j_out = jb.scan(js, ts.to_jax(events))
        tst, t_out = tb.scan(tst, events)
        ts.assert_states_equal(js, tst, f"{name} scan {i}")
        assert_outputs_equal(j_out, t_out, f"{name} scan {i}")
        events = advance(events)
    assert tb.uses_scan_kernel and len(scan_calls) == scans
    if name == "ver_overflow":  # the trace really overflows
        assert int(tst.ver_overflows.sum()) > 0
    if conf.get("stage_attribution"):
        assert tb.stage_counters(tst) == jb.stage_counters(js)
        assert int(tst.stage_counts.sum()) > 0 and int(tst.slab.stage_hops.sum()) > 0
    if conf.get("slab_hot_entries") and name in ("kleene_any", "stock_lazy"):
        assert int(tst.slab.demotions.sum()) > 0  # the hot tier overflowed
    if conf.get("lazy_extraction"):
        assert int(tst.hr_count.sum()) > 0
        js, j_d = jb.drain(js)
        tst, t_d = tb.drain(tst)
        ts.assert_states_equal(js, tst, f"{name} after drain")
        j_rows = jdecode.compact_drained(j_d, 4096)
        t_rows = decode.compact_drained(t_d, 4096)
        for a, b in zip(j_rows, t_rows):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert int(t_rows[6]) > 0  # the drain found matches
    else:
        assert int(t_out.count.sum()) >= 0


def canon_state(arrays):
    """``state_arrays`` output with each lane's dead slab storage masked."""
    out = dict(arrays)
    K = arrays["slab/stage"].shape[0]
    lanes = [
        canon_slab(type("S", (), {
            f: arrays[f"slab/{f}"][k] for f in (
                "stage", "off", "refs", "npreds", "pstage", "poff", "pver",
                "pvlen", "full_drops", "pred_drops", "missing", "trunc")
        }))
        for k in range(K)
    ]
    for f in lanes[0]:
        out[f"slab/{f}"] = np.stack([lane[f] for lane in lanes])
    return out


@pytest.mark.parametrize("name", ["strict", "typed_float"])
def test_scan_path_equals_jax_scan_kernel(monkeypatch, name):
    """The port's scan path against JAX's whole-scan kernel itself, in
    interpret mode, at one 128-lane block."""
    builder = {"strict": strict, "typed_float": typed_float}[name]
    K = 128
    rng = np.random.default_rng({"strict": 17, "typed_float": 11}[name])
    xs = rng.integers(0, {"strict": 5, "typed_float": 6}[name], size=(K, 14))
    events = x_events(xs)
    jscan = build_scan(jlower(builder(ts.JQuery)), JConfig(**CFG))
    jscan.interpret = True
    monkeypatch.setenv("CEP_WALK_KERNEL", "0")
    jb = JBatch(builder(ts.JQuery), K, JConfig(**CFG))
    tb = port_batch(monkeypatch, builder, K, CFG)
    j_state, j_out = jscan(jb.init_state(), ts.to_jax(events))
    t_state, t_out = tb.scan(tb.init_state(), events)
    assert tb.uses_scan_kernel
    assert_outputs_equal(j_out, t_out, name)
    a, b = canon_state(state_arrays(j_state)), canon_state(state_arrays(t_state))
    assert a.keys() == b.keys()
    for leaf in a:
        np.testing.assert_array_equal(a[leaf], b[leaf], err_msg=f"{name} {leaf}")
    assert bool((t_state.id_pos >= 0).any())  # runs took events


def test_jax_state_continues_on_port_scan_path(monkeypatch):
    """A JAX scan's state, carried across by ``convert.to_torch``, continues
    on the port's scan path exactly as it continues in JAX."""
    builder, conf, events, _ = scan_case("kleene_any")
    K = events.ts.shape[0]
    jb = jax_batch(monkeypatch, builder, K, conf)
    js, _ = jb.scan(jb.init_state(), ts.to_jax(events))
    tb = port_batch(monkeypatch, builder, K, conf)
    tst = to_torch(js)
    nxt = advance(events)
    js, j_out = jb.scan(js, ts.to_jax(nxt))
    tst, t_out = tb.scan(tst, nxt)
    assert tb.uses_scan_kernel
    ts.assert_states_equal(js, tst, "continued")
    assert_outputs_equal(j_out, t_out, "continued")


def test_torch_call_falls_back_to_per_step(monkeypatch, scan_calls, caplog):
    """A predicate that calls ``torch.abs`` cannot be traced: the first
    scan logs the fallback, ``uses_scan_kernel`` turns False, and the
    per-step path's results equal JAX's."""
    xs = np.random.default_rng(2).integers(0, 9, size=(4, 12))
    events = x_events(xs)
    monkeypatch.setenv("CEP_WALK_KERNEL", "0")
    jb = JBatch(_jax_torch_call(), 4, JConfig(**CFG))
    tb = port_batch(monkeypatch, torch_call, 4, CFG)
    assert tb.uses_scan_kernel
    with caplog.at_level(logging.WARNING):
        tst, t_out = tb.scan(tb.init_state(), events)
    assert not tb.uses_scan_kernel and not scan_calls
    assert "falling back to the per-step path" in caplog.text
    js, j_out = jb.scan(jb.init_state(), ts.to_jax(events))
    ts.assert_states_equal(js, tst, "fallback")
    assert_outputs_equal(j_out, t_out, "fallback")
    tst, _ = tb.scan(tst, advance(events))  # stays on the per-step path
    assert not tb.uses_scan_kernel and not scan_calls


def _jax_torch_call():
    """``torch_call``'s pattern for the JAX package, with ``jnp.abs``."""
    return (
        ts.JQuery().select("a").where(lambda k, v, ts_, st: jnp.abs(v["x"] - 3) < 2)
        .then().select("b").skip_till_next_match()
        .where(lambda k, v, ts_, st: v["x"] == 7)
        .build()
    )


@pytest.mark.parametrize("where", ["generate", "scan_pass"])
def test_other_failures_propagate(monkeypatch, where):
    """Only ``LoweringError`` selects the per-step path: a ``RuntimeError``
    in code generation or in the kernel call (a failed build or launch)
    propagates and leaves the switch on."""
    def boom(*args, **kwargs):
        raise RuntimeError("injected")

    # A source an earlier matcher of the process generated comes from the
    # built-program cache (utils/tracecache.py) without a call to generate.
    monkeypatch.setenv("CEP_TRACE_CACHE", "0")
    tb = port_batch(monkeypatch, strict, 2, CFG)
    target = scan_codegen if where == "generate" else scan_kernel
    monkeypatch.setattr(target, where, boom)
    with pytest.raises(RuntimeError, match="injected"):
        tb.scan(tb.init_state(), x_events(np.ones((2, 4), np.int32)))
    assert tb.uses_scan_kernel


@pytest.mark.parametrize("mode", ["0", "", "2"])
def test_switch_off_uses_per_step_path(monkeypatch, scan_calls, mode):
    monkeypatch.setenv("CEP_SCAN_KERNEL", mode)
    tb = BatchMatcher(strict(ts.TQuery), 2, EngineConfig(**CFG), device="cpu")
    assert not tb.uses_scan_kernel
    tb.scan(tb.init_state(), x_events(np.ones((2, 4), np.int32)))
    assert not scan_calls


def kernel_equals_plain(dev, kernel=None, base=None):
    """Every instance of the whole-scan kernel (eager or lazy x single or
    two-tier x with or without attribution; and tiered: eager, lazy,
    two-tier + attribution), in both placements of the pointer rows,
    against its plain version on ``dev``, at ``base`` (default ``CFG``);
    ``kernel`` (default: the CUDA kernel) takes the wrapper's arguments."""
    base = base or CFG
    from kafkastreams_cep_tpu_torch.parallel.tiered import TieredBatchMatcher

    kernel = kernel or scan_kernel.scan_pass_kernel
    K, T = 37, 24

    def on_dev(events):
        return EventBatch(*(
            {f: v.to(dev) for f, v in x.items()} if isinstance(x, dict) else x.to(dev)
            for x in events))

    def check(got, want, msg):
        assert len(got) == len(want)
        for a, b in zip(state_arrays(got[0]).values(), state_arrays(want[0]).values()):
            np.testing.assert_array_equal(a, b, err_msg=msg)
        for a, b in zip(got[1:], want[1:]):
            for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy(), err_msg=msg)

    events = on_dev(stock_events(K, T, 9))
    for lazy, hot, attr in itertools.product((False, True), repeat=3):
        conf = dict(base, slab_hot_entries=8 if hot else 0, stage_attribution=attr)
        if lazy:
            conf.update(lazy_extraction=True, handle_ring=64)
        tb = BatchMatcher(ts.stock(ts.TQuery), K, EngineConfig(**conf), device=dev)
        source = scan_codegen.generate(tb.matcher.tables, events.value)
        cfg = tb.matcher.config
        want = scan_kernel.scan_pass_plain(tb.phases, tb.init_state(), events)
        for pv in (True, False):
            got = kernel(source, cfg, tb.init_state(), events, pv_shared=pv)
            check(got, want, f"{scan_kernel.mode_name(cfg)}, pv_shared={pv}")
    codes = np.random.default_rng(11).choice(4, size=(K, T), p=[0.3, 0.3, 0.3, 0.1])
    letters = on_dev(EventBatch(
        key=torch.zeros((K, T), dtype=torch.int32),
        value=torch.as_tensor(codes.astype(np.int32)),
        ts=torch.arange(T, dtype=torch.int32)[None, :].expand(K, T) + 1000,
        off=torch.arange(T, dtype=torch.int32)[None, :].expand(K, T),
        valid=torch.ones((K, T), dtype=torch.bool)))
    for extra in ({}, dict(lazy_extraction=True, handle_ring=64),
                  dict(slab_hot_entries=8, stage_attribution=True)):
        tm = TieredBatchMatcher(prefix_n_minus_1(ts.TQuery), K,
                                EngineConfig(**base, tiering=True, **extra), device=dev)
        source = scan_codegen.generate(tm.matcher.tables, letters.value)
        eng, carry = tm.init_state()
        _, feed = tm._prefix.scan(carry, letters)
        promo = (tm._promote, feed)
        want = scan_kernel.scan_pass_plain(tm.inner.phases, eng, letters, promo=promo)
        assert int(want[2].sum()) > 0
        for pv in (True, False):
            got = kernel(source, tm.matcher.config, eng, letters, promo, pv_shared=pv)
            check(got, want, f"{scan_kernel.mode_name(tm.matcher.config, True)}, pv_shared={pv}")


@pytest.mark.cuda
def test_kernel_equals_plain_on_gpu(monkeypatch):
    """On a GPU: the CUDA kernel equals its plain version bit for bit in
    every instance and both placements of the pointer rows
    (``chip_smoke.py`` runs the full set of cases)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    kernel_equals_plain(torch.device("cuda"))


#: The wide instances' config: pointer lists and versions past 32.
WIDE_CFG = dict(CFG, slab_preds=40, dewey_depth=48)


@pytest.mark.cuda
def test_wide_kernel_equals_plain_on_gpu():
    """On a GPU: every wide instance (``slab_preds``/``dewey_depth`` above
    32) equals its plain version bit for bit, as the narrow ones do."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    kernel_equals_plain(torch.device("cuda"), base=WIDE_CFG)


def test_tiered_scan_path_equals_jax_tiered_scan_kernel(monkeypatch):
    """The port's tiered whole-scan path (``promo=``; its plain version on
    the CPU) against JAX's tiered whole-scan kernel (``build_scan(...,
    promotion=p)``, interpret mode) at one 128-lane block, T=8, on
    ``tests/test_tiering.py``'s ``KCFG``: outputs, promotions and every
    state leaf (slab storage behind ``npreds`` masked).  The pattern has no
    fold, so a lane the port's per-lane gate leaves unstepped equals one the
    Pallas kernel's per-block gate steps through an empty queue."""
    from test_tiering import KCFG, _kernel_trace, prefix_n_minus_1 as j_pn1
    from kafkastreams_cep_tpu.parallel.tiered import TieredBatchMatcher as JTiered
    from kafkastreams_cep_tpu_torch.parallel.tiered import TieredBatchMatcher

    K, T = 128, 8
    j_ev = _kernel_trace(K, T, 9)
    t_ev = EventBatch(*(torch.as_tensor(np.array(x)) for x in j_ev))
    conf = dict(dataclasses.asdict(KCFG), tiering=True)
    monkeypatch.setenv("CEP_WALK_KERNEL", "0")
    monkeypatch.setenv("CEP_SCAN_KERNEL", "interpret")
    jt = JTiered(j_pn1(), K, JConfig(**conf))
    monkeypatch.setenv("CEP_SCAN_KERNEL", "1")
    tt = TieredBatchMatcher(prefix_n_minus_1(ts.TQuery), K, EngineConfig(**conf),
                            device="cpu")
    assert jt.uses_scan_kernel and tt.uses_scan_kernel
    js, j_out = jt.scan(jt.init_state(), j_ev)
    t_s, t_out = tt.scan(tt.init_state(), t_ev)
    assert_outputs_equal(j_out, t_out, "tiered")
    a, b = state_arrays(js), state_arrays(t_s)
    assert a.keys() == b.keys()
    eng = lambda arrays: canon_state(
        {k[len("engine/"):]: v for k, v in arrays.items() if k.startswith("engine/")})
    ea, eb = eng(a), eng(b)
    for leaf in ea:
        np.testing.assert_array_equal(ea[leaf], eb[leaf], err_msg=f"tiered {leaf}")
    for leaf in (k for k in a if k.startswith("carry/")):
        np.testing.assert_array_equal(a[leaf], b[leaf], err_msg=f"tiered {leaf}")
    assert int(t_s.carry.promotions.sum()) > 0 and int((t_out.count > 0).sum()) > 0


def prefix_n_minus_1(Q):
    """``tests/test_tiering.py``'s prefix_n_minus_1: strict A, B, C, then
    skip-till-next D (codes 0..3)."""
    return (
        Q().select("pa").where(ts.value_is(0))
        .then().select("pb").where(ts.value_is(1))
        .then().select("pc").where(ts.value_is(2))
        .then().select("sd").skip_till_next_match().where(ts.value_is(3))
        .build()
    )
