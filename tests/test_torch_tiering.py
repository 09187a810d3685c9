"""The port's tiered configuration (``EngineConfig.tiering``) against the JAX
package, after ``tests/test_tiering.py`` and at its sizes.

Every case feeds the same numpy-seeded events to the JAX package (its
``TieredBatchMatcher`` on the jnp path, ``CEP_WALK_KERNEL=0``) and to the
port on the CPU, and holds them equal, bit for bit:

* the tiering plans of the whole corpus (prefix 0, 1, 2, 3, n-1 and the
  whole-pattern stencil), capped under lazy extraction, refused under
  ``enforce_windows`` with a window;
* ``TieredBatchMatcher`` over ragged multi-batch scans with sweeps: every
  state leaf (engine and stencil carry), the match grids, the counters and
  the tier counters; and the grids and counters of the untiered engine;
* the chunk gate: any ``gate_chunk`` gives the same results, and the
  per-step path reads one flag per chunk on the host (``gate_flag``) while
  the whole-scan path (``CEP_SCAN_KERNEL=1``: traced to C++, then the plain
  tiered scan on the CPU) reads none and dispatches once a batch;
* the processor's emission order, eager and lazy, checkpoints with a live
  stencil carry cross-loaded both ways, the stencil tier, zero tier
  counters untiered, the lazy-chain conjunct order and its profile input.

The CUDA kernel's promotion phase is held against its plain version on the
card by ``chip_smoke.py``.
"""

import dataclasses
import logging
import zlib

import numpy as np
import pytest
import torch

import torch_scenarios as ts
from kafkastreams_cep_tpu.compiler.tables import lower as jlower
from kafkastreams_cep_tpu.compiler.tiering import (
    apply_lazy_order as j_apply_lazy_order,
    plan_tiering as j_plan_tiering,
)
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.engine import TPUMatcher as JMatcher
from kafkastreams_cep_tpu.parallel.tiered import TieredBatchMatcher as JTiered
from kafkastreams_cep_tpu.pattern.predicate import and_ as j_and, hint as j_hint
from kafkastreams_cep_tpu.runtime import CEPProcessor as JProcessor
from kafkastreams_cep_tpu.runtime import Record as JRecord
from kafkastreams_cep_tpu.runtime.checkpoint import (
    restore_processor as j_restore,
    save_checkpoint as j_save,
)
from kafkastreams_cep_tpu_torch import BatchMatcher, CEPProcessor, EngineConfig, Record, TPUMatcher
from kafkastreams_cep_tpu_torch.compiler.tables import lower
from kafkastreams_cep_tpu_torch.compiler.tiering import (
    TIER_HYBRID,
    TIER_NFA,
    TIER_STENCIL,
    apply_lazy_order,
    check_no_prune,
    order_conjuncts,
    plan_tiering,
    strict_prefix_len,
)
from kafkastreams_cep_tpu_torch.engine.matcher import TIER_COUNTER_NAMES, EventBatch
from kafkastreams_cep_tpu_torch.ops import scan_kernel
from kafkastreams_cep_tpu_torch.parallel import tiered as tiered_mod
from kafkastreams_cep_tpu_torch.parallel.tiered import TieredBatchMatcher
from kafkastreams_cep_tpu_torch.pattern.predicate import and_, hint
from kafkastreams_cep_tpu_torch.runtime.checkpoint import restore_processor, save_checkpoint

A, B, C, D, X = ts.A, ts.B, ts.C, ts.D, ts.X

# tests/test_tiering.py's configs: loss-free on every trace below.
CFG = dict(max_runs=32, slab_entries=96, slab_preds=12, dewey_depth=20, max_walk=12)
TCFG = dict(CFG, tiering=True)
DROP_COUNTERS = ("run_drops", "slab_full_drops", "slab_pred_drops", "slab_trunc",
                 "walk_collisions", "handle_overflows")


def prefix0(Q):
    """Strict-prefix length 0: a fold on the first stage blocks it."""
    return (
        Q().select("a").where(ts.value_is(A))
        .fold("cnt", lambda k, v, c: c + 1)
        .then().select("b").skip_till_next_match().where(ts.value_is(B))
        .build()
    )


def prefix_n_minus_1(Q):
    """Strict A, B, C then skip-till-next D: prefix 3 of n=4."""
    return (
        Q().select("pa").where(ts.value_is(A))
        .then().select("pb").where(ts.value_is(B))
        .then().select("pc").where(ts.value_is(C))
        .then().select("sd").skip_till_next_match().where(ts.value_is(D))
        .build()
    )


def windowed(Q):
    return (
        Q().select("a").where(ts.value_is(A))
        .then().select("b").skip_till_next_match().where(ts.value_is(B))
        .within(60, "s")
        .build()
    )


def conjunct_pattern(Q, and_f, hint_f):
    """Stage predicates built expensive-first, so the ordering has work."""
    expensive = hint_f(lambda k, v, ts_, st: (v * v + 3 * v) % 97 != 11, cost=100.0)
    cheap_a = hint_f(lambda k, v, ts_, st: v == A, cost=1.0)
    cheap_b = hint_f(lambda k, v, ts_, st: v <= B, cost=1.0)
    return (
        Q().select("first").where(and_f(cheap_a, expensive))
        .then().select("second").where(and_f(expensive, cheap_b))
        .then().select("third").skip_till_next_match().where(and_f(expensive, cheap_a))
        .build()
    )


# (name, make_pattern, tier, prefix length): tests/test_tiering.py's CORPUS.
CORPUS = [
    ("p0_fold", prefix0, TIER_NFA, 0),
    ("p1_skip_next", ts.skip_till_next, TIER_HYBRID, 1),
    ("p2_skip_any", ts.skip_till_any, TIER_HYBRID, 2),
    ("p3_kleene", ts.kleene_one_or_more, TIER_HYBRID, 3),
    ("pn1_strict3_skip", prefix_n_minus_1, TIER_HYBRID, 3),
    ("pn_strict3", ts.strict3, TIER_STENCIL, 3),
]
IDS = [c[0] for c in CORPUS]


def batch_of(codes, offs, valid, ts0=1000) -> EventBatch:
    K, T = np.asarray(codes).shape
    return EventBatch(
        key=torch.zeros((K, T), dtype=torch.int32),
        value=torch.as_tensor(np.asarray(codes, np.int32)),
        ts=torch.as_tensor((ts0 + np.asarray(offs)).astype(np.int32)),
        off=torch.as_tensor(np.asarray(offs, np.int32)),
        valid=torch.as_tensor(np.asarray(valid, bool)),
    )


def random_codes(K, total, seed):
    rng = np.random.default_rng(seed)
    return rng.choice(5, size=(K, total), p=[0.3, 0.25, 0.2, 0.2, 0.05]), rng


def ragged_batches(codes, rng, chunk):
    """``[K, total]`` codes as ragged valid-prefix batches."""
    K, total = codes.shape
    consumed = np.zeros(K, dtype=int)
    out = []
    while consumed.min() < total:
        counts = rng.integers(chunk // 2, chunk + 1, size=K)
        vals = np.zeros((K, chunk), np.int64)
        offs = np.zeros((K, chunk), np.int64)
        valid = np.zeros((K, chunk), bool)
        for k in range(K):
            c = min(int(counts[k]), total - consumed[k])
            vals[k, :c] = codes[k, consumed[k]:consumed[k] + c]
            offs[k, :c] = np.arange(consumed[k], consumed[k] + c)
            valid[k, :c] = True
            consumed[k] += c
        out.append(batch_of(vals, offs, valid))
    return out


def grid(out):
    """StepOutput -> ``{(k, t): [(stages, offs), ...]}`` in run-row order
    (row indices may differ between tiered and untiered engines, their
    order may not)."""
    st, of, ct = (np.asarray(x) for x in (out.stage, out.off, out.count))
    res = {}
    for k, t, r in zip(*np.nonzero(ct)):
        n = int(ct[k, t, r])
        res.setdefault((int(k), int(t)), []).append(
            (tuple(st[k, t, r, :n]), tuple(of[k, t, r, :n])))
    return res


@pytest.fixture
def jnp_path(monkeypatch):
    """The JAX package on its jnp path, both switches off, with an empty
    trace cache: its tiered matcher keys cached programs by pattern and
    config but not by lane count, so a program traced at another K could
    be reused."""
    from kafkastreams_cep_tpu.utils import tracecache

    monkeypatch.setenv("CEP_WALK_KERNEL", "0")
    monkeypatch.delenv("CEP_SCAN_KERNEL", raising=False)
    tracecache.clear()


def corpus_trace(name):
    total = 24 if name == "p2_skip_any" else 36
    codes, rng = random_codes(6, total, seed=zlib.crc32(name.encode()))
    return ragged_batches(codes, rng, 12)


# -- plans ---------------------------------------------------------------------

@pytest.mark.parametrize("name,make_pattern,tier,p", CORPUS, ids=IDS)
def test_plans_equal_jax(name, make_pattern, tier, p):
    jt, tt = jlower(make_pattern(ts.JQuery)), lower(make_pattern(ts.TQuery))
    assert strict_prefix_len(tt) == p
    lazy = dict(CFG, lazy_extraction=True, handle_ring=64)
    short = dict(CFG, max_walk=2, dewey_depth=2)
    for conf in (CFG, lazy, short):
        want = j_plan_tiering(jt, JConfig(**conf))
        got = plan_tiering(tt, EngineConfig(**conf))
        assert got.describe() == want.describe() == dataclasses.asdict(want), conf
    assert plan_tiering(tt, EngineConfig(**CFG)).tier == tier


def test_no_prune_refuses_windowed_prefix():
    tables = lower(windowed(ts.TQuery))
    enforcing = EngineConfig(**dict(CFG, enforce_windows=True))
    assert check_no_prune(tables, EngineConfig(**CFG)) is None
    assert "window" in check_no_prune(tables, enforcing)
    assert plan_tiering(tables, EngineConfig(**CFG)).tier == TIER_HYBRID
    plan = plan_tiering(tables, enforcing)
    want = j_plan_tiering(jlower(windowed(ts.JQuery)), JConfig(**dict(CFG, enforce_windows=True)))
    assert plan.tier == TIER_NFA and "no-prune" in plan.reason
    assert plan.describe() == want.describe()


# -- the matcher ---------------------------------------------------------------

@pytest.mark.parametrize("name,make_pattern,tier,p", CORPUS, ids=IDS)
def test_tiered_matcher_equals_jax(jnp_path, name, make_pattern, tier, p):
    """Ragged multi-batch scans with a sweep after each: every state leaf
    equals JAX's tiered matcher, the grids and counters equal the untiered
    engine's, and the tier counters add up."""
    K = 6
    jt = JTiered(make_pattern(ts.JQuery), K, JConfig(**TCFG))
    tt = TieredBatchMatcher(make_pattern(ts.TQuery), K, EngineConfig(**TCFG), device="cpu")
    ub = BatchMatcher(make_pattern(ts.TQuery), K, EngineConfig(**CFG), device="cpu")
    assert tt.plan.describe() == jt.plan.describe() and tt.plan.tier == tier
    js, tst, us = jt.init_state(), tt.init_state(), ub.init_state()
    ts.assert_states_equal(js, tst, f"{name} init")
    n = 0
    for i, ev in enumerate(corpus_trace(name)):
        js, jo = jt.scan(js, ts.to_jax(ev))
        tst, to = tt.scan(tst, ev)
        us, uo = ub.scan(us, ev)
        ts.assert_states_equal(js, tst, f"{name} scan {i}")
        for f in to._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jo, f)), getattr(to, f).numpy())
        assert grid(to) == grid(uo), f"{name} scan {i}"
        n += sum(len(v) for v in grid(to).values())
        js, tst, us = jt.sweep(js), tt.sweep(tst), ub.sweep(us)
        ts.assert_states_equal(js, tst, f"{name} sweep {i}")
    assert tt.counters(tst) == ub.counters(us) == jt.counters(js)
    assert all(tt.counters(tst)[c] == 0 for c in DROP_COUNTERS)
    tc = tt.tier_counters(tst)
    assert tc == jt.tier_counters(js)
    if tier == TIER_NFA:
        assert tc == {c: 0 for c in TIER_COUNTER_NAMES}
    elif tier == TIER_STENCIL:
        assert tc["prefix_fires"] == n > 0 and tc["tier_promotions"] == 0
    else:
        assert tc["prefix_events_screened"] > 0
        assert tc["prefix_fires"] == tc["tier_promotions"]
    assert (tt.scan_calls, tt.gate_chunks) == (jt.scan_calls, jt.gate_chunks)
    assert tt.nfa_dispatches == jt.nfa_dispatches


@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_gate_chunk_is_pure_scheduling(jnp_path, chunk):
    """Any gate_chunk gives the untiered engine's matches and counters;
    only the gate telemetry differs (ceil(T/C) chunks offered a scan)."""
    K = 6
    codes, rng = random_codes(K, 24, seed=23)
    batches = ragged_batches(codes, rng, 16)
    ref = BatchMatcher(ts.skip_till_any(ts.TQuery), K, EngineConfig(**CFG), device="cpu")
    tt = TieredBatchMatcher(ts.skip_till_any(ts.TQuery), K,
                            EngineConfig(**dict(TCFG, gate_chunk=chunk)), device="cpu")
    jt = JTiered(ts.skip_till_any(ts.JQuery), K, JConfig(**dict(TCFG, gate_chunk=chunk)))
    sr, st, sj = ref.init_state(), tt.init_state(), jt.init_state()
    for ev in batches:
        sr, o_r = ref.scan(sr, ev)
        st, o_t = tt.scan(st, ev)
        sj, _ = jt.scan(sj, ts.to_jax(ev))
        assert grid(o_t) == grid(o_r)
        sr, st, sj = ref.sweep(sr), tt.sweep(st), jt.sweep(sj)
    ts.assert_states_equal(sj, st, f"gate_chunk={chunk}")
    assert tt.counters(st) == ref.counters(sr)
    assert tt.gate_chunks == len(batches) * -(-16 // chunk) == jt.gate_chunks
    assert tt.nfa_dispatches == jt.nfa_dispatches <= tt.gate_chunks


def test_chunk_gate_reads_one_flag_per_chunk(jnp_path, monkeypatch):
    """The per-step path's only host read is the chunk gate, one per chunk;
    the whole-scan path reads none and dispatches once a batch."""
    reads = []
    real = tiered_mod.gate_flag

    def counting(x):
        reads.append(1)
        return real(x)

    monkeypatch.setattr(tiered_mod, "gate_flag", counting)
    K = 4
    codes, rng = random_codes(K, 48, seed=7)
    batches = ragged_batches(codes, rng, 16)
    tt = TieredBatchMatcher(ts.skip_till_any(ts.TQuery), K, EngineConfig(**TCFG),
                            device="cpu")
    assert tt.plan.tier == TIER_HYBRID and not tt.uses_scan_kernel
    st = tt.init_state()
    for ev in batches:
        st, _ = tt.scan(st, ev)
    assert len(reads) == tt.gate_chunks == len(batches) * -(-16 // TCFG.get("gate_chunk", 32))
    monkeypatch.setenv("CEP_SCAN_KERNEL", "1")
    tk = TieredBatchMatcher(ts.skip_till_any(ts.TQuery), K, EngineConfig(**TCFG),
                            device="cpu")
    reads.clear()
    sk = tk.init_state()
    for ev in batches:
        sk, _ = tk.scan(sk, ev)
    assert tk.uses_scan_kernel and not reads
    assert tk.nfa_dispatches == len(batches) and tk.gate_chunks == 0
    assert tk.tier_counters(sk) == tt.tier_counters(st)


@pytest.mark.parametrize("name", ["p1_skip_next", "p2_skip_any", "p3_kleene",
                                  "pn1_strict3_skip"])
def test_scan_kernel_path_equals_jax_chunked(jnp_path, monkeypatch, name):
    """``CEP_SCAN_KERNEL=1`` on the hybrid corpus: each batch is one tiered
    whole scan (the plain version of the kernel on the CPU, after the
    pattern was traced to C++), with the grids, counters and tier counters
    of JAX's chunk-gated path.  The per-lane gate leaves dead run rows that
    JAX's chunk gate would have reset, so states are not compared."""
    make_pattern = dict((c[0], c[1]) for c in CORPUS)[name]
    K = 6
    calls = []
    real = scan_kernel.scan_pass

    def spy(*args, **kwargs):
        calls.append(kwargs.get("promo") is not None)
        return real(*args, **kwargs)

    monkeypatch.setattr(scan_kernel, "scan_pass", spy)
    jt = JTiered(make_pattern(ts.JQuery), K, JConfig(**TCFG))
    monkeypatch.setenv("CEP_SCAN_KERNEL", "1")
    tk = TieredBatchMatcher(make_pattern(ts.TQuery), K, EngineConfig(**TCFG), device="cpu")
    assert tk.uses_scan_kernel
    js, sk = jt.init_state(), tk.init_state()
    batches = corpus_trace(name)
    for ev in batches:
        js, jo = jt.scan(js, ts.to_jax(ev))
        sk, ko = tk.scan(sk, ev)
        assert grid(ko) == grid(jo)
        js, sk = jt.sweep(js), tk.sweep(sk)
    assert tk.counters(sk) == jt.counters(js)
    assert tk.tier_counters(sk) == jt.tier_counters(js)
    assert tk.tier_counters(sk)["tier_promotions"] > 0
    assert calls == [True] * len(batches) and tk.uses_scan_kernel
    assert tk.nfa_dispatches == len(batches) and tk.gate_chunks == 0


def test_hybrid_lowering_error_falls_back(jnp_path, monkeypatch, caplog):
    """A prefix-tier pattern the code generator refuses (a predicate calling
    torch) swaps the tiered whole scan for the per-step path, logged."""
    def torch_call(Q, f):
        return (
            Q().select("a").where(lambda k, v, ts_, st: f(v - 3) < 1)
            .then().select("b").skip_till_next_match().where(ts.value_is(D))
            .build()
        )

    monkeypatch.setenv("CEP_SCAN_KERNEL", "1")
    tk = TieredBatchMatcher(torch_call(ts.TQuery, torch.abs), 4, EngineConfig(**TCFG),
                            device="cpu")
    assert tk.plan.tier == TIER_HYBRID and tk.uses_scan_kernel
    codes, rng = random_codes(4, 24, seed=5)
    with caplog.at_level(logging.WARNING):
        for ev in ragged_batches(codes, rng, 12):
            tk.scan(tk.init_state(), ev)
    assert not tk.uses_scan_kernel
    assert "chunk-gated per-step path" in caplog.text
    assert tk.gate_chunks > 0


def test_reordered_hybrid_stays_on_scan_kernel(monkeypatch):
    """A pattern the lazy-chain ordering rebuilt still traces to C++: the
    hybrid tier keeps the whole-scan kernel, with the same matches as the
    untiered engine."""
    monkeypatch.setenv("CEP_SCAN_KERNEL", "1")
    pat = conjunct_pattern(ts.TQuery, and_, hint)
    tk = TieredBatchMatcher(pat, 4, EngineConfig(**TCFG), device="cpu")
    assert any(r["reordered"] for r in tk.lazy_order.values())
    assert tk.plan.tier == TIER_HYBRID and tk.plan.prefix_len == 2
    monkeypatch.delenv("CEP_SCAN_KERNEL")
    ub = BatchMatcher(pat, 4, EngineConfig(**CFG), device="cpu")
    sk, su = tk.init_state(), ub.init_state()
    xs = np.random.default_rng(3).choice([A, B, C, 96], size=(4, 24))
    xs[0, 3:6] = [A, B, A]
    ev = batch_of(xs, np.broadcast_to(np.arange(24), (4, 24)), np.ones((4, 24), bool))
    sk, ko = tk.scan(sk, ev)
    su, uo = ub.scan(su, ev)
    assert tk.uses_scan_kernel and grid(ko) == grid(uo) and grid(uo)


# -- the processor -------------------------------------------------------------

def feed(proc, codes, lo, hi, chunk, Rec):
    out = []
    for start in range(lo, hi, chunk):
        recs = [Rec(key=k, value=int(codes[k, t]), timestamp=1000 + t)
                for t in range(start, min(start + chunk, hi))
                for k in range(codes.shape[0])]
        out.extend(proc.process(recs))
    return out


def canon(matches):
    return [(k, [(stg, [e.offset for e in evs]) for stg, evs in s.as_map().items()])
            for k, s in matches]


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_processor_stream_equals_untiered_and_jax(jnp_path, lazy):
    """The tiered processor forwards the untiered processor's (key,
    Sequence) stream, same-event tie-breaks included, as the JAX tiered
    processor does; its snapshot carries the tier counters and plan."""
    K = 4
    codes, _ = random_codes(K, 36, seed=77 if not lazy else 13)
    extra = dict(lazy_extraction=True, handle_ring=64) if lazy else {}
    kw = dict(drain_interval=3) if lazy else {}
    make_pattern = ts.skip_till_any if not lazy else ts.strict3
    streams = []
    for conf, Proc, Rec, Q, dev in (
        (CFG, CEPProcessor, Record, ts.TQuery, dict(device="cpu")),
        (TCFG, CEPProcessor, Record, ts.TQuery, dict(device="cpu")),
        (TCFG, JProcessor, JRecord, ts.JQuery, {}),
    ):
        Config = EngineConfig if Proc is CEPProcessor else JConfig
        proc = Proc(make_pattern(Q), K, Config(**conf, **extra), **kw, **dev)
        got = feed(proc, codes, 0, 36, 12, Rec)
        if lazy:
            got += proc.flush()
        streams.append(canon(got))
        if conf is TCFG and Proc is CEPProcessor:
            tproc = proc
    assert len(streams[0]) > 1
    assert streams[0] == streams[1] == streams[2]
    snap = tproc.metrics_snapshot()
    assert snap["prefix_fires"] > 0
    assert snap["tier_plan"]["tier"] == TIER_HYBRID
    assert all(snap[c] == 0 for c in DROP_COUNTERS)


def test_stencil_tier_through_processor(jnp_path):
    """strict3 under tiering takes the stencil tier and emits the untiered
    stream; the NFA engine only ticks step_seq."""
    K = 4
    codes, _ = random_codes(K, 36, seed=21)
    pu = CEPProcessor(ts.strict3(ts.TQuery), K, EngineConfig(**CFG), device="cpu")
    pt = CEPProcessor(ts.strict3(ts.TQuery), K, EngineConfig(**TCFG), device="cpu")
    assert pt.batch.plan.tier == TIER_STENCIL
    mu = canon(feed(pu, codes, 0, 36, 12, Record))
    mt = canon(feed(pt, codes, 0, 36, 12, Record))
    assert mu and mu == mt
    assert int(pt.state.engine.step_seq.min()) == pt._step_base


def planted_codes(K, total):
    """Noise with full occurrences planted so a prefix straddles the batch
    (and checkpoint) boundary at t=29/30."""
    codes = np.full((K, total), X, dtype=np.int64)
    for k in range(K):
        codes[k, 5], codes[k, 6], codes[k, 7], codes[k, 11] = A, B, C, D
        codes[k, 28], codes[k, 29], codes[k, 30], codes[k, 34] = A, B, C, D
    return codes


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_with_live_carry_cross_loads(jnp_path, tmp_path, writer):
    """A prefix straddling the snapshot still promotes after restore, in
    either package, whichever wrote it: the carry is durable state."""
    K = 3
    codes = planted_codes(K, 50)
    path = str(tmp_path / "ck")
    if writer == "port":
        proc = CEPProcessor(prefix_n_minus_1(ts.TQuery), K, EngineConfig(**TCFG),
                            device="cpu")
        feed(proc, codes, 0, 30, 10, Record)
        assert bool(proc.state.carry.bools.any())  # a live partial prefix
        save_checkpoint(proc, path)
        base = proc._step_base
        cont = canon(feed(proc, codes, 30, 50, 10, Record))
    else:
        proc = JProcessor(prefix_n_minus_1(ts.JQuery), K, JConfig(**TCFG))
        feed(proc, codes, 0, 30, 10, JRecord)
        j_save(proc, path)
        base = proc._step_base
        cont = canon(feed(proc, codes, 30, 50, 10, JRecord))
    port = restore_processor(prefix_n_minus_1(ts.TQuery), path, device="cpu")
    jax_ = j_restore(prefix_n_minus_1(ts.JQuery), path)
    ts.assert_states_equal(jax_.state, port.state, f"restored from {writer}")
    assert port._step_base == jax_._step_base == base
    rest = canon(feed(port, codes, 30, 50, 10, Record))
    assert rest == cont == canon(feed(jax_, codes, 30, 50, 10, JRecord))
    assert any(("pa", [28]) in m and ("sd", [34]) in m for _, m in rest)
    assert port.tier_counters() == jax_.tier_counters()


def test_event_gc_keeps_partial_prefix_events():
    """A host event sweep after every batch keeps the events of a partial
    prefix held in the stencil carry: a prefix straddling the sweep still
    decodes, and the stream is the untiered one."""
    K = 3
    codes = planted_codes(K, 50)
    streams = []
    for conf in (CFG, TCFG):
        proc = CEPProcessor(prefix_n_minus_1(ts.TQuery), K, EngineConfig(**conf),
                            gc_events_interval=1, device="cpu")
        streams.append(canon(feed(proc, codes, 0, 50, 10, Record)))
    assert streams[0] == streams[1]
    assert any(("pa", [28]) in m and ("sd", [34]) in m for _, m in streams[1])


def test_untiered_tier_counters_are_zero():
    K = 4
    b = BatchMatcher(ts.strict3(ts.TQuery), K, EngineConfig(**CFG), device="cpu")
    s, _ = b.scan(b.init_state(), batch_of(
        np.zeros((K, 4)), np.broadcast_to(np.arange(4), (K, 4)), np.ones((K, 4), bool)))
    snap = b.metrics_snapshot(s)
    proc = CEPProcessor(ts.strict3(ts.TQuery), K, EngineConfig(**CFG), device="cpu")
    for n in TIER_COUNTER_NAMES:
        assert snap[n] == 0 and proc.tier_counters()[n] == 0
    assert "tier_plan" not in proc.metrics_snapshot()


def test_tpu_matcher_ignores_tiering(jnp_path):
    """``TPUMatcher`` (and ``BatchMatcher`` over it) does not route: under
    tiering=True it is the untiered engine, as in the JAX package."""
    from kafkastreams_cep_tpu.parallel.batch import BatchMatcher as JBatch, broadcast_state

    conf = dict(TCFG, max_runs=8, slab_entries=24)
    tm = TPUMatcher(ts.strict3(ts.TQuery), EngineConfig(**conf), device="cpu")
    jm = JMatcher(ts.strict3(ts.JQuery), JConfig(**conf))
    ts.assert_states_equal(broadcast_state(jm.init_state(), 3), tm.init_state(3),
                           "tiering=True")
    tb = BatchMatcher(ts.strict3(ts.TQuery), 3, EngineConfig(**conf), device="cpu")
    jb = JBatch(ts.strict3(ts.JQuery), 3, JConfig(**conf))
    ev = ts.events("letters", np.random.default_rng(4), 3, 12)
    js, jo = jb.scan(jb.init_state(), ts.to_jax(ev))
    t_s, to = tb.scan(tb.init_state(), ev)
    ts.assert_states_equal(js, t_s, "scan under tiering=True")
    assert grid(to) == grid(jo)


def test_tiered_processor_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        CEPProcessor(prefix_n_minus_1(ts.TQuery), 2, EngineConfig(**TCFG))


# -- lazy-chain ordering -------------------------------------------------------

def test_lazy_order_equals_jax_and_preserves_results(jnp_path):
    """The ordering's report equals JAX's; reordering changes neither the
    matches nor the stage tallies; a measured profile moves the order as
    it does in JAX."""
    tables = lower(conjunct_pattern(ts.TQuery, and_, hint))
    jtables = jlower(conjunct_pattern(ts.JQuery, j_and, j_hint))
    t2, report = apply_lazy_order(tables)
    _, jreport = j_apply_lazy_order(jtables)
    assert report == jreport and any(r["reordered"] for r in report.values())
    assert report["first"]["costs"] == sorted(report["first"]["costs"])
    profile = {"first": {"selectivity": 0.2}, "third": {"selectivity": 0.9}}
    assert apply_lazy_order(tables, profile)[1] == j_apply_lazy_order(jtables, profile)[1]
    attr = EngineConfig(**dict(CFG, stage_attribution=True))
    b1 = BatchMatcher(tables, 6, attr, device="cpu")
    b2 = BatchMatcher(t2, 6, attr, device="cpu")
    codes, rng = random_codes(6, 32, 1)
    s1, s2 = b1.init_state(), b2.init_state()
    for ev in ragged_batches(codes, rng, 16):
        s1, o1 = b1.scan(s1, ev)
        s2, o2 = b2.scan(s2, ev)
        assert grid(o1) == grid(o2)
    assert b1.stage_counters(s1) == b2.stage_counters(s2)


def test_profile_drives_conjunct_order():
    sel = hint(lambda k, v, ts_, st: v == A, cost=4.0, selectivity=0.1)
    loose = hint(lambda k, v, ts_, st: v < X, cost=4.0)
    m = and_(loose, sel)
    ordered, changed = order_conjuncts(m, stage_sel=0.9)
    assert changed and ordered[0] is m.parts[1]
    # A measured per-conjunct selectivity outranks both.
    from kafkastreams_cep_tpu_torch.compiler.tiering import conjunct_key
    ordered, changed = order_conjuncts(m, 0.9, {conjunct_key(loose): 0.01})
    assert not changed and ordered[0] is loose
