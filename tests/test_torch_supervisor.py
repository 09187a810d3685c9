"""The port's supervisor (``runtime/supervisor.py``) against the JAX
package's, after ``tests/test_supervisor.py``, ``test_escalation.py``,
``test_resume_crashwindow.py`` and ``test_chaos.py``.

Each scenario runs on both supervisors (the port's on the CPU) over the
same records, with faults injected through each package's failpoints, and
holds them to each other: the emitted stream, the ``recoveries`` /
``escalations`` / ``checkpoints`` counters, the final ``EngineConfig`` and
the canonical state leaves.  A JAX checkpoint and journal resume on the
port, and the port's on the JAX package.  The chaos schedules (device,
journal and checkpoint faults, crashes with torn or corrupt journal tails,
resumes) run on the port and end in the JAX package's fault-free state and
stream.  The arguments the port once refused (the brownout ladder's and
the mesh's) are served.
"""

import collections
import dataclasses
import os
import pickle
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.engine import EscalationPolicy as JPolicy
from kafkastreams_cep_tpu.runtime import CEPProcessor as JProcessor
from kafkastreams_cep_tpu.runtime import Record as JRecord
from kafkastreams_cep_tpu.runtime import Supervisor as JSupervisor
from kafkastreams_cep_tpu.runtime.migrate import canonical_state as j_canonical
from kafkastreams_cep_tpu.utils import failpoints as jfp
from kafkastreams_cep_tpu_torch.engine import EngineConfig as TConfig
from kafkastreams_cep_tpu_torch.engine.sizing import EscalationPolicy as TPolicy
from kafkastreams_cep_tpu_torch.engine.sizing import capacity_counters
from kafkastreams_cep_tpu_torch.runtime import CEPProcessor as TProcessor
from kafkastreams_cep_tpu_torch.runtime import Record as TRecord
from kafkastreams_cep_tpu_torch.runtime import ShardPolicy as TShardPolicy
from kafkastreams_cep_tpu_torch.runtime import Supervisor as TSupervisor
from kafkastreams_cep_tpu_torch.runtime import FlightRecorder, read_dump
from kafkastreams_cep_tpu_torch.runtime.migrate import canonical_state as t_canonical
from kafkastreams_cep_tpu_torch.native.journal import Journal
from kafkastreams_cep_tpu_torch.parallel import key_mesh
from kafkastreams_cep_tpu_torch.convert import state_arrays
from kafkastreams_cep_tpu_torch.utils import failpoints as tfp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import stock_demo  # noqa: E402

PKGS = {
    "jax": SimpleNamespace(Sup=JSupervisor, Proc=JProcessor, Record=JRecord, Config=JConfig,
                           Policy=JPolicy, Q=ts.JQuery, fp=jfp, canonical=j_canonical, kw={}),
    "torch": SimpleNamespace(Sup=TSupervisor, Proc=TProcessor, Record=TRecord, Config=TConfig,
                             Policy=TPolicy, Q=ts.TQuery, fp=tfp, canonical=t_canonical,
                             kw=dict(device="cpu")),
}
DEFAULT = dict(max_runs=16, slab_entries=48, slab_preds=6, dewey_depth=10, max_walk=10)
STOCK = dict(max_runs=32, slab_entries=64, slab_preds=8, dewey_depth=16, max_walk=16)


@pytest.fixture(autouse=True)
def clear_failpoints():
    yield
    jfp.FAILPOINTS.clear()
    tfp.FAILPOINTS.clear()


def canon_stream(matches):
    return [(k, ts.canon(seq)) for k, seq in matches]


def assert_canonical_equal(a, b, msg=""):
    x, y = state_arrays(j_canonical(a)), state_arrays(t_canonical(b))
    assert x.keys() == y.keys(), msg
    for name in x:
        np.testing.assert_array_equal(x[name], y[name], err_msg=f"{msg} {name}")


def stock_records(p):
    return [p.Record("stocks", {"price": e["price"], "volume": e["volume"]}, 1000 + i)
            for i, e in enumerate(stock_demo.STOCK_EVENTS)]


def sup_of(p, tmp_path, tag, query=ts.strict3, conf=DEFAULT, **kw):
    return p.Sup(query(p.Q), kw.pop("num_lanes", 1), p.Config(**conf),
                 checkpoint_path=str(tmp_path / f"{tag}.ckpt"), **kw, **p.kw)


def both(fn):
    """``fn(pkg, tmp_path)`` for each package: ``{name: result}``."""
    return {name: fn(p, name) for name, p in PKGS.items()}


# -- recovery ------------------------------------------------------------------


@pytest.mark.parametrize("site", ["device.dispatch", "device.result"])
def test_recovery_matches_uninterrupted_run(tmp_path, site):
    """A fault on the third batch's dispatch (before or after the state
    advanced): both supervisors recover from checkpoint and journal, and
    emit the stock demo's matches once, as a clean run does."""
    def run(p, name):
        recs = stock_records(p)
        flight = FlightRecorder(path=str(tmp_path / f"fl-{name}")) if name == "torch" else None
        sup = sup_of(p, tmp_path, f"s-{name}", ts.stock, STOCK, checkpoint_every=2,
                     **({"flight": flight} if flight else {}))
        out = sup.process(recs[:3]) + sup.process(recs[3:5])
        p.fp.FAILPOINTS.arm(site, times=1)
        out += sup.process(recs[5:])
        return sup, out, flight

    res = both(run)
    name_of = {i: e["name"] for i, e in enumerate(stock_demo.STOCK_EVENTS)}
    for name, (sup, out, _) in res.items():
        assert [stock_demo.format_match(s, name_of) for _, s in out] == stock_demo.EXPECTED, name
        assert (sup.recoveries, sup.checkpoints) == (1, 1), name
    assert_canonical_equal(res["jax"][0].processor.state, res["torch"][0].processor.state)
    flight = res["torch"][2]
    dump = read_dump(flight.dump_paths[0])
    assert dump["header"]["reason"] == "recover" and dump["records"]


def test_recovery_without_checkpoint_replays_full_journal(tmp_path):
    def run(p, name):
        sup = sup_of(p, tmp_path, f"j-{name}", checkpoint_every=100)
        out = sup.process([p.Record("k", ts.A, 1), p.Record("k", ts.B, 2)])
        p.fp.FAILPOINTS.arm("device.dispatch", times=1)
        out += sup.process([p.Record("k", ts.C, 3)])
        return sup, out

    res = both(run)
    for sup, out in res.values():
        assert (sup.recoveries, sup.checkpoints, len(out)) == (1, 0, 1)
    assert canon_stream(res["jax"][1]) == canon_stream(res["torch"][1])


def test_recovery_does_not_duplicate_replayed_matches(tmp_path):
    def run(p, name):
        sup = sup_of(p, tmp_path, f"d-{name}", checkpoint_every=100)
        first = sup.process([p.Record("k", v, i + 1) for i, v in enumerate((ts.A, ts.B, ts.C))])
        p.fp.FAILPOINTS.arm("device.dispatch", times=1)
        later = sup.process([p.Record("k", ts.X, 4)])
        final = sup.process([p.Record("k", v, i + 5) for i, v in enumerate((ts.A, ts.B, ts.C))])
        return sup, first, later, final

    res = both(run)
    for sup, first, later, final in res.values():
        assert (len(first), later, len(final), sup.recoveries) == (1, [], 1, 1)


def test_persistent_failure_raises_and_dumps_the_crash(tmp_path):
    def run(p, name):
        kw = {"flight": FlightRecorder()} if name == "torch" else {}
        sup = sup_of(p, tmp_path, f"p-{name}", max_retries=1, retry_backoff_ms=0,
                     checkpoint_every=1, **kw)
        sup.process([p.Record("k", ts.A, 1)])
        p.fp.FAILPOINTS.arm("device.dispatch", times=2)
        with pytest.raises(p.fp.InjectedFault):
            sup.process([p.Record("k", ts.B, 2)])
        return sup

    res = both(run)
    assert res["jax"].recoveries == res["torch"].recoveries == 1
    assert res["torch"].flight.dumps == 2  # the recovery, then the crash


def test_input_rejected_does_not_trigger_recovery(tmp_path):
    def run(p, name):
        sup = sup_of(p, tmp_path, f"i-{name}")
        sup.process([p.Record("k", ts.A, 1)])
        with pytest.raises(ValueError, match="num_lanes"):
            sup.process([p.Record("other_key", ts.A, 2)])
        return sup.recoveries

    assert both(run) == {"jax": 0, "torch": 0}


@pytest.mark.parametrize("pipeline", [False, True])
def test_checkpoint_failure_does_not_lose_matches(tmp_path, pipeline):
    def run(p, name):
        sup = sup_of(p, tmp_path, f"c-{name}-{pipeline}", checkpoint_every=1,
                     pipeline=pipeline)
        p.fp.FAILPOINTS.arm("checkpoint.save", times=1)
        out = sup.process([p.Record("k", v, i + 1) for i, v in enumerate((ts.A, ts.B, ts.C))])
        return sup, out

    res = both(run)
    for sup, out in res.values():
        assert (len(out), sup.checkpoint_failures, sup.checkpoints) == (1, 1, 0)
    assert canon_stream(res["jax"][1]) == canon_stream(res["torch"][1])


def test_pipelined_supervisor_checkpoints_and_loses_nothing(tmp_path):
    def run(p, name):
        recs = stock_records(p)
        sup = sup_of(p, tmp_path, f"pl-{name}", ts.stock, STOCK, checkpoint_every=2,
                     pipeline=True)
        out = []
        for i in range(0, len(recs), 2):
            out += sup.process(recs[i:i + 2])
        out += sup.checkpoint()
        return sup, out

    res = both(run)
    name_of = {i: e["name"] for i, e in enumerate(stock_demo.STOCK_EVENTS)}
    for sup, out in res.values():
        assert [stock_demo.format_match(s, name_of) for _, s in out] == stock_demo.EXPECTED
        assert sup.checkpoint_failures == 0
    assert res["jax"][0].checkpoints == res["torch"][0].checkpoints


def test_retry_backoff_is_the_jax_packages(tmp_path):
    """Two faults on one batch: the same (seq, attempt)-seeded waits."""
    def run(p, name):
        sup = sup_of(p, tmp_path, f"b-{name}", max_retries=4, retry_backoff_ms=100.0,
                     retry_backoff_cap_ms=250.0, checkpoint_every=1)
        slept = []
        sup._sleep = slept.append
        sup.process([p.Record("k", ts.A, 1)])
        p.fp.FAILPOINTS.arm("device.result", times=3)
        out = sup.process([p.Record("k", ts.B, 2)]) + sup.process([p.Record("k", ts.C, 3)])
        return sup, slept, out

    res = both(run)
    assert res["jax"][1] == res["torch"][1] and len(res["torch"][1]) == 3
    for sup, _, out in res.values():
        assert sup.recoveries == 3 and len(out) == 1
    snap = res["torch"][0].metrics_snapshot(per_lane=False)
    assert snap["retry_backoff_ms_total"] == pytest.approx(sum(res["torch"][1]) * 1e3)


def test_health(tmp_path):
    tight = dict(max_runs=2, slab_entries=8, slab_preds=2, dewey_depth=4, max_walk=4)

    def run(p, name):
        clean = sup_of(p, tmp_path, f"h-{name}")
        clean.process([p.Record("k", ts.A, 1), p.Record("k", ts.B, 2)])
        lossy = sup_of(p, tmp_path, f"hl-{name}", ts.skip_till_any, tight)
        lossy.process([p.Record("k", v, i) for i, v in enumerate([ts.A] + [ts.B] * 4)])
        return clean.health(), lossy.health()

    res = both(run)
    for clean, lossy in res.values():
        assert clean.healthy and not clean.warnings and not clean.errors
        assert lossy.healthy and lossy.warnings
    assert res["jax"][1].counters == res["torch"][1].counters


def test_metrics_snapshot_carries_lifecycle_phases(tmp_path):
    def run(p, name):
        sup = sup_of(p, tmp_path, f"m-{name}", checkpoint_every=1)
        sup.process([p.Record("k", ts.A, 1)])
        p.fp.FAILPOINTS.arm("device.dispatch", times=1)
        sup.process([p.Record("k", ts.B, 2)])
        return sup.metrics_snapshot()

    res = both(run)
    # The recovery's restored processor counts from its checkpoint on.
    assert res["jax"]["records_in"] == res["torch"]["records_in"]
    for snap in res.values():
        assert (snap["checkpoints"], snap["recoveries"]) == (2, 1)
        assert {"checkpoint", "recover", "escalate", "device", "pack"} <= set(snap["phases"])
        assert snap["phases"]["checkpoint"]["count"] == 2
        assert snap["phases"]["recover"]["count"] == 1


# -- escalation ------------------------------------------------------------------

SEED = dict(max_runs=4, slab_entries=16, slab_preds=2, dewey_depth=8, max_walk=8)
CEILING = dict(max_runs=64, slab_entries=128, slab_preds=16, dewey_depth=32, max_walk=32)


def storm(p, n_cycles=5):
    """tests/test_escalation.py's skip_till_any branch storm."""
    values = [ts.A, ts.B] + [ts.C, ts.D] * n_cycles
    return [[p.Record("k", v, 1000 + i, offset=i)] for i, v in enumerate(values)]


@pytest.mark.parametrize("pipeline", [False, True])
def test_escalation_recovers_dropped_branches_as_jax_does(tmp_path, pipeline):
    """Both supervisors escalate the same rounds to the same config, end
    with zero capacity counters, emit the same stream (that of a fresh
    run at the final config) and hold equal canonical states."""
    def run(p, name):
        sup = sup_of(p, tmp_path, f"e-{name}-{pipeline}", ts.skip_till_any, SEED,
                     journal_path=str(tmp_path / f"e-{name}-{pipeline}.jrnl"),
                     checkpoint_every=3, gc_interval=0, pipeline=pipeline,
                     auto_escalate=p.Policy(max_config=p.Config(**CEILING)))
        got = []
        for b in storm(p):
            got += sup.process(b)
        if pipeline:
            got += sup.checkpoint()
        return sup, got

    res = both(run)
    jsup, tsup = res["jax"][0], res["torch"][0]
    assert tsup.escalations == jsup.escalations >= 1
    assert tsup.checkpoints == jsup.checkpoints
    assert (dataclasses.asdict(tsup.processor.batch.matcher.config)
            == dataclasses.asdict(jsup.processor.batch.matcher.config))
    assert not any(capacity_counters(tsup.processor.counters()).values())
    key = sorted if pipeline else list
    assert key(map(repr, canon_stream(res["torch"][1]))) == key(
        map(repr, canon_stream(res["jax"][1])))
    assert_canonical_equal(jsup.processor.state, tsup.processor.state)
    p = PKGS["torch"]
    ref = sup_of(p, tmp_path, "ref", ts.skip_till_any,
                 dataclasses.asdict(tsup.processor.batch.matcher.config),
                 checkpoint_every=3, gc_interval=0)
    want = [m for b in storm(p) for m in ref.process(b)]
    assert key(map(repr, canon_stream(res["torch"][1]))) == key(map(repr, canon_stream(want)))


def test_escalation_pins_wide_config_for_resume(tmp_path):
    p = PKGS["torch"]
    ck, jr = str(tmp_path / "p.ckpt"), str(tmp_path / "p.jrnl")
    policy = p.Policy(max_config=p.Config(**CEILING))
    sup = p.Sup(ts.skip_till_any(p.Q), 1, p.Config(**SEED), checkpoint_path=ck,
                journal_path=jr, checkpoint_every=100, auto_escalate=policy,
                gc_interval=0, device="cpu")
    for b in storm(p, 4):
        sup.process(b)
    wide = sup.processor.batch.matcher.config
    del sup
    res = p.Sup.resume(ts.skip_till_any(p.Q), 1, p.Config(**SEED), checkpoint_path=ck,
                       journal_path=jr, auto_escalate=policy, gc_interval=0, device="cpu")
    assert res.processor.batch.matcher.config == wide
    assert not any(capacity_counters(res.processor.counters()).values())


@pytest.mark.parametrize("hysteresis, ceiling", [(2, CEILING), (1, SEED)])
def test_hysteresis_and_exhausted_escalation(tmp_path, hysteresis, ceiling):
    """A tolerated first trip (hysteresis 2); and a policy with no headroom
    that keeps counting and warning, as the JAX supervisor does."""
    def run(p, name):
        sup = sup_of(p, tmp_path, f"x-{name}", ts.skip_till_any, SEED, checkpoint_every=100,
                     gc_interval=0, auto_escalate=p.Policy(max_config=p.Config(**ceiling),
                                                           hysteresis=hysteresis))
        out = [m for b in storm(p, 4) for m in sup.process(b)]
        return sup, out

    res = both(run)
    jsup, tsup = res["jax"][0], res["torch"][0]
    assert tsup.escalations == jsup.escalations
    assert tsup.processor.counters() == jsup.processor.counters()
    assert canon_stream(res["torch"][1]) == canon_stream(res["jax"][1])
    if ceiling is SEED:
        assert tsup.escalations == 0 and tsup.health().warnings


# -- resume, and the crash windows ----------------------------------------------


def batches_for(p, values, t0=1000, off0=0):
    return [[p.Record("k", v, t0 + i, offset=off0 + i)] for i, v in enumerate(values)]


@pytest.mark.parametrize("writer, reader", [("jax", "torch"), ("torch", "jax")])
def test_resume_across_packages(tmp_path, writer, reader):
    """One package checkpoints and journals the first batches and
    "crashes"; the other resumes from its files and goes on: the stream
    and state equal an uninterrupted run's."""
    values = [ts.A, ts.B, ts.C, ts.A, ts.B, ts.X, ts.C, ts.A, ts.B, ts.C]
    ck, jr = str(tmp_path / "x.ckpt"), str(tmp_path / "x.jrnl")
    w, r = PKGS[writer], PKGS[reader]
    sup = w.Sup(ts.strict3(w.Q), 1, w.Config(**DEFAULT), checkpoint_path=ck,
                journal_path=jr, checkpoint_every=3, gc_interval=0, **w.kw)
    out = [m for b in batches_for(w, values[:5]) for m in sup.process(b)]
    assert sup.checkpoints == 1
    del sup
    res = r.Sup.resume(ts.strict3(r.Q), 1, r.Config(**DEFAULT), checkpoint_path=ck,
                       journal_path=jr, checkpoint_every=3, gc_interval=0, **r.kw)
    assert res._seq == 5
    out += [m for b in batches_for(r, values[5:], off0=5, t0=1005) for m in res.process(b)]
    clean = PKGS["torch"].Sup(ts.strict3(ts.TQuery), 1, TConfig(**DEFAULT),
                              checkpoint_path=str(tmp_path / "c.ckpt"), checkpoint_every=3,
                              gc_interval=0, device="cpu")
    want = [m for b in batches_for(PKGS["torch"], values) for m in clean.process(b)]
    assert canon_stream(out) == canon_stream(want) and len(want) == 2
    states = {reader: res.processor.state, "torch" if reader == "jax" else "jax":
              clean.processor.state}
    assert_canonical_equal(states["jax"], states["torch"])


def _resumed(p, ck, jr):
    return p.Sup.resume(ts.strict3(p.Q), 1, p.Config(**DEFAULT), checkpoint_path=ck,
                        journal_path=jr, gc_interval=0, **p.kw)


def _corrupt_file(path):
    with open(path, "r+b") as f:
        f.seek(-64, 2)
        f.write(b"\xff" * 16)


@pytest.mark.parametrize("window", ["rotation", "seq_gap", "torn_tail", "corrupt_first",
                                    "corrupt_newest"])
def test_crash_windows(tmp_path, monkeypatch, window):
    """tests/test_resume_crashwindow.py's windows on both supervisors: the
    resumed sequence number, state and later matches are the JAX one's."""
    values = [ts.A, ts.B, ts.C, ts.A, ts.B, ts.C, ts.A]

    def run(p, name):
        ck, jr = str(tmp_path / f"{window}-{name}.ckpt"), str(tmp_path / f"{window}-{name}.jrnl")
        every = 3 if window.startswith("corrupt") else 100
        sup = p.Sup(ts.strict3(p.Q), 1, p.Config(**DEFAULT), checkpoint_path=ck,
                    journal_path=jr, checkpoint_every=every, gc_interval=0, **p.kw)
        emitted = []
        if window == "rotation":
            emitted += [m for b in batches_for(p, values[:3]) for m in sup.process(b)]
            monkeypatch.setattr(sup, "_rotate_journal", lambda: None)
            sup.checkpoint()
            emitted += [m for b in batches_for(p, values[3:5], 1003, 3) for m in sup.process(b)]
        else:
            n = {"seq_gap": 4, "torn_tail": 2, "corrupt_first": 5, "corrupt_newest": 7}[window]
            emitted += [m for b in batches_for(p, values[:n]) for m in sup.process(b)]
        del sup
        if window == "seq_gap":
            j = Journal(jr)
            frames = [pickle.loads(x) for x in j.replay()]
            j.truncate()
            for seq, batch in frames:
                if seq != 3:
                    j.append(pickle.dumps((seq, batch)))
        elif window == "torn_tail":
            p.fp.tear_journal_tail(jr)
        elif window.startswith("corrupt"):
            _corrupt_file(ck)
        res = _resumed(p, ck, jr)
        more = res.process([p.Record("k", ts.C, 9000, offset=20)])
        return res, emitted, more

    res = both(run)
    (jr_, je, jm), (tr, te, tm) = res["jax"], res["torch"]
    assert tr._seq == jr_._seq
    assert canon_stream(te) == canon_stream(je) and canon_stream(tm) == canon_stream(jm)
    assert_canonical_equal(jr_.processor.state, tr.processor.state)


# -- chaos -------------------------------------------------------------------------

CHAOS_CFG = dict(max_runs=16, slab_entries=48, slab_preds=8, dewey_depth=16, max_walk=12)
CHAOS = {
    "eager": CHAOS_CFG,
    "lazy": dict(CHAOS_CFG, lazy_extraction=True, handle_ring=16),
    "tiered": dict(CHAOS_CFG, tiering=True),
}
KEYS = ("k0", "k1")
FAULTS = (("device.dispatch", 0.10, 1), ("device.result", 0.10, 1),
          ("journal.append", 0.10, 1), ("journal.fsync", 0.08, 1),
          ("checkpoint.save", 0.10, 1), ("checkpoint.rename", 0.08, 1),
          ("device.dispatch", 0.05, 2))


def gen_batches(p, seed, n_batches=6, size=4):
    """tests/test_chaos.py's seeded stream, with explicit offsets."""
    rng = np.random.default_rng(seed)
    offs = collections.defaultdict(int)
    batches, t = [], 0
    for _ in range(n_batches):
        recs = []
        for _ in range(size):
            k = KEYS[int(rng.integers(len(KEYS)))]
            recs.append(p.Record(k, int(rng.integers(0, 5)), 1000 + t, offset=offs[k]))
            offs[k] += 1
            t += 1
        batches.append(recs)
    return batches


def canon_match(key, seq):
    return (key, tuple(sorted((stage, tuple(sorted(e.offset for e in events)))
                              for stage, events in seq.as_map().items())))


def run_chaos(seed, tmp_path, conf):
    """tests/test_chaos.py's schedule on the port's supervisor."""
    p = PKGS["torch"]
    batches = gen_batches(p, seed)
    rng = np.random.default_rng(seed + 10_000)
    ck, jr = str(tmp_path / f"chaos{seed}.ckpt"), str(tmp_path / f"chaos{seed}.jrnl")

    def make(resume=False):
        args = (ts.skip_till_any(p.Q), len(KEYS), p.Config(**conf))
        kw = dict(checkpoint_path=ck, journal_path=jr, checkpoint_every=2, gc_interval=0,
                  retry_backoff_ms=0, device="cpu")
        return p.Sup.resume(*args, **kw) if resume else p.Sup(*args, **kw)

    sup, emitted, dups_allowed, fired, crashes, i, guard = make(), collections.Counter(), \
        False, 0, 0, 0, 0
    while i < len(batches):
        guard += 1
        assert guard < 200, "the chaos schedule made no progress"
        armed = []
        for site, prob, times in FAULTS:
            if rng.random() < prob:
                tfp.FAILPOINTS.arm(site, times=times)
                armed.append(site)
        crash_after = rng.random() < 0.18
        try:
            for k, seq in sup.process(batches[i]):
                emitted[canon_match(k, seq)] += 1
            i += 1
        except tfp.InjectedFault:
            crash_after = True
        finally:
            fired += sum(tfp.FAILPOINTS.hits(s) for s in set(armed))
            tfp.FAILPOINTS.clear()
        if crash_after:
            crashes += 1
            dups_allowed = dups_allowed or sup._journal_suspended
            if rng.random() < 0.4:
                tfp.tear_journal_tail(jr)
            elif rng.random() < 0.2:
                tfp.corrupt_journal_tail(jr, seed=seed)
            del sup
            sup = make(resume=True)
            i = 0  # an at-least-once source re-submits all; dedup absorbs
    return sup, emitted, dups_allowed, fired, crashes


@pytest.mark.parametrize("mode, seed", [("eager", 0), ("eager", 1), ("eager", 2),
                                        ("eager", 3), ("lazy", 4), ("tiered", 2)])
def test_chaos_schedule_ends_in_the_jax_oracle(tmp_path, mode, seed):
    conf = CHAOS[mode]
    jp = PKGS["jax"]
    oracle = JProcessor(ts.skip_till_any(jp.Q), len(KEYS), JConfig(**conf), gc_interval=0)
    want = collections.Counter()
    for b in gen_batches(jp, seed):
        for k, seq in oracle.process(b):
            want[canon_match(k, seq)] += 1
    for k, seq in oracle.flush():
        want[canon_match(k, seq)] += 1
    sup, emitted, dups_allowed, fired, crashes = run_chaos(seed, tmp_path, conf)
    for k, seq in sup.processor.flush():
        emitted[canon_match(k, seq)] += 1
    assert fired or crashes
    assert_canonical_equal(oracle.state, sup.processor.state, f"seed {seed}")
    if dups_allowed:
        assert set(emitted) == set(want)
    else:
        assert emitted == want, f"seed {seed}: faults {fired}, crashes {crashes}"
    assert not any(sup.processor.counters().values())


# -- the doors once closed, all open now ---------------------------------------------


@pytest.mark.parametrize("kwarg, item", [
    ("overload_policy", "item 6"), ("shard_policy", "item 8"), ("shard_probe", "item 8"),
    ("mesh", "item 8"),
])
def test_unported_arguments_raise(tmp_path, kwarg, item):
    """Every argument the port once refused is served now (the test keeps
    its name and ids): the brownout ladder of ``ROADMAP.md`` §A item 6
    (tests/test_torch_overload.py) and the mesh's three of item 8
    (tests/test_torch_sharding.py, test_torch_shard_fault.py)."""
    if kwarg == "overload_policy":
        # The default policy builds a controller at L0.
        sup = sup_of(PKGS["torch"], tmp_path, "n", **{kwarg: True})
        assert sup._overload.level == 0 and sup.metrics_snapshot()["overload_level"] == 0
        return
    p = PKGS["torch"]
    mesh = key_mesh(["cpu"])
    value = {"shard_policy": TShardPolicy(straggler_factor=2.0), "shard_probe": lambda: [0],
             "mesh": mesh}[kwarg]
    sup = sup_of(p, tmp_path, "n", **{kwarg: value})
    out = sup.process([p.Record("k", v, i) for i, v in enumerate([ts.A, ts.B, ts.C])])
    assert len(out) == 1, f"{kwarg} ({item}) is served"
    snap = sup.metrics_snapshot()
    assert (snap["evacuations"], snap["stragglers"], snap["rebalances"]) == (0, 0, 0)
    if kwarg == "shard_policy":
        assert sup._shard_policy.straggler_factor == 2.0
    elif kwarg == "shard_probe":
        # Unmeshed: no default policy, so the probe is never consulted.
        assert sup._shard_policy is None and sup._shard_probe() == [0]
    else:
        assert sup._shard_policy == TShardPolicy() and sup.processor.lane_shards() == [0]
        proc = TProcessor(ts.strict3(ts.TQuery), 1, TConfig(**DEFAULT), mesh=mesh)
        assert proc.mesh is mesh and proc.batch.mesh is mesh


def test_latency_builds_a_ledger_on_supervisor_and_processor(tmp_path):
    """The latency door is open: ``latency=True`` builds a ledger on the
    supervised processor and on a bare one, on their clock, and a
    recovery's stall lands in it as in the JAX supervisor."""
    from kafkastreams_cep_tpu_torch.utils.latency import LatencyLedger

    def clock():
        clock.t += 0.5
        return clock.t

    clock.t = 1000.0
    proc = TProcessor(ts.strict3(ts.TQuery), 1, TConfig(**DEFAULT), device="cpu",
                      clock=clock, latency=True)
    assert isinstance(proc.ledger, LatencyLedger) and proc.ledger.clock is clock

    def run(p, tag):
        sup = sup_of(p, tmp_path, tag, latency=True, retry_backoff_ms=0)
        vals = [ts.A, ts.B, ts.C, ts.X, ts.A, ts.B, ts.C, ts.X, ts.A, ts.B, ts.C, ts.X]
        recs = [p.Record("k", v, 1000 + i) for i, v in enumerate(vals)]
        with p.fp.FAILPOINTS.session({"device.dispatch": [1]}):
            out = [m for i in range(0, len(recs), 3) for m in sup.process(recs[i:i + 3])]
        led = sup.processor.ledger
        return (sup.recoveries, led.records_committed, sorted(led.snapshot()["stalls"]),
                ts.canon_matches(out))

    got = both(lambda p, name: run(p, name))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 1 and got["torch"][2] == ["recover"]
