"""The port's brownout ladder (``runtime/overload.py`` and its supervisor
and processor hooks) against the JAX package's, after
``tests/test_overload.py``.

The controller runs beside JAX's ``OverloadController`` on the same signal
sequences (levels, proposals, streaks, state dicts), with the shed stride,
the ladder table and the policy's validation errors held equal.  Both
packages' supervisors run the same flood and subside records (the JAX one
on its jnp path, the port's on the CPU) under an event-time policy: the
wall-clock signals are neutralised, so pressure comes from reorder-hold
occupancy only and the level trajectory is a function of the records.
Their trajectories, dead letters, guard counters, matches and gauges are
held equal; a crash at each level resumes in that level from either
package's checkpoint; enter, exit and shed faults defer or recover as in
JAX; each transition leaves a span and L3+ a flight dump; the survivor
stream equals an unloaded run of the admitted records; and the chaos
schedules of ``tests/test_chaos.py``'s overload harness, at its fast seeds,
end in the JAX package's fault-free run.
"""

import collections
import json
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.runtime import CEPProcessor as JProcessor
from kafkastreams_cep_tpu.runtime import FlightRecorder as JFlight
from kafkastreams_cep_tpu.runtime import Record as JRecord
from kafkastreams_cep_tpu.runtime import Supervisor as JSupervisor
from kafkastreams_cep_tpu.runtime.ingest import IngestPolicy as JIngest
from kafkastreams_cep_tpu.runtime.migrate import canonical_state as j_canonical
from kafkastreams_cep_tpu.runtime import overload as jov
from kafkastreams_cep_tpu.utils import failpoints as jfp
from kafkastreams_cep_tpu.utils.telemetry import InMemoryTraceSink as JSink
from kafkastreams_cep_tpu_torch.convert import state_arrays
from kafkastreams_cep_tpu_torch.engine import EngineConfig as TConfig
from kafkastreams_cep_tpu_torch.runtime import CEPProcessor as TProcessor
from kafkastreams_cep_tpu_torch.runtime import FlightRecorder as TFlight
from kafkastreams_cep_tpu_torch.runtime import OverloadController, OverloadPolicy
from kafkastreams_cep_tpu_torch.runtime import Record as TRecord
from kafkastreams_cep_tpu_torch.runtime import Supervisor as TSupervisor
from kafkastreams_cep_tpu_torch.runtime import overload as tov
from kafkastreams_cep_tpu_torch.runtime.ingest import IngestPolicy as TIngest
from kafkastreams_cep_tpu_torch.runtime.ingest import REASON_OVERLOAD_SHED
from kafkastreams_cep_tpu_torch.runtime.migrate import canonical_state as t_canonical
from kafkastreams_cep_tpu_torch.utils import failpoints as tfp
from kafkastreams_cep_tpu_torch.utils.telemetry import InMemoryTraceSink as TSink
from kafkastreams_cep_tpu_torch.utils.telemetry import render_prometheus

PKGS = {
    "jax": SimpleNamespace(Sup=JSupervisor, Proc=JProcessor, Record=JRecord, Config=JConfig,
                           Ingest=JIngest, ov=jov, Q=ts.JQuery, fp=jfp, Sink=JSink,
                           Flight=JFlight, kw={}),
    "torch": SimpleNamespace(Sup=TSupervisor, Proc=TProcessor, Record=TRecord, Config=TConfig,
                             Ingest=TIngest, ov=tov, Q=ts.TQuery, fp=tfp, Sink=TSink,
                             Flight=TFlight, kw=dict(device="cpu")),
}
CFG = dict(max_runs=16, slab_entries=48, slab_preds=8, dewey_depth=16, max_walk=12)
#: tests/test_overload.py's POLICY: the wall-clock references at 1e9, one
#: level a flood batch, a two-tick exit.
POLICY = dict(burn_ref=1e9, queue_ref=1e9, ring_ref=1e9, hold_age_ref=1e9, hold_ref=0.05,
              enter_streak=1, exit_streak=2)
INGEST = dict(grace_ms=1000, reorder_depth=64)


@pytest.fixture(autouse=True)
def jnp_path_and_clean_failpoints(monkeypatch):
    monkeypatch.setenv("CEP_WALK_KERNEL", "0")
    monkeypatch.delenv("CEP_SCAN_KERNEL", raising=False)
    yield
    jfp.FAILPOINTS.clear()
    tfp.FAILPOINTS.clear()


# -- the controller ---------------------------------------------------------------


def signal_walk(seed: int, n: int = 400):
    """A seeded random walk of the five signals: bursts that climb the
    ladder, quiet stretches that bring it down, gaps (missing signals)."""
    rng = np.random.default_rng(seed)
    level = 0.0
    out = []
    for _ in range(n):
        level = max(0.0, level + rng.normal(0.0, 2.5))
        sig = {"hold_frac": level * 0.05, "burn_rate": float(rng.random()) * level / 4,
               "queue_p99_s": float(rng.random()), "ring_depth": float(rng.integers(0, 40))}
        if rng.random() < 0.2:
            sig.pop("burn_rate")
        if rng.random() < 0.1:
            sig["hold_age_frac"] = None
        out.append(sig)
    return out


POLICIES = {
    "default": {},
    "event_time": POLICY,
    "tight": dict(enter_streak=1, exit_streak=1, enter_at=(0.5, 1.0, 1.5, 2.0),
                  exit_at=(0.25, 0.5, 1.0, 1.5)),
}


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_equals_jax(policy, seed):
    """Tick by tick: the pressure, the proposal, the level and the whole
    state dict; a proposal is committed, or (every fifth) aborted as a
    failed transition protocol would."""
    jc = jov.OverloadController(jov.OverloadPolicy(**POLICIES[policy]))
    tc = OverloadController(OverloadPolicy(**POLICIES[policy]))
    moved = 0
    for i, sig in enumerate(signal_walk(seed)):
        jp, tp = jc.tick(sig), tc.tick(sig)
        assert tp == jp and tc.last_pressure == jc.last_pressure, i
        if tp is not None:
            moved += 1
            for c in (jc, tc):
                c.begin(tp[1])
                c.admission_pressure = (c.admission_scale(tp[1]), {"t0": 0.5})
                c.abort() if moved % 5 == 0 else c.commit()
        assert tc.to_state() == jc.to_state(), i
        assert tc.metrics() == jc.metrics(), i
        for lvl in range(tov.MAX_LEVEL + 1):
            assert (tc.drain_widen(lvl), tc.telemetry_defer(lvl), tc.admission_scale(lvl),
                    tc.admit_fraction(lvl)) == (jc.drain_widen(lvl), jc.telemetry_defer(lvl),
                                                jc.admission_scale(lvl), jc.admit_fraction(lvl))
    assert moved >= 6, "the walk must move the ladder"


@pytest.mark.parametrize("frac", [0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0])
def test_shed_keep_equals_jax(frac):
    kept = [tov.shed_keep(i, frac) for i in range(1000)]
    assert kept == [jov.shed_keep(i, frac) for i in range(1000)]
    assert sum(kept) == int(np.floor(1000 * frac))


def test_ladder_table_equals_jax_and_is_in_readme():
    assert tov.ladder_table_markdown() == jov.ladder_table_markdown()
    assert tov.MAX_LEVEL == jov.MAX_LEVEL
    readme = (pathlib.Path(__file__).parent.parent / "README.md").read_text()
    assert tov.ladder_table_markdown() in readme


@pytest.mark.parametrize("bad", [dict(enter_at=(1.0, 2.0)), dict(exit_at=(1.0, 2.0, 4.0, 8.0)),
                                 dict(drain_widen=(1, 2, 3)), dict(enter_streak=0),
                                 dict(shed_fraction=(0.0,) * 4)],
                         ids=["arity", "hysteresis", "actuator", "streak", "shed"])
def test_policy_validation_errors_equal(bad):
    with pytest.raises(ValueError) as je:
        jov.OverloadPolicy(**bad)
    with pytest.raises(ValueError) as te:
        OverloadPolicy(**bad)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_controller_state_cross_loads(writer):
    src = (jov if writer == "jax" else tov).OverloadController(
        (jov if writer == "jax" else tov).OverloadPolicy(**POLICY))
    src.begin(3)
    src.commit()
    src.base_drain, src.shed_total = 2, 17
    src.admission_pressure = (0.25, {"t0": 0.6, "t1": 0.2})
    src._enter_streak = 1
    state = json.loads(json.dumps(src.to_state()))  # checkpoint-header safe
    other = tov if writer == "jax" else jov
    back = other.OverloadController.from_state(state, other.OverloadPolicy(**POLICY))
    assert back.to_state() == src.to_state()
    assert back.admit_fraction() == pytest.approx(0.5) and back.metrics() == src.metrics()


# -- the supervisors, side by side ------------------------------------------------


def flood_batches(p, n_batches, per_batch, n_keys=4, t0=0, val_mod=5, offs=None):
    """tests/test_overload.py's flood: +1 ms a record, all held under a
    1000 ms grace, so hold pressure rises at once."""
    offs = offs if offs is not None else collections.defaultdict(int)
    batches, t = [], t0
    for _ in range(n_batches):
        recs = []
        for i in range(per_batch):
            t += 1
            k = f"k{i % n_keys}"
            recs.append(p.Record(k, i % val_mod, t, offset=offs[k]))
            offs[k] += 1
        batches.append(recs)
    return batches, t, offs


def subside_batches(p, n, t0, offs, key="k0", step=5000):
    """Sparse traffic with big timestamp jumps: the watermark races ahead
    and the held backlog drains."""
    batches, t = [], t0
    for _ in range(n):
        t += step
        batches.append([p.Record(key, 4, t, offset=offs[key])])
        offs[key] += 1
    return batches, t


def make_sup(p, tmp_path, tag, resume=False, **kw):
    args = (ts.strict3(p.Q), 4, p.Config(**CFG))
    base = dict(checkpoint_path=str(tmp_path / f"{tag}.ckpt"),
                journal_path=str(tmp_path / f"{tag}.jrnl"), checkpoint_every=100,
                gc_interval=0, overload_policy=p.ov.OverloadPolicy(**POLICY),
                ingest=p.Ingest(**INGEST), **p.kw)
    base.update(kw)
    return p.Sup.resume(*args, **base) if resume else p.Sup(*args, **base)


def canon_stream(matches):
    return [ts.canon_matches([m])[0] for m in matches]


def dead_of(guard):
    return [(d.record.key, d.record.offset, d.reason) for d in guard.dead_letters]


def reconciles(guard, offered):
    """Every offered record is admitted, shed or dead-lettered, each typed."""
    lc = guard.loss_counters()
    return offered == guard.admitted + lc["overload_shed"] + lc["late_dropped"] + lc[
        "quarantined"]


GAUGES = ("overload_level", "overload_pressure", "overload_transitions",
          "overload_transition_failures", "overload_shed")


def run_flood(p, tmp_path, n_flood=12, n_sub=30, **kw):
    sup = make_sup(p, tmp_path, "flood", **kw)
    flood, t, offs = flood_batches(p, n_flood, 40, val_mod=3)
    sub, t = subside_batches(p, n_sub, t, offs)
    levels, matches, actuators = [], [], []
    for b in flood + sub:
        matches += sup.process(b)
        levels.append(sup._overload.level)
        proc = sup.processor
        actuators.append((proc.overload_admit_fraction, proc.telemetry_defer,
                          proc.drain_interval))
    offered = sum(len(b) for b in flood + sub)
    return SimpleNamespace(sup=sup, levels=levels, matches=canon_stream(matches),
                           actuators=actuators, offered=offered)


@pytest.fixture(scope="module")
def jax_flood(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("CEP_WALK_KERNEL", "0")
    try:
        yield run_flood(PKGS["jax"], tmp_path_factory.mktemp("jflood"))
    finally:
        mp.undo()


def test_flood_trajectory_equals_jax(tmp_path, jax_flood):
    """Up one level a flood batch to L4, back to L0 on the tail: levels,
    actuators, dead letters, guard counters, matches, controller state and
    gauges equal JAX's; every record reconciles."""
    got, want = run_flood(PKGS["torch"], tmp_path), jax_flood
    assert got.levels == want.levels
    assert got.levels[:4] == [1, 2, 3, 4] and got.levels[-1] == 0
    assert got.actuators == want.actuators
    assert got.matches == want.matches and got.matches
    tg, jg = got.sup.processor._guard, want.sup.processor._guard
    assert dead_of(tg) == dead_of(jg) and tg.overload_shed > 0
    assert tg.loss_counters() == jg.loss_counters() and tg.admitted == jg.admitted
    assert tg.stats() == jg.stats()
    assert reconciles(tg, got.offered)
    assert sum(d[2] == REASON_OVERLOAD_SHED for d in dead_of(tg)) == tg.overload_shed
    assert got.sup._overload.to_state() == want.sup._overload.to_state()
    assert got.sup._overload.transitions == 8 and got.sup.checkpoints == want.sup.checkpoints
    tsnap = got.sup.metrics_snapshot(per_lane=False)
    jsnap = want.sup.metrics_snapshot(per_lane=False)
    assert {k: tsnap[k] for k in GAUGES} == {k: jsnap[k] for k in GAUGES}
    txt = render_prometheus(tsnap)
    assert "# TYPE cep_overload_level gauge" in txt and "cep_overload_transitions 8" in txt


def test_telemetry_defer_skips_the_device_gathers(tmp_path):
    sup = make_sup(PKGS["torch"], tmp_path, "defer")
    flood, _, _ = flood_batches(PKGS["torch"], 1, 40)
    assert "per_lane" in sup.metrics_snapshot()
    sup.process(flood[0])
    assert sup._overload.level == 1 and sup.processor.telemetry_defer
    snap = sup.metrics_snapshot()
    assert "per_lane" not in snap and "per_key" not in snap


def pinned(ctl):
    """The controller state a pin checkpoint carries: all of it but the
    transition count, which commits after the pin (a resumed run counts
    one fewer, in both packages)."""
    return {k: v for k, v in ctl.to_state().items() if k != "transitions"}


@pytest.mark.parametrize("level", [1, 2, 3, 4])
@pytest.mark.parametrize("writer, reader", [("jax", "torch"), ("torch", "jax")])
def test_crash_at_each_level_resumes_there_across_packages(tmp_path, level, writer, reader):
    """The writer floods to ``level`` and crashes; the other package resumes
    from its checkpoint and journal in that level with the actuators
    re-applied, steps down to L0 and ends where the reader's own crash-free
    run of the same records ends."""
    w, r = PKGS[writer], PKGS[reader]
    sup = make_sup(w, tmp_path, "x", checkpoint_every=2)
    flood, t, offs = flood_batches(w, level, 40)
    for b in flood:
        sup.process(b)
    assert sup._overload.level == level
    pre = (sup.processor._guard.overload_shed, pinned(sup._overload))
    del sup  # crash
    sup2 = make_sup(r, tmp_path, "x", resume=True, checkpoint_every=2)
    ctl = sup2._overload
    assert ctl.level == level and pinned(ctl) == pre[1]
    assert sup2.processor.drain_interval == OverloadPolicy().drain_widen[level]
    assert sup2.processor.telemetry_defer
    assert sup2.processor.overload_admit_fraction == ctl.admit_fraction()
    assert sup2.processor._guard.overload_shed == pre[0]
    rflood, t, roffs = flood_batches(r, level, 40)
    sub, _ = subside_batches(r, 12, t, roffs)
    for b in sub:
        sup2.process(b)
    assert sup2._overload.level == 0
    offered = sum(len(b) for b in rflood + sub)
    assert reconciles(sup2.processor._guard, offered)
    ref = make_sup(r, tmp_path, "ref", checkpoint_every=2)
    for b in rflood + sub:
        ref.process(b)
    assert dead_of(sup2.processor._guard) == dead_of(ref.processor._guard)
    assert pinned(sup2._overload) == pinned(ref._overload)


def both(fn):
    """``fn`` run on each package: ``{"jax": ..., "torch": ...}``."""
    return {name: fn(p) for name, p in PKGS.items()}


def test_enter_fault_defers_the_transition_as_jax_does(tmp_path):
    def run(p):
        sup = make_sup(p, tmp_path, f"ef{p.Q.__module__}")
        flood, _, _ = flood_batches(p, 3, 40)
        p.fp.FAILPOINTS.arm("overload.enter", times=1)
        try:
            sup.process(flood[0])
        finally:
            p.fp.FAILPOINTS.clear()
        out = [(sup._overload.level, sup._overload.transition_failures,
                sup.processor.overload_admit_fraction)]
        del sup  # a crash after the failed transition: nothing was pinned
        sup2 = make_sup(p, tmp_path, f"ef{p.Q.__module__}", resume=True)
        out.append(sup2._overload.level)
        sup2.process(flood[1])
        out.append((sup2._overload.level, sup2._overload.transitions))
        return out

    got = both(run)
    assert got["torch"] == got["jax"] == [(0, 1, None), 0, (1, 1)]


def test_exit_fault_defers_the_recovery_one_tick_as_jax_does(tmp_path):
    def run(p):
        sup = make_sup(p, tmp_path, f"xf{p.Q.__module__}")
        flood, t, offs = flood_batches(p, 1, 40)
        sup.process(flood[0])
        sub, _ = subside_batches(p, 4, t, offs)
        sup.process(sub[0])
        p.fp.FAILPOINTS.arm("overload.exit", times=1)
        try:
            sup.process(sub[1])  # proposes L1 -> L0; the failpoint kills it
        finally:
            p.fp.FAILPOINTS.clear()
        out = [(sup._overload.level, sup._overload.transition_failures)]
        sup.process(sub[2])  # the streak was kept: re-proposed and committed
        return out + [sup._overload.level]

    got = both(run)
    assert got["torch"] == got["jax"] == [(1, 1), 0]


def test_shed_fault_recovers_to_the_same_shed_as_jax(tmp_path):
    def run(p):
        sup = make_sup(p, tmp_path, f"sf{p.Q.__module__}", checkpoint_every=1,
                       retry_backoff_ms=0)
        flood, _, _ = flood_batches(p, 5, 40)
        for b in flood[:4]:
            sup.process(b)
        p.fp.FAILPOINTS.arm("overload.shed", times=1)
        try:
            sup.process(flood[4])
        finally:
            p.fp.FAILPOINTS.clear()
        g = sup.processor._guard
        assert reconciles(g, 200)
        return sup.recoveries, sup._overload.level, dead_of(g)

    got = both(run)
    assert got["torch"] == got["jax"] and got["torch"][:2] == (1, 4)


def test_each_transition_spans_and_l3_dumps_as_jax(tmp_path):
    def run(p):
        sink = p.Sink()
        flight = p.Flight(capacity=64, path=str(tmp_path / f"fr{p.Q.__module__}"))
        sup = make_sup(p, tmp_path, f"sp{p.Q.__module__}", trace_sink=sink, flight=flight)
        flood, t, offs = flood_batches(p, 4, 40)
        sub, _ = subside_batches(p, 10, t, offs)
        for b in flood + sub:
            sup.process(b)
        spans = [(s["from_level"], s["to_level"]) for s in sink.spans("overload.transition")]
        return spans, flight.dumps, sum("overload" in x for x in flight.dump_paths)

    got = both(run)
    assert got["torch"] == got["jax"]
    spans, dumps, overload_dumps = got["torch"]
    assert spans == [(0, 1), (1, 2), (2, 3), (3, 4), (4, 3), (3, 2), (2, 1), (1, 0)]
    assert overload_dumps == 2 and dumps >= 2  # L3 and L4 entries


# -- the survivor differential -----------------------------------------------------


def run_admitted(p, batches, dead):
    """An unloaded processor over the records the browned-out run kept."""
    proc = p.Proc(ts.strict3(p.Q), 4, p.Config(**CFG), gc_interval=0,
                  ingest=p.Ingest(**INGEST), **p.kw)
    out = []
    for b in batches:
        keep = [r for r in b if (r.key, r.offset) not in dead]
        if keep:
            out += proc.process(keep)
    return proc, out + proc.drain_ingest() + proc.flush()


@pytest.mark.parametrize("scan", ["0", "1"], ids=["per_step", "whole_scan"])
def test_survivor_stream_equals_the_admitted_subset(tmp_path, monkeypatch, scan):
    """The browned-out stream equals an unloaded run of the admitted
    records, on the per-step path and the whole-scan path (its plain
    version on the CPU); both paths shed the same records."""
    monkeypatch.setenv("CEP_SCAN_KERNEL", scan)
    p = PKGS["torch"]
    sup = make_sup(p, tmp_path, f"sv{scan}")
    flood, t, offs = flood_batches(p, 6, 16, val_mod=3)
    sub, _ = subside_batches(p, 20, t, offs)
    got, levels = [], []
    for b in flood + sub:
        got += sup.process(b)
        levels.append(sup._overload.level)
    got += sup.processor.drain_ingest() + sup.processor.flush()
    assert max(levels) >= 3 and levels[-1] == 0, levels
    g = sup.processor._guard
    assert reconciles(g, sum(len(b) for b in flood + sub))
    dead = {(d.record.key, d.record.offset) for d in g.dead_letters}
    assert dead
    ref, want = run_admitted(p, flood + sub, dead)
    assert canon_stream(got) == canon_stream(want) and want
    assert not any(sup.processor.counters().values()) and not any(ref.counters().values())

# -- chaos over the ladder (tests/test_chaos.py's overload harness) ----------------
#
# A seeded flood climbs the ladder into its shedding levels while device,
# journal and shed faults and crashes (with torn or corrupt journal tails)
# land on the port's supervisor; a sparse tail brings it back to L0.  The
# chaotic port run must end where the JAX package's fault-free run of the
# same records ends: the same match multiset (the same set where a
# suspended journal allowed duplicates), typed dead letters, loss ledger
# and canonical state.  The checkpoint.* and overload.enter/exit sites are
# left out as in the JAX harness: their faults defer a transition, which
# legitimately changes the trajectory (covered above).

KEYS = ("k0", "k1", "k2", "k3")
#: tests/test_chaos.py's OVL_FAULTS and OVL_CRASH_P.
CHAOS_FAULTS = (
    ("device.dispatch", 0.10, 1),
    ("device.result", 0.10, 1),
    ("journal.append", 0.10, 1),
    ("journal.fsync", 0.08, 1),
    ("overload.shed", 0.10, 1),  # absorbed by restore and replay in place
    ("device.dispatch", 0.03, 2),  # survives the retry: a crash
)
CRASH_P = 0.06
FAST_SEEDS = list(range(8))  # tests/test_chaos.py's FAST_SEEDS


def chaos_batches(Record, seed):
    """tests/test_chaos.py: gen_overload_batches: six dense flood batches
    of 16 (+1 ms ticks, seed-random keys and values), then twenty sparse
    single records 5 s apart."""
    rng = np.random.default_rng(seed)
    offs = collections.defaultdict(int)
    batches, t = [], 0
    for _ in range(6):
        recs = []
        for _ in range(16):
            t += 1
            k = KEYS[int(rng.integers(len(KEYS)))]
            recs.append(Record(k, int(rng.integers(0, 3)), t, offset=offs[k]))
            offs[k] += 1
        batches.append(recs)
    for _ in range(20):
        t += 5000
        k = KEYS[int(rng.integers(len(KEYS)))]
        batches.append([Record(k, 4, t, offset=offs[k])])
        offs[k] += 1
    return batches


def canon_match(key, seq):
    """A hashable match: the key and each stage's sorted offsets."""
    return (key, tuple(sorted((stage, tuple(sorted(e.offset for e in events)))
                              for stage, events in seq.as_map().items())))


def chaos_sup(p, ck, jr, resume=False, **kw):
    args = (ts.strict3(p.Q), len(KEYS), p.Config(**CFG))
    kw = dict(checkpoint_path=ck, journal_path=jr, checkpoint_every=2, gc_interval=0,
              overload_policy=p.ov.OverloadPolicy(**POLICY), ingest=p.Ingest(**INGEST),
              **p.kw, **kw)
    return p.Sup.resume(*args, **kw) if resume else p.Sup(*args, **kw)


def drain_all(sup, emitted):
    for k, seq in sup.processor.drain_ingest() + sup.processor.flush():
        emitted[canon_match(k, seq)] += 1


def jax_oracle(seed, tmp_path):
    sup = chaos_sup(PKGS["jax"], str(tmp_path / "oracle.ckpt"), str(tmp_path / "oracle.jrnl"))
    emitted, levels = collections.Counter(), []
    for b in chaos_batches(JRecord, seed):
        for k, seq in sup.process(b):
            emitted[canon_match(k, seq)] += 1
        levels.append(sup._overload.level)
    drain_all(sup, emitted)
    return sup, emitted, levels


def port_chaos(seed, tmp_path):
    """tests/test_chaos.py: run_overload_chaos on the port: a crash resumes
    from the committed consumer position (the first batch the restored
    dedup state has not seen), not from 0, since every processed batch is
    one ladder tick."""
    batches = chaos_batches(TRecord, seed)
    rng = np.random.default_rng(seed + 40_000)
    ck, jr = str(tmp_path / "chaos.ckpt"), str(tmp_path / "chaos.jrnl")

    def build(resume=False):
        return chaos_sup(PKGS["torch"], ck, jr, resume=resume, retry_backoff_ms=0)

    sup, emitted = build(), collections.Counter()
    dups_allowed, fired, crashes, i, guard = False, 0, 0, 0, 0
    while i < len(batches):
        guard += 1
        assert guard < 800, "the chaos schedule made no progress"
        armed = []
        for site, p, times in CHAOS_FAULTS:
            if rng.random() < p:
                tfp.FAILPOINTS.arm(site, times=times)
                armed.append(site)
        crash_after = rng.random() < CRASH_P
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
            sup = build(resume=True)
            proc = sup.processor

            def seen(rec):
                lane = proc._lane_of.get(rec.key)
                return lane is not None and rec.offset < proc._guard.source_hw.get(lane, 0)

            i = 0
            while i < len(batches) and all(seen(r) for r in batches[i]):
                i += 1
    drain_all(sup, emitted)
    return sup, emitted, dups_allowed, fired, crashes


@pytest.mark.parametrize("seed", FAST_SEEDS)
def test_overload_chaos_ends_in_the_jax_oracle(seed, tmp_path):
    oracle, want, levels = jax_oracle(seed, tmp_path)
    assert max(levels) >= 3 and levels[-1] == 0, levels
    sup, emitted, dups_allowed, fired, crashes = port_chaos(seed, tmp_path)
    tag = f"seed {seed} (faults {fired}, crashes {crashes})"
    assert sup._overload.level == 0, tag
    g, og = sup.processor._guard, oracle.processor._guard
    lc, olc = g.loss_counters(), og.loss_counters()
    offered = sum(len(b) for b in chaos_batches(TRecord, seed))
    assert offered == g.admitted + lc["overload_shed"] + lc["late_dropped"] + lc[
        "quarantined"], tag
    assert lc == olc and g.admitted == og.admitted, tag
    assert ({(d.record.key, d.record.offset, d.reason) for d in g.dead_letters}
            == {(d.record.key, d.record.offset, d.reason) for d in og.dead_letters}), tag
    if dups_allowed:
        assert set(emitted) == set(want), f"{tag}: the match set diverged"
    else:
        assert emitted == want, f"{tag}: exactly-once violated"
    x, y = state_arrays(j_canonical(oracle.processor.state)), state_arrays(
        t_canonical(sup.processor.state))
    assert x.keys() == y.keys()
    for name in x:
        np.testing.assert_array_equal(x[name], y[name], err_msg=f"{tag} {name}")
    assert not any(sup.processor.counters().values())
    assert not any(oracle.processor.counters().values())
