"""The port's ingestion guard (``runtime/ingest.py``) and the guarded
``CEPProcessor`` against the JAX package's, on the CPU.

The guard alone: the same push / observe / quarantine / release sequences
(numpy-seeded) give the same release order, ``stats()`` and ``to_state()``
in both packages, on a pinned clock.  The processor: ``CEPProcessor(ingest=
IngestPolicy(...))`` in both packages on the cases of ``tests/test_ingest.py``
— bounded-skew shuffles equal to the in-order run, typed quarantine
reasons, late records, the strict mode's message, the dead-letter cap,
depth eviction, source-offset dedup, the columnar refusal, checkpoints with
held records written by either package and restored by both, and the
guard's state round trip — with equal matches, emission order, dead
letters and guard state after every batch.  ``metrics_snapshot`` and
``per_key_cost`` are held against JAX's on one pinned clock.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.runtime import CEPProcessor as JProcessor
from kafkastreams_cep_tpu.runtime import IngestPolicy as JPolicy
from kafkastreams_cep_tpu.runtime import InputRejected as JRejected
from kafkastreams_cep_tpu.runtime import Record as JRecord
from kafkastreams_cep_tpu.runtime import checkpoint as jckpt
from kafkastreams_cep_tpu.runtime import ingest as jingest
from kafkastreams_cep_tpu_torch import CEPProcessor, EngineConfig, Record
from kafkastreams_cep_tpu_torch.runtime import (
    DeadLetter,
    IngestGuard,
    IngestPolicy,
    InputRejected,
    load_checkpoint,
    restore_processor,
    save_checkpoint,
)
from kafkastreams_cep_tpu_torch.runtime import ingest as tingest

ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG = dict(max_runs=16, slab_entries=48, slab_preds=6, dewey_depth=10, max_walk=10)
GRACE = 8
A, B, C, D, X = ts.A, ts.B, ts.C, ts.D, ts.X
VALS = [A, B, C, X, A, B, D, C, A, B, C, X, A, D, B, C, X, A, B, C]
# Metrics keys measured by the wall clock: present in both snapshots, not equal.
WALL = ("device_seconds", "decode_seconds", "pack_seconds", "dispatch_seconds",
        "drain_seconds", "gc_seconds", "events_per_second_device")


class Clock:
    """A pinned clock: 1000.0, 1000.5, 1001.0, ... one step a read."""

    def __init__(self):
        self.t = 999.5

    def __call__(self):
        self.t += 0.5
        return self.t


def trace(vals=VALS, keys=("k0", "k1"), ts0=1000, step=2):
    """``tests/test_ingest.py``'s trace: every key sees every value, at
    globally distinct, increasing timestamps; ``(key, value, ts, offset)``."""
    recs, t = [], 0
    for v in vals:
        for k in keys:
            recs.append((k, v, ts0 + step * t, None))
            t += 1
    return recs


def bounded_shuffle(records, skew, seed):
    """An arrival order whose timestamp inversions are at most ``skew``."""
    rng = np.random.default_rng(seed)
    key = [r[2] + rng.uniform(0, skew) for r in records]
    return [records[i] for i in np.argsort(key, kind="stable")]


def pair(builder=ts.strict3, num_lanes=2, grace=GRACE, latency=None, **pol):
    kw = dict(epoch=0, gc_interval=0, latency=latency)
    jproc = JProcessor(builder(ts.JQuery), num_lanes, JConfig(**CFG), clock=Clock(),
                       ingest=JPolicy(grace_ms=grace, **pol), **kw)
    tproc = CEPProcessor(builder(ts.TQuery), num_lanes, EngineConfig(**CFG), clock=Clock(),
                         ingest=IngestPolicy(grace_ms=grace, **pol), device="cpu", **kw)
    return jproc, tproc


def assert_guards_equal(jproc, tproc):
    # Records and dead letters are named tuples, equal field by field
    # across the packages.
    assert tproc._guard.to_state() == jproc._guard.to_state()
    assert tproc._guard.stats() == jproc._guard.stats()
    assert tproc._lane_of == jproc._lane_of
    np.testing.assert_array_equal(tproc._next_offset, jproc._next_offset)
    np.testing.assert_array_equal(tproc._off_base, jproc._off_base)
    assert tproc.metrics.duplicates_dropped == jproc.metrics.duplicates_dropped
    assert tproc.metrics.records_in == jproc.metrics.records_in


def feed(jproc, tproc, batch):
    """One batch through both processors: equal matches and guard state."""
    if batch is None:
        j, t = jproc.drain_ingest(), tproc.drain_ingest()
    else:
        j = jproc.process([JRecord(*r) for r in batch])
        t = tproc.process([Record(*r) for r in batch])
    assert ts.canon_matches(t) == ts.canon_matches(j)
    assert_guards_equal(jproc, tproc)
    return ts.canon_matches(t)


def run_pair(records, batch=5, builder=ts.strict3, num_lanes=2, **pol):
    jproc, tproc = pair(builder, num_lanes, **pol)
    out = []
    for i in range(0, len(records), batch):
        out += feed(jproc, tproc, records[i:i + batch])
    out += feed(jproc, tproc, None)
    return jproc, tproc, out


# -- the guard alone -----------------------------------------------------------


def test_reason_table_equals_jax():
    assert tingest.REASONS == jingest.REASONS
    assert tingest.REASON_DOCS == jingest.REASON_DOCS
    assert tingest.policy_table_markdown() == jingest.policy_table_markdown()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_guard_equals_jax_on_random_sequences(seed):
    """Random pushes (a bounded shuffle with some late stragglers),
    observed times, quarantines and releases on both guards."""
    rng = np.random.default_rng(seed)
    policy = dict(grace_ms=int(rng.integers(0, 12)), reorder_depth=int(rng.integers(3, 12)),
                  dead_letter_cap=int(rng.integers(1, 5)))
    tg = IngestGuard(IngestPolicy(**policy), clock=Clock())
    jg = jingest.IngestGuard(jingest.IngestPolicy(**policy), clock=Clock())
    recs = bounded_shuffle([(f"k{i % 3}", int(v), 1000 + 3 * i, i)
                            for i, v in enumerate(rng.integers(0, 5, 80))], 15, seed)
    for i, r in enumerate(recs):
        op = rng.random()
        if op < 0.1:
            tg.observe_time(r[2] + 5)
            jg.observe_time(r[2] + 5)
        elif op < 0.2:
            for g, R in ((tg, Record), (jg, JRecord)):
                g.quarantine(R(*r), tingest.REASON_SCHEMA, f"bad {i}", f"corr-{i}")
        elif tg.late_by(r[2]) is not None:
            assert jg.late_by(r[2]) == tg.late_by(r[2])
            for g, R in ((tg, Record), (jg, JRecord)):
                g.quarantine(R(*r), tingest.REASON_LATE, "late", f"corr-{i}")
        else:
            assert jg.late_by(r[2]) is None
            tg.push(Record(*r))
            jg.push(JRecord(*r))
        if rng.random() < 0.3:
            assert tg.release() == jg.release()
            assert tg.last_release_stamps == jg.last_release_stamps
        assert tg.stats() == jg.stats()
        assert tg.held == jg.held and tg.watermark == jg.watermark
    assert tg.to_state() == jg.to_state()
    assert tg.loss_counters() == jg.loss_counters()
    assert tg.reason_counts == jg.reason_counts
    # Each package restores the other's state.
    assert IngestGuard.from_state(jg.to_state()).to_state() == jg.to_state()
    assert jingest.IngestGuard.from_state(tg.to_state()).to_state() == tg.to_state()
    assert tg.drain() == jg.drain()
    assert tg.to_state() == jg.to_state()


def test_guard_state_roundtrip_is_exact():
    g = IngestGuard(IngestPolicy(grace_ms=5, reorder_depth=8), clock=Clock())
    for i, r in enumerate(trace(VALS[:8], keys=("k",))):
        g.push(Record(*r)._replace(offset=i))
        g.source_hw[0] = i + 1
    g.quarantine(Record("k", 99, 1), tingest.REASON_SCHEMA, "detail", "corr-1")
    g.release()
    h = IngestGuard.from_state(g.to_state())
    assert h.to_state() == g.to_state()
    assert h.held == g.held and h.watermark == g.watermark
    assert h.drain() == g.drain()
    assert all(isinstance(d, DeadLetter) for d in h.dead_letters)


def test_policy_validation_equals_jax():
    for bad in (dict(on_bad_record="drop"), dict(grace_ms=-1), dict(reorder_depth=0)):
        with pytest.raises(ValueError) as te:
            IngestPolicy(**bad)
        with pytest.raises(ValueError) as je:
            JPolicy(**bad)
        assert str(te.value) == str(je.value)


def test_admission_limiter_equals_jax():
    t, j = tingest.AdmissionLimiter(1.5, 3), jingest.AdmissionLimiter(1.5, 3)
    rng = np.random.default_rng(5)
    for step in range(40):
        tenant = f"t{int(rng.integers(0, 3))}"
        assert t.admit(tenant) == j.admit(tenant)
        if step % 5 == 4:
            t.refill()
            j.refill()
        if step == 20:
            for lim in (t, j):
                lim.set_pressure(0.5, {"t0": 0.7, "t1": 0.2})
    assert t.to_state() == j.to_state()
    assert tingest.AdmissionLimiter.from_state(j.to_state()).to_state() == j.to_state()


# -- the guarded processor against JAX's (tests/test_ingest.py) ------------------


@pytest.mark.parametrize("builder,seed", [(ts.strict3, 0), (ts.strict3, 1),
                                          (ts.skip_till_any, 0), (ts.skip_till_any, 2)])
def test_bounded_skew_shuffle_equals_in_order(builder, seed):
    recs = trace()
    jref, tref, m_ref = run_pair(recs, builder=builder)
    assert m_ref
    jsh, tsh, m_sh = run_pair(bounded_shuffle(recs, GRACE, seed), builder=builder)
    assert m_sh == m_ref  # content and emission order
    assert tsh.counters() == tref.counters() == jsh.counters()
    assert not any(tsh._guard.loss_counters().values())
    ts.assert_states_equal(jsh.state, tsh.state)


def test_release_waits_for_the_watermark():
    jproc, tproc = pair(num_lanes=1, grace=10)
    assert feed(jproc, tproc, [("k", A, 1000, None)]) == []
    assert tproc._guard.held == 1
    feed(jproc, tproc, [("k", B, 1005, None)])
    assert tproc._guard.held == 2  # watermark 995 < 1000
    feed(jproc, tproc, [("k", C, 1020, None)])  # watermark 1010: A, B release
    assert tproc._guard.held == 1
    assert len(feed(jproc, tproc, None)) == 1
    assert tproc._guard.held == 0


def test_quarantine_typed_reasons():
    jproc, tproc = pair(num_lanes=1, grace=2)
    out = feed(jproc, tproc, [
        ("k0", A, 1000, None),
        ("k0", {"nested": 1}, 1001, None),  # schema: structure
        ("k0", 2.5, 1002, None),  # schema: float in an int field
        ("k0", (1, [2, 3]), 1002, None),  # schema: structure
        ("k1", X, 1003, None),  # lane overflow (one lane)
        ("k0", B, 10**14, None),  # time range
        ("k0", B, 1004, None),
        ("k0", C, 1005, None),
    ])
    out += feed(jproc, tproc, None)
    g = tproc._guard
    assert g.reason_counts == {tingest.REASON_SCHEMA: 3, tingest.REASON_LANE_OVERFLOW: 1,
                               tingest.REASON_TIME_RANGE: 1}
    # Details, reasons and correlation ids equal JAX's (feed compared them).
    assert all(d.corr == "stream-1" for d in g.dead_letters)
    assert "PyTreeDef({'nested': *})" in g.dead_letters[0].detail
    assert [(k, {st: [e[0] for e in evs] for st, evs in m}) for k, m in out] == [
        ("k0", {"first": [0], "second": [1], "latest": [2]})
    ]


def test_late_records_are_dead_lettered():
    recs = [("k", A, 1000, None), ("k", B, 1050, None), ("k", C, 1001, None)]
    jproc, tproc, _ = run_pair(recs, batch=1, num_lanes=1)
    g = tproc._guard
    assert g.late_dropped == 1
    assert g.dead_letters[-1].reason == tingest.REASON_LATE
    assert "behind the watermark" in g.dead_letters[-1].detail


def test_strict_mode_raises_the_same_message():
    jproc, tproc = pair(num_lanes=1, grace=2, on_bad_record="raise")
    batch = [("k0", A, 1000, None), ("k0", {"bad": 1}, 1001, None)]
    with pytest.raises(JRejected) as je:
        jproc.process([JRecord(*r) for r in batch])
    with pytest.raises(InputRejected) as te:
        tproc.process([Record(*r) for r in batch])
    assert str(te.value) == str(je.value)
    assert "record 1" in str(te.value) and "'k0'" in str(te.value)


def test_dead_letter_cap_drops_oldest_and_counts():
    jproc, tproc = pair(num_lanes=1, grace=0, dead_letter_cap=2)
    feed(jproc, tproc, [("k", A, 1000, None)]
         + [("k", {"bad": i}, 1001 + i, None) for i in range(4)])
    g = tproc._guard
    assert len(g.dead_letters) == 2 and g.dead_letter_dropped == 2
    assert g.quarantined == 4


def test_reorder_depth_eviction_is_counted():
    recs = bounded_shuffle(trace(keys=("k",)), GRACE, 9)
    _, tproc, _ = run_pair(recs, num_lanes=1, grace=10**6, reorder_depth=4)
    g = tproc._guard
    assert g.reorder_evictions > 0
    assert g.admitted == g.released == tproc.metrics.records_in


def test_admission_dedup_absorbs_source_offset_replay():
    recs = [("k", v, 1000 + 2 * i, i) for i, v in enumerate([A, B, C])]
    jproc, tproc = pair(num_lanes=1, grace=2)
    out = feed(jproc, tproc, recs)
    out += feed(jproc, tproc, recs)  # at-least-once re-delivery
    out += feed(jproc, tproc, None)
    assert tproc.metrics.duplicates_dropped == 3
    assert len(out) == 1


def test_guard_refuses_the_columnar_path():
    _, tproc = pair(num_lanes=1)
    with pytest.raises(ValueError, match="per-record path"):
        tproc.process_columns(np.zeros(1, np.int64), np.zeros(1, np.int64),
                              np.zeros(1, np.int64))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_with_held_records_cross_loads(writer, tmp_path):
    """A snapshot taken with records held in the guard (and dead letters)
    restores into both packages; the rest of the stream then finishes
    equal in both and equal to the uninterrupted run."""
    recs = bounded_shuffle(trace(), GRACE, 3)
    recs.insert(4, ("k0", {"bad": 1}, 1003, None))  # a dead letter in the snapshot
    _, _, m_ref = run_pair(recs)
    jproc, tproc = pair()
    out = []
    for i in range(0, 10, 5):
        out += feed(jproc, tproc, recs[i:i + 5])
    assert tproc._guard.held > 0 and tproc._guard.dead_letters
    path = str(tmp_path / "held.ckpt")
    (jckpt.save_checkpoint if writer == "jax" else save_checkpoint)(
        jproc if writer == "jax" else tproc, path)
    jres = jckpt.restore_processor(ts.strict3(ts.JQuery), path)
    tres = restore_processor(ts.strict3(ts.TQuery), path, device="cpu")
    assert all(type(e[2]) is Record for e in tres._guard._heap)
    assert all(type(d) is DeadLetter and type(d.record) is Record
               for d in tres._guard.dead_letters)
    assert tres._guard.policy == tproc._guard.policy
    jres.set_clock(Clock())
    tres.set_clock(Clock())
    ts.assert_states_equal(jres.state, tres.state)
    for i in range(10, len(recs), 5):
        out += feed(jres, tres, recs[i:i + 5])
    out += feed(jres, tres, None)
    assert out == m_ref
    assert tres._guard.loss_counters() == dict(
        late_dropped=0, quarantined=1, reorder_evictions=0, overload_shed=0)
    ts.assert_states_equal(jres.state, tres.state)


def test_jax_checkpoint_loads_without_the_jax_package(tmp_path):
    """The port's unpickler maps the JAX package's Record, DeadLetter and
    Event to its own classes: a JAX-written snapshot with held records
    and dead letters restores where neither ``jax`` nor the JAX package
    can be imported."""
    recs = bounded_shuffle(trace(), GRACE, 4) + [("k0", 2.5, 1040, None)]
    jproc, tproc = pair()
    feed(jproc, tproc, recs[:12])
    feed(jproc, tproc, recs[-1:])
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(jproc, path)
    (tmp_path / "port_queries.py").write_text(
        "def strict3(Q):\n"
        "    return (Q().select('first').where(lambda k, v, ts, st: v == 0)\n"
        "            .then().select('second').where(lambda k, v, ts, st: v == 1)\n"
        "            .then().select('latest').where(lambda k, v, ts, st: v == 2)\n"
        "            .build())\n")
    script = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'kafkastreams_cep_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path[:0] = [{os.path.abspath(ROOT)!r}, {str(tmp_path)!r}]\n"
        "from kafkastreams_cep_tpu_torch import Query\n"
        "from kafkastreams_cep_tpu_torch.runtime import DeadLetter, Record, restore_processor\n"
        "import port_queries\n"
        f"p = restore_processor(port_queries.strict3(Query), {path!r}, device='cpu')\n"
        "assert all(type(e[2]) is Record for e in p._guard._heap)\n"
        "assert all(type(d) is DeadLetter for d in p._guard.dead_letters)\n"
        "print('held', p._guard.held, 'dead', len(p._guard.dead_letters))\n"
    )
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert f"held {jproc._guard.held} dead 1" in res.stdout
    assert load_checkpoint(path)["header"]["ingest"]["heap"]


# -- metrics_snapshot and per_key_cost ------------------------------------------


def assert_snapshots_equal(jsnap, tsnap):
    """Every key JAX reports but ``hbm`` is in both, and equal (the
    ``latency`` ledger too, on the pinned clock) but the wall-clock keys and
    ``trace_cache`` (each package's own cache: the same stats keys);
    ``phases`` has the same phases, each observed as many times.  The port
    adds one key of its own, ``layers`` (the child spans inside the phases
    and their work counts, which the JAX package does not time)."""
    skip = {"phases", "hbm"}
    assert "layers" in tsnap and "layers" not in jsnap
    assert {k: v["count"] for k, v in tsnap["phases"].items()} == {
        k: v["count"] for k, v in jsnap["phases"].items()}
    tsnap = {k: v for k, v in tsnap.items() if k not in ("phases", "layers")}
    jkeys = set(jsnap) - skip
    if "events_per_second_device" in jkeys and "events_per_second_device" not in tsnap:
        assert tsnap["device_seconds"] == 0.0  # rounded away on a fast CPU run
        jkeys.discard("events_per_second_device")
    assert set(tsnap) - {"hbm"} == jkeys
    for k in sorted(jkeys):
        if k in WALL:
            assert isinstance(tsnap[k], float), k
        elif k == "trace_cache":
            assert set(tsnap[k]) == set(jsnap[k]), k
        else:
            assert tsnap[k] == jsnap[k], k
    assert tsnap["hbm"] == {}


@pytest.mark.parametrize("guarded", [True, False])
def test_metrics_snapshot_equals_jax(guarded):
    recs = bounded_shuffle(trace(keys=("k0", "k1", "k2")), GRACE, 5)
    recs.insert(7, ("k0", {"bad": 1}, 1010, None))
    if guarded:
        jproc, tproc = pair(builder=ts.skip_till_any, num_lanes=3, latency=True)
    else:
        recs = [r for r in sorted(recs, key=lambda r: r[2]) if not isinstance(r[1], dict)]
        jproc = JProcessor(ts.skip_till_any(ts.JQuery), 3, JConfig(**CFG), epoch=0,
                           clock=Clock(), name="q1", latency=True)
        tproc = CEPProcessor(ts.skip_till_any(ts.TQuery), 3, EngineConfig(**CFG), epoch=0,
                             clock=Clock(), name="q1", device="cpu", latency=True)
    for i in range(0, len(recs), 6):
        j = jproc.process([JRecord(*r) for r in recs[i:i + 6]])
        t = tproc.process([Record(*r) for r in recs[i:i + 6]])
        assert ts.canon_matches(t) == ts.canon_matches(j)
    jsnap, tsnap = jproc.metrics_snapshot(), tproc.metrics_snapshot()
    assert_snapshots_equal(jsnap, tsnap)
    assert tsnap["per_key"]["total_hops"] > 0 and tsnap["per_key"]["top"]
    assert ("dead_letters" in tsnap) == guarded
    assert tsnap["watermark"] is not None and tsnap["event_time_lag_ms"] is not None
    assert tsnap["latency"]["records"] == tproc.metrics.records_in > 0
    assert "per_lane" not in tproc.metrics_snapshot(per_lane=False)
    for top_k in (1, 2, 8):
        assert tproc.per_key_cost(top_k) == jproc.per_key_cost(top_k)
