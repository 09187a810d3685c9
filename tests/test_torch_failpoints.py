"""The port's fault-injection harness (``utils/failpoints.py``) against the
JAX package's, after ``tests/test_failpoints.py``: the registry fires on
the same schedule and raises the same exception family per site; the same
seed gives the same random schedule; the journal-tail forgeries write the
same bytes; and each production site the port has fails the way the JAX
site does (a journal append rolls back, a snapshot failure keeps the old
snapshot, ``drop_checkpoint_rename`` recreates the pre-rename world)."""

import os

import pytest

import torch_scenarios as ts
from kafkastreams_cep_tpu.utils import failpoints as jfp
from kafkastreams_cep_tpu_torch import EngineConfig
from kafkastreams_cep_tpu_torch.native.journal import Journal
from kafkastreams_cep_tpu_torch.runtime import Record, Supervisor
from kafkastreams_cep_tpu_torch.utils import failpoints as fp

CFG = EngineConfig(max_runs=16, slab_entries=48, slab_preds=6, dewey_depth=10, max_walk=10)


@pytest.fixture(autouse=True)
def _clean_registries():
    fp.FAILPOINTS.clear()
    jfp.FAILPOINTS.clear()
    yield
    fp.FAILPOINTS.clear()
    jfp.FAILPOINTS.clear()


def fired(mod, site, n, **arm):
    """Which of ``n`` hits of ``site`` raise, and with which class name."""
    mod.FAILPOINTS.arm(site, **arm)
    out = []
    for i in range(n):
        try:
            mod.fire(site)
        except (mod.InjectedFault, mod.InjectedIOError) as e:
            out.append((i, type(e).__name__))
    return out, mod.FAILPOINTS.hits(site)


@pytest.mark.parametrize("site, arm", [
    ("journal.append", dict(hits=[1, 3])), ("device.result", dict(times=2)),
    ("device.dispatch", dict(times=1)), ("checkpoint.save", dict(hits=[0])),
    ("checkpoint.rename", dict(times=3)), ("quarantine.enter", dict(hits=[2])),
])
def test_registry_fires_as_the_jax_one(site, arm):
    assert fired(fp, site, 5, **arm) == fired(jfp, site, 5, **arm)


def test_disarmed_fire_is_noop_and_sessions_clear():
    fp.fire("device.dispatch")
    assert fp.FAILPOINTS.hits("device.dispatch") == 0
    with fp.FAILPOINTS.session({"journal.append": [0]}):
        with pytest.raises(fp.InjectedIOError):
            fp.fire("journal.append")
    fp.fire("journal.append")
    assert fp.FAILPOINTS.hits("journal.append") == 0


@pytest.mark.parametrize("seed, horizon, rate", [(7, 40, 0.3), (8, 40, 0.3), (0, 100, 0.05),
                                                 (123, 16, 0.5)])
def test_random_schedule_is_the_jax_one(seed, horizon, rate):
    got = fp.random_schedule(seed=seed, horizon=horizon, rate=rate)
    assert got == jfp.random_schedule(seed=seed, horizon=horizon, rate=rate)
    assert got == fp.random_schedule(seed=seed, horizon=horizon, rate=rate)
    assert tuple(fp.SITES) == tuple(jfp.SITES)


@pytest.mark.parametrize("forge, kw", [
    ("tear_journal_tail", {}), ("tear_journal_tail", dict(payload=b"xyz", keep=9)),
    ("corrupt_journal_tail", dict(nbytes=32, seed=3)), ("corrupt_journal_tail", {}),
])
def test_forgeries_write_the_jax_bytes(tmp_path, forge, kw):
    paths = []
    for name, mod in (("t", fp), ("j", jfp)):
        path = str(tmp_path / f"{name}.jrnl")
        Journal(path).append(b"a")
        getattr(mod, forge)(path, **kw)
        paths.append(path)
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b
    j = Journal(paths[0])
    assert list(j.replay()) == [b"a"]  # the tail repaired
    j.append(b"b")
    assert list(j.replay()) == [b"a", b"b"]


def test_drop_checkpoint_rename(tmp_path):
    ck = str(tmp_path / "d.ckpt")
    with open(ck, "wb") as f:
        f.write(b"snap")
    fp.drop_checkpoint_rename(ck)
    assert not os.path.exists(ck) and open(ck + ".tmp", "rb").read() == b"snap"


@pytest.mark.parametrize("site", ["journal.append", "journal.fsync"])
def test_journal_append_sites_roll_back_cleanly(tmp_path, site):
    path = str(tmp_path / "r.jrnl")
    j = Journal(path)
    j.append(b"one")
    size = os.path.getsize(path)
    fp.FAILPOINTS.arm(site, times=1)
    with pytest.raises(fp.InjectedIOError):
        j.append(b"two")
    assert os.path.getsize(path) == size
    j.append(b"three")
    assert list(j.replay()) == [b"one", b"three"]


def test_journal_failure_forces_immediate_checkpoint(tmp_path):
    sup = Supervisor(ts.strict3(ts.TQuery), 1, CFG, checkpoint_path=str(tmp_path / "f.ckpt"),
                     journal_path=str(tmp_path / "f.jrnl"), checkpoint_every=100,
                     gc_interval=0, device="cpu")
    fp.FAILPOINTS.arm("journal.append", times=1)
    sup.process([Record("k", ts.A, 1, offset=0)])
    assert sup.journal_failures == 1 and sup.checkpoints == 1
    assert not sup._journal_suspended


@pytest.mark.parametrize("site", ["checkpoint.save", "checkpoint.rename"])
def test_checkpoint_sites_are_failures_not_corruption(tmp_path, site):
    ck = str(tmp_path / "c.ckpt")
    sup = Supervisor(ts.strict3(ts.TQuery), 1, CFG, checkpoint_path=ck, checkpoint_every=1,
                     gc_interval=0, device="cpu")
    sup.process([Record("k", ts.A, 1, offset=0)])
    good = open(ck, "rb").read()
    fp.FAILPOINTS.arm(site, times=1)
    sup.process([Record("k", ts.B, 2, offset=1)])
    assert sup.checkpoint_failures == 1 and open(ck, "rb").read() == good
    out = sup.process([Record("k", ts.C, 3, offset=2)])
    assert sup.checkpoints == 2 and len(out) == 1


# -- the ingest, surgery and reporter sites -----------------------------------------


def guarded_stream():
    vals = [ts.A, ts.B, ts.C, ts.X, ts.A, ts.B, ts.C, ts.X, ts.A, ts.B, ts.C]
    return [(k, v, 1000 + 2 * i + j, i) for i, v in enumerate(vals) for j, k in enumerate("ab")]


@pytest.mark.parametrize("site", ["ingest.admit", "ingest.release"])
def test_ingest_sites_recover_as_the_jax_supervisor(tmp_path, site):
    """A fault at the guard's admission (nothing admitted) or at its release
    (the buffer moved, the engine saw nothing) on the third batch: the
    supervisor restores the buffer and re-admits, and the stream equals
    the fault-free one, in both packages alike."""
    from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
    from kafkastreams_cep_tpu.runtime import IngestPolicy as JPolicy
    from kafkastreams_cep_tpu.runtime import Record as JRecord
    from kafkastreams_cep_tpu.runtime import Supervisor as JSupervisor
    from kafkastreams_cep_tpu_torch.runtime import IngestPolicy

    def run(side, armed):
        jax_side = side == "jax"
        S, R = (JSupervisor, JRecord) if jax_side else (Supervisor, Record)
        mod = jfp if jax_side else fp
        conf = JConfig(**CFG.__dict__) if jax_side else CFG
        kw = {} if jax_side else {"device": "cpu"}
        sup = S(ts.strict3(ts.JQuery if jax_side else ts.TQuery), 2, conf,
                checkpoint_path=str(tmp_path / f"{side}{armed}.ckpt"), checkpoint_every=2,
                retry_backoff_ms=0, gc_interval=0, epoch=0,
                ingest=(JPolicy if jax_side else IngestPolicy)(grace_ms=4), **kw)
        recs = [R(*r) for r in guarded_stream()]
        out = []
        with mod.FAILPOINTS.session({site: [2]} if armed else {}):
            for i in range(0, len(recs), 4):
                out += sup.process(recs[i:i + 4])
            hits = mod.FAILPOINTS.hits(site)
        out += sup.drain_ingest()
        return ts.canon_matches(out), sup.recoveries, hits

    clean = run("torch", False)
    got = run("torch", True)
    assert got == run("jax", True)
    assert got[0] == clean[0] and got[0] and got[1] == 1 and got[2] > 2


def test_surgery_sites_leave_the_processor_intact():
    """``replan.swap`` and ``rebalance.move`` fire before anything changes:
    the armed call raises, and the live processor goes on to emit the
    stream of one never touched."""
    from kafkastreams_cep_tpu_torch.runtime import CEPProcessor
    from kafkastreams_cep_tpu_torch.runtime.migrate import move_lanes, replan_processor

    tiered = EngineConfig(max_runs=32, slab_entries=96, slab_preds=12, dewey_depth=20,
                          max_walk=12, tiering=True, stage_attribution=True)
    recs = [Record(k, v, 1000 + 2 * i + j) for i, v in enumerate(
        [ts.A, ts.B, ts.C, ts.C, ts.D, ts.A, ts.B, ts.C, ts.D]) for j, k in enumerate("ab")]
    ref = CEPProcessor(ts.skip_till_any(ts.TQuery), 2, tiered, gc_interval=0, device="cpu")
    proc = CEPProcessor(ts.skip_till_any(ts.TQuery), 2, tiered, gc_interval=0, device="cpu")
    want = ref.process(recs[:8]) + ref.process(recs[8:])
    got = proc.process(recs[:8])
    profile = proc.metrics_snapshot(per_lane=False)["per_stage"]
    for site, call in (("replan.swap", lambda: replan_processor(
            ts.skip_till_any(ts.TQuery), proc, profile)),
            ("rebalance.move", lambda: move_lanes(ts.skip_till_any(ts.TQuery), proc, [1, 0]))):
        with fp.FAILPOINTS.session({site: [0]}):
            with pytest.raises((fp.InjectedFault, fp.InjectedIOError)) as got_exc:
                call()
            assert fp.FAILPOINTS.hits(site) == 1
        with jfp.FAILPOINTS.session({site: [0]}):
            with pytest.raises((jfp.InjectedFault, jfp.InjectedIOError)) as want_exc:
                jfp.fire(site)
        assert type(got_exc.value).__name__ == type(want_exc.value).__name__
    got += proc.process(recs[8:])
    assert ts.canon_matches(got) == ts.canon_matches(want) and want


def test_report_write_leaves_no_torn_line(tmp_path):
    """``report.write`` fires between serializing a metrics record and its
    single write: the failed flush adds nothing, as in the JAX reporter."""
    import json

    from kafkastreams_cep_tpu_torch.utils.telemetry import JsonlTraceSink, Reporter

    path = str(tmp_path / "metrics.jsonl")
    sink = JsonlTraceSink(path)
    reporter = Reporter(lambda: {"records_in": 7}, sink, every_batches=1)
    with fp.FAILPOINTS.session({"report.write": [1]}):
        reporter.tick()
        with pytest.raises(OSError):
            reporter.tick()
        reporter.tick()
    sink.close()
    with open(path) as f:
        lines = f.read().splitlines()
    assert len(lines) == 2
    assert all(json.loads(line)["snapshot"] == {"records_in": 7} for line in lines)
