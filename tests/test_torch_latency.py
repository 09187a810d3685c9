"""The port's latency ledger (``utils/latency.py``) and its hooks in the
processor, checkpoint, migration and supervisor, against the JAX package's,
on the CPU.

``tests/test_latency.py``'s cases run through both packages side by side on
the same pinned fake clock (every read advances it one step), so a snapshot
of the port's ledger equals the JAX package's value for value: the port
reads the clock at the same points, in the same order.  Checkpoints carrying
a ledger cross-load both ways; a migration carries the ledger by reference;
``Supervisor.resume`` keeps the SLO burn window on the pinned clock.
"""

import json

import pytest

import engine_scenarios as sc
import torch_scenarios as ts
from kafkastreams_cep_tpu.runtime import CEPProcessor as JProcessor
from kafkastreams_cep_tpu.runtime import Record as JRecord
from kafkastreams_cep_tpu.runtime import Supervisor as JSupervisor
from kafkastreams_cep_tpu.runtime import checkpoint as jckpt
from kafkastreams_cep_tpu.runtime.ingest import IngestPolicy as JPolicy
from kafkastreams_cep_tpu.runtime.migrate import migrate_processor as jmigrate
from kafkastreams_cep_tpu.utils import latency as jlat
from kafkastreams_cep_tpu.utils.telemetry import render_prometheus as jrender
from kafkastreams_cep_tpu_torch import CEPProcessor, EngineConfig, Record, Supervisor
from kafkastreams_cep_tpu_torch.runtime import (
    IngestPolicy,
    load_checkpoint,
    migrate_processor,
    restore_processor,
    save_checkpoint,
)
from kafkastreams_cep_tpu_torch.utils import latency as tlat
from kafkastreams_cep_tpu_torch.utils.latency import SEGMENTS
from kafkastreams_cep_tpu_torch.utils.telemetry import render_prometheus

CFG = dict(max_runs=16, slab_entries=48, slab_preds=6, dewey_depth=10, max_walk=10)
VALS = [sc.A, sc.B, sc.C, sc.X, sc.A, sc.B, sc.C, sc.X, sc.A, sc.B, sc.C, sc.X]


class FakeClock:
    """``tests/test_latency.py``'s clock: every read advances ``step``."""

    def __init__(self, t0: float = 1000.0, step: float = 0.001):
        self.t = float(t0)
        self.step = float(step)

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def trace(R, vals, key="k", t0=1000):
    return [R(key, v, t0 + i) for i, v in enumerate(vals)]


def pair(ingest=None, **kw):
    """The same processor in both packages, each on its own fake clock
    (``clock=``/``latency=`` kwargs are built per package by callables)."""
    def build(P, Q, Config, Policy, dev):
        args = {k: (v() if callable(v) and k in ("clock", "latency") else v)
                for k, v in kw.items()}
        if ingest is not None:
            args["ingest"] = Policy(**ingest)
        return P(ts.strict3(Q), args.pop("num_lanes", 1), Config(**args.pop("cfg", CFG)),
                 gc_interval=0, **dev, **args)

    from kafkastreams_cep_tpu.engine import EngineConfig as JConfig

    return (build(JProcessor, ts.JQuery, JConfig, JPolicy, {}),
            build(CEPProcessor, ts.TQuery, EngineConfig, IngestPolicy, {"device": "cpu"}))


def feed(procs, vals=VALS, chunk=3, t0=1000):
    """The same batches through both processors; equal matches."""
    out = ([], [])
    for i in range(0, len(vals), chunk):
        for side, (P, R) in enumerate(((procs[0], JRecord), (procs[1], Record))):
            out[side].extend(P.process(trace(R, vals, t0=t0)[i:i + chunk]))
    assert ts.canon_matches(out[1]) == ts.canon_matches(out[0])
    return out


def lat_snaps(procs):
    j, t = (p.metrics_snapshot(per_lane=False)["latency"] for p in procs)
    assert t == j
    return t


def seg_sums(lat):
    return {name: seg["sum"] for name, seg in lat["segments"].items()}


# -- conservation ---------------------------------------------------------------


@pytest.mark.parametrize("grace,drain", [(0, 1), (3, 1), (0, 2), (3, 2)])
def test_segment_sums_reconcile_and_equal_jax(grace, drain):
    procs = pair(ingest=dict(grace_ms=grace) if grace else None, drain_interval=drain,
                 clock=FakeClock, latency=True)
    feed(procs)
    for p in procs:
        p.flush()
        if grace:
            p.drain_ingest()
    lat = lat_snaps(procs)
    sums = seg_sums(lat)
    assert sum(sums[n] for n in SEGMENTS) == pytest.approx(sums["e2e_total"], rel=1e-9,
                                                           abs=1e-9)
    counts = {name: seg["count"] for name, seg in lat["segments"].items()}
    assert len(set(counts.values())) == 1
    assert counts["e2e_total"] == lat["records"] == len(VALS)
    assert lat["deferred_batches"] == 0


def test_reorder_hold_under_guard_equals_jax():
    procs = pair(ingest=dict(grace_ms=5), clock=lambda: FakeClock(step=0.01), latency=True)
    for P, R in zip(procs, (JRecord, Record)):
        P.process(trace(R, [sc.A, sc.B, sc.C]))
        P.drain_ingest()
    assert seg_sums(lat_snaps(procs))["reorder_hold"] > 0
    bare = pair(clock=lambda: FakeClock(step=0.01), latency=True)
    feed(bare, [sc.A, sc.B, sc.C])
    assert seg_sums(lat_snaps(bare))["reorder_hold"] == 0.0


def test_lazy_drain_deferral_equals_jax():
    procs = pair(cfg=dict(CFG, lazy_extraction=True), drain_interval=4,
                 clock=lambda: FakeClock(step=0.005), latency=True)
    for P, R in zip(procs, (JRecord, Record)):
        P.process(trace(R, [sc.A, sc.B]))
        P.process(trace(R, [sc.C, sc.X], t0=1010))
    lat = lat_snaps(procs)
    assert lat["deferred_batches"] == 2 and lat["records"] == 0
    for p in procs:
        p.flush()
    lat = lat_snaps(procs)
    assert lat["deferred_batches"] == 0 and lat["records"] == 4
    assert lat["segments"]["drain_defer"]["sum"] > 0


# -- determinism / parity -------------------------------------------------------


def test_snapshot_determinism_equals_jax():
    a = pair(num_lanes=2, clock=FakeClock, latency=True)
    feed(a)
    b = pair(num_lanes=2, clock=FakeClock, latency=True)
    feed(b)
    sa, sb = lat_snaps(a), lat_snaps(b)
    assert sa == sb
    assert json.dumps(sa, sort_keys=True) == json.dumps(sb, sort_keys=True)


@pytest.mark.parametrize("scan_kernel", [False, True])
def test_ledger_on_off_parity(monkeypatch, scan_kernel):
    """Arming the ledger changes no match, order or counter, per step and
    through the whole-scan path (``CEP_SCAN_KERNEL=1``: its plain version
    on the CPU); the JAX processor (no kernel) emits the same stream."""
    if scan_kernel:
        monkeypatch.setenv("CEP_SCAN_KERNEL", "1")
    on = CEPProcessor(ts.strict3(ts.TQuery), 2, EngineConfig(**CFG), gc_interval=0,
                      clock=FakeClock(), latency=True, device="cpu")
    off = CEPProcessor(ts.strict3(ts.TQuery), 2, EngineConfig(**CFG), gc_interval=0,
                       device="cpu")
    assert on.uses_scan_kernel == scan_kernel
    monkeypatch.delenv("CEP_SCAN_KERNEL", raising=False)
    from kafkastreams_cep_tpu.engine import EngineConfig as JConfig

    j_on = JProcessor(ts.strict3(ts.JQuery), 2, JConfig(**CFG), gc_interval=0)
    j_off = JProcessor(ts.strict3(ts.JQuery), 2, JConfig(**CFG), gc_interval=0)
    m_on, m_off = feed((j_on, on)), feed((j_off, off))
    assert ts.canon_matches(m_on[1]) == ts.canon_matches(m_off[1]) and m_on[1]
    assert on.counters() == off.counters() == j_on.counters()
    assert off.ledger is None and on.ledger.records_committed == len(VALS)


# -- merge algebra --------------------------------------------------------------


def _ledger_with(mod, corr, seconds, clock_t0=0.0, query=None, stall=None):
    led = mod.LatencyLedger(clock=lambda: clock_t0)
    b = mod.BatchLatency(corr, 2, None, release=clock_t0)
    b.dispatch = clock_t0 + seconds / 4
    b.complete = clock_t0 + seconds / 2
    led.commit(b, emit=clock_t0 + seconds)
    if query:
        led.observe_query(query, seconds)
    if stall:
        led.observe_stall(stall, seconds, corr=corr)
    return led


def test_merge_algebra_equals_jax():
    def run(mod):
        a = _ledger_with(mod, "a-1", 0.004, query="q0", stall="recover")
        b = _ledger_with(mod, "b-1", 0.4, query="q0", stall="evacuate")
        c = _ledger_with(mod, "c-1", 4.0, query="q1")
        left, right = a.merge(b).merge(c).snapshot(), a.merge(b.merge(c)).snapshot()
        assert left == right
        assert a.merge(b).snapshot() == b.merge(a).snapshot()
        return (left, a.merge(b).exemplars, a.merge(b).merge(c).to_state())

    got = run(tlat)
    assert got == run(jlat)
    assert got[0]["records"] == 6 and got[1]["stall.recover"]["corr"] == "a-1"
    for mod in (tlat, jlat):
        with pytest.raises(ValueError, match="different edges"):
            mod.LatencyLedger().merge(mod.LatencyLedger(edges=(0.1, 1.0)))


# -- durability -----------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_cross_load_exactly_once(tmp_path, writer):
    """A snapshot with a ledger, written by either package, restores in
    both with the same ledger state; replaying the lost batch on the
    pinned clock re-observes it once, equal in both."""
    procs = pair(ingest=dict(grace_ms=0), clock=FakeClock, latency=True)
    pre, post = [sc.A, sc.B, sc.C], [sc.A, sc.B, sc.C]
    for P, R in zip(procs, (JRecord, Record)):
        P.process(trace(R, pre))
    path = str(tmp_path / "lat.ckpt")
    src = procs[0] if writer == "jax" else procs[1]
    (jckpt.save_checkpoint if writer == "jax" else save_checkpoint)(src, path)
    want = src.ledger.to_state()
    assert load_checkpoint(path)["header"]["latency"] == want
    res = (jckpt.restore_processor(ts.strict3(ts.JQuery), path),
           restore_processor(ts.strict3(ts.TQuery), path, device="cpu"))
    for r in res:
        assert r.ledger is not None and r.ledger.to_state() == want
    res[0].set_clock(FakeClock(2000.0))
    res[1].set_clock(FakeClock(2000.0))
    feed(res, post, t0=1010)
    lat = lat_snaps(res)
    assert res[1].ledger.records_committed == len(pre) + len(post)
    sums = seg_sums(lat)
    assert sum(sums[n] for n in SEGMENTS) == pytest.approx(sums["e2e_total"], rel=1e-9)


def test_ledger_rides_migration_by_reference():
    procs = pair(clock=FakeClock, latency=True)
    feed(procs, [sc.A, sc.B, sc.C])
    wide = dict(CFG, max_runs=32, slab_entries=64)
    from kafkastreams_cep_tpu.engine import EngineConfig as JConfig

    moved = (jmigrate(ts.strict3(ts.JQuery), procs[0], JConfig(**wide)),
             migrate_processor(ts.strict3(ts.TQuery), procs[1], EngineConfig(**wide)))
    assert moved[1].ledger is procs[1].ledger and moved[0].ledger is procs[0].ledger
    feed(moved, [sc.A, sc.B, sc.C], t0=1010)
    assert moved[1].ledger.records_committed == 6
    lat_snaps(moved)


# -- SLO ------------------------------------------------------------------------


def test_slo_tracker_burn_math_equals_jax():
    def run(mod):
        t = mod.SLOTracker(threshold_s=0.1, target=0.99, window=3)
        t.observe(1, 10)
        out = [t.burn_rate()]
        for _ in range(5):
            t.observe(0, 10)
        out += [len(t._pairs), t.burn_rate(), t.snapshot(), t.to_state()]
        for bad in (dict(threshold_s=0.1, target=1.5), dict(threshold_s=0.0)):
            with pytest.raises(ValueError):
                mod.SLOTracker(**bad)
        return out

    got = run(tlat)
    assert got == run(jlat)
    assert got[0] == pytest.approx(10.0) and got[1] == 3 and got[2] == 0.0


def test_slo_burn_exported_from_processor_equals_jax():
    procs = pair(clock=lambda: FakeClock(step=0.01), latency=None)
    for p, mod in zip(procs, (jlat, tlat)):
        p.ledger = mod.LatencyLedger(clock=FakeClock(step=0.01),
                                     slo=mod.SLOTracker(threshold_s=1e-6))
    feed(procs, [sc.A, sc.B, sc.C])
    snap = procs[1].metrics_snapshot(per_lane=False)
    slo = lat_snaps(procs)["slo"]
    assert slo["window_over"] == slo["window_records"] == 3
    assert slo["burn_rate"] == pytest.approx(100.0)
    txt = render_prometheus(snap)
    assert "cep_slo_burn 100" in txt and "# TYPE cep_slo_burn gauge" in txt


def test_slo_burn_window_survives_supervisor_resume(tmp_path):
    """The SLO window rides the checkpoint header and ``Supervisor.resume``
    re-pins the clock on the restored ledger and guard; the port's
    supervisor equals the JAX one's burn before and after the crash."""
    def run(side):
        jax_side = side == "jax"
        S = JSupervisor if jax_side else Supervisor
        R = JRecord if jax_side else Record
        mod = jlat if jax_side else tlat
        from kafkastreams_cep_tpu.engine import EngineConfig as JConfig

        cfg = (JConfig if jax_side else EngineConfig)(**CFG)
        pat = ts.strict3(ts.JQuery if jax_side else ts.TQuery)
        clock = FakeClock(step=0.01)
        kw = dict(checkpoint_path=str(tmp_path / f"{side}.ckpt"),
                  journal_path=str(tmp_path / f"{side}.jrnl"), checkpoint_every=1,
                  gc_interval=0, ingest=(JPolicy if jax_side else IngestPolicy)(grace_ms=0),
                  clock=clock,
                  latency=mod.LatencyLedger(slo=mod.SLOTracker(threshold_s=1e-6), clock=clock))
        if not jax_side:
            kw["device"] = "cpu"
        sup = S(pat, 1, cfg, **kw)
        for i, v in enumerate([sc.A, sc.B, sc.C]):
            sup.process([R("k", v, 1000 + i, offset=i)])
        burn = sup.processor.ledger.slo.burn_rate()
        del sup
        sup2 = S.resume(pat, 1, cfg, **kw)
        led = sup2.processor.ledger
        assert led.clock is clock and sup2.processor._guard._clock is clock
        resumed = led.slo.burn_rate()
        sup2.process([R("k", sc.A, 2000, offset=3)])
        return burn, resumed, led.records_committed, led.slo.burn_rate(), led.snapshot()

    got = run("torch")
    assert got == run("jax")
    assert got[0] > 0 and got[1] == pytest.approx(got[0]) and got[2] == 4 and got[3] > 0


# -- rendering / exemplars ------------------------------------------------------


def test_prometheus_latency_families_equal_jax():
    def snap(mod):
        led = _ledger_with(mod, "stream-1", 0.4, query="q0", stall="recover")
        led.slo = mod.SLOTracker(threshold_s=0.1)
        led.slo.observe(1, 2)
        return {"latency": led.snapshot()}

    txt = render_prometheus(snap(tlat))
    assert txt == jrender(snap(jlat))
    for want in ('cep_latency_seconds_bucket{segment="e2e_total",le=',
                 'cep_latency_seconds_count{segment="queue"} 2',
                 'cep_stall_seconds_count{cause="recover"} 1',
                 'cep_latency_query_seconds_count{query="q0"} 1', "cep_slo_burn 50",
                 "cep_latency_batches_total 1", "cep_latency_records_total 2",
                 "# TYPE cep_latency_seconds histogram", "# HELP cep_latency_seconds"):
        assert want in txt


def test_exemplars_resolve_to_batch_corr_ids_equal_jax():
    procs = pair(clock=FakeClock, latency=True)
    feed(procs)
    ex = lat_snaps(procs)["exemplars"]
    for seg in SEGMENTS + ("e2e_total",):
        name, seq = ex[seg]["corr"].rsplit("-", 1)
        assert name == procs[1].name and 1 <= int(seq) <= len(VALS) // 3


def test_pipelined_complete_stamp_at_decode():
    """A pipelined batch takes its complete stamp when the next call waits
    for its outputs (on the CPU the scan already ran): the ledger still
    conserves its segments and commits every record once."""
    proc = CEPProcessor(ts.strict3(ts.TQuery), 2, EngineConfig(**CFG), gc_interval=0,
                        pipeline=True, clock=FakeClock(), latency=True, device="cpu")
    for i in range(0, len(VALS), 3):
        proc.process(trace(Record, VALS)[i:i + 3])
    assert proc.ledger.records_committed == len(VALS) - 3  # the last batch is pending
    proc.flush()
    lat = proc.metrics_snapshot(per_lane=False)["latency"]
    assert lat["records"] == len(VALS) and lat["deferred_batches"] == 0
    assert lat["segments"]["device"]["sum"] > 0
    sums = seg_sums(lat)
    assert sum(sums[n] for n in SEGMENTS) == pytest.approx(sums["e2e_total"], rel=1e-9)

