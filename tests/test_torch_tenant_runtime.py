"""The port's tenant runtime (``runtime/tenant.py``: ``TenantCEP``,
``TenantSupervisor``, admission, quarantine, tenant checkpoints) against
the JAX package's, on the CPU.

The runtime cases of ``tests/test_multitenant.py`` and
``tests/test_tenant_isolation.py`` run through both packages on the same
numpy-seeded record batches (the JAX side on its jnp walks): the streams
(query, key, Sequence, in order), per-query counters, admission ledgers,
quarantine decisions, supervisor counters and metrics snapshots must be
equal.  Tenant checkpoints written by either package restore in both, and
a latency ledger on a pinned clock gives the JAX package's snapshot.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from kafkastreams_cep_tpu import Query as JQuery
from kafkastreams_cep_tpu.compiler.multitenant import TenantQuota as JQuota
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.engine.sizing import EscalationPolicy as JEscalation
from kafkastreams_cep_tpu.runtime import Record as JRecord
from kafkastreams_cep_tpu.runtime import tenant as jt
from kafkastreams_cep_tpu.utils import failpoints as jfp
from kafkastreams_cep_tpu.utils.telemetry import render_prometheus as jrender
from kafkastreams_cep_tpu_torch import EngineConfig, Query, Record
from kafkastreams_cep_tpu_torch.compiler.multitenant import TenantQuota
from kafkastreams_cep_tpu_torch.engine.sizing import EscalationPolicy
from kafkastreams_cep_tpu_torch.runtime import tenant as tt
from kafkastreams_cep_tpu_torch.runtime.ingest import REASON_TENANT_QUOTA
from kafkastreams_cep_tpu_torch.utils import failpoints as tfp
from kafkastreams_cep_tpu_torch.utils.telemetry import render_prometheus
from test_torch_multitenant import CFG, ge, jnp_path, lt, q_hybrid, q_stencil  # noqa: F401

pytestmark = pytest.mark.usefixtures("jnp_path")

PKGS = {
    "jax": SimpleNamespace(m=jt, Q=JQuery, Record=JRecord, Config=JConfig, Quota=JQuota,
                           Escalation=JEscalation, fp=jfp, render=jrender, kw={}),
    "torch": SimpleNamespace(m=tt, Q=Query, Record=Record, Config=EngineConfig,
                             Quota=TenantQuota, Escalation=EscalationPolicy, fp=tfp,
                             render=render_prometheus, kw=dict(device="cpu")),
}


@pytest.fixture(autouse=True)
def clear_failpoints():
    yield
    jfp.FAILPOINTS.clear()
    tfp.FAILPOINTS.clear()


def make_patterns(Q):
    """``tests/test_multitenant.py: make_patterns``."""
    return {"spike": q_stencil(Q, 8, 3, 7), "dip": q_hybrid(Q, 8, 3, 9),
            "crash": q_hybrid(Q, 9, 1, 7)}


def batches(R, n_batches, per_batch=20, seed=7):
    """``tests/test_multitenant.py: batches`` with either package's Record."""
    rng = np.random.default_rng(seed)
    keys = ["alpha", "beta", "gamma"]
    t, out = 0, []
    for _ in range(n_batches):
        recs = []
        for _ in range(per_batch):
            t += int(rng.integers(1, 3))
            recs.append(R(key=keys[int(rng.integers(0, len(keys)))],
                          value={"x": int(rng.integers(0, 10))}, timestamp=t))
        out.append(recs)
    return out


def canon(matches):
    """``(query, key, Sequence)`` triples as plain data, order kept."""
    return [(qn, k, [(st, [(e.partition, e.offset, e.timestamp, e.value) for e in evs])
                     for st, evs in seq.as_map().items()])
            for qn, k, seq in matches]


def tenant(p, patterns=make_patterns, lanes=3, cfg=CFG, **kw):
    return p.m.TenantCEP(patterns(p.Q), lanes, p.Config(**cfg), **kw, **p.kw)


def supervisor(p, tmp_path, tag, patterns=make_patterns, lanes=3, cfg=CFG, **kw):
    return p.m.TenantSupervisor(patterns(p.Q), lanes, p.Config(**cfg),
                                checkpoint_path=str(tmp_path / f"{tag}.ckpt"), **kw, **p.kw)


def both(fn):
    """``fn(pkg, name)`` for each package; the results must be equal."""
    out = {name: fn(p, name) for name, p in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


class Clock:
    def __init__(self):
        self.t = 999.5

    def __call__(self):
        self.t += 0.5
        return self.t


# -- tests/test_multitenant.py ---------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restore_with_live_prefix_carry(tmp_path, writer):
    """A snapshot with a partial prefix pending, written by either package,
    restores in both; their continuations equal the uninterrupted run."""
    def ref(p, name):
        t = tenant(p)
        return [canon(t.process(b)) for b in batches(p.Record, 6, seed=7)]

    want = both(ref)
    assert sum(map(len, want)) > 0
    p = PKGS[writer]
    t = tenant(p)
    for b in batches(p.Record, 6, seed=7)[:3]:
        t.process(b)
    assert any(bool(np.asarray(c.bools).any()) for c in t.state.carry)
    path = str(tmp_path / "tenant.ckpt")
    p.m.save_tenant_checkpoint(t, path)

    def resumed(q, name):
        t2 = q.m.restore_tenant(make_patterns(q.Q), path, **q.kw)
        return (t2.per_query_counters(),
                [canon(t2.process(b)) for b in batches(q.Record, 6, seed=7)[3:]])

    pq, cont = both(resumed)
    assert cont == want[3:]
    assert pq == t.per_query_counters()


def test_restore_refuses_mismatched_topology(tmp_path):
    for p in PKGS.values():
        t = tenant(p)
        t.process(batches(p.Record, 1)[0])
        path = str(tmp_path / "tenant.ckpt")
        p.m.save_tenant_checkpoint(t, path)
        renamed = make_patterns(p.Q)
        renamed["burst"] = renamed.pop("crash")
        with pytest.raises(ValueError, match="names"):
            p.m.restore_tenant(renamed, path, **p.kw)
        reshaped = make_patterns(p.Q)
        reshaped["crash"] = q_stencil(p.Q, 9, 1, 7)
        with pytest.raises(ValueError, match="topology|stages"):
            p.m.restore_tenant(reshaped, path, **p.kw)


def test_supervisor_chaos_schedule_exactly_once(tmp_path):
    """A seeded chaos schedule over the device and checkpoint sites: every
    batch's matches once, in the uninterrupted run's order, with the same
    recoveries and checkpoints in both packages."""
    def run(p, name):
        bs = batches(p.Record, 8, seed=19)
        ref = tenant(p)
        want = [canon(ref.process(b)) for b in bs]
        schedule = p.fp.random_schedule(seed=3, horizon=8, rate=0.3, sites=(
            "device.dispatch", "device.result", "checkpoint.save"))
        with p.fp.FAILPOINTS.session(schedule):
            sup = supervisor(p, tmp_path, name, checkpoint_every=2, max_retries=6,
                             retry_backoff_ms=0.0)
            got = [canon(sup.process(b)) for b in bs]
        assert got == want
        snap = sup.metrics_snapshot()
        return got, sup.recoveries, sup.checkpoints, snap["recoveries"]

    got, recoveries, checkpoints, _ = both(run)
    assert sum(map(len, got)) > 0 and recoveries > 0 and checkpoints > 0


def test_metrics_snapshot_and_labels_equal_jax():
    """``metrics_snapshot`` (per-query counters, watermark and lag on a
    pinned clock) and its Prometheus text equal the JAX package's."""
    def run(p, name):
        t = tenant(p, clock=Clock())
        for b in batches(p.Record, 2, seed=23):
            t.process(b)
        snap = t.metrics_snapshot()
        return snap, p.render(snap)

    snap, text = both(run)
    assert set(snap["per_query"]) == {"spike", "dip", "crash"}
    assert 'cep_run_drops{query="spike"} 0' in text
    assert 'cep_tier_promotions{query="dip"}' in text
    assert "cep_bank_queries 3" in text


# -- tests/test_tenant_isolation.py ----------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_quarantine_checkpoint_restore_and_reinstate(tmp_path, writer):
    """Quarantine flags, reasons and shed ledgers ride the checkpoint;
    restore rebuilds enforcement without re-entering ``quarantine.enter``
    in either package; continuations and reinstatement equal."""
    p = PKGS[writer]
    bs = batches(p.Record, 6, seed=7)
    t = tenant(p)
    for b in bs[:2]:
        t.process(b)
    t.quarantine("crash", "manual")
    for b in bs[2:4]:
        t.process(b)
    path = str(tmp_path / "iso.ckpt")
    p.m.save_tenant_checkpoint(t, path)

    def run(q, name):
        with q.fp.FAILPOINTS.session():
            t2 = q.m.restore_tenant(make_patterns(q.Q), path, **q.kw)
            assert q.fp.FAILPOINTS.hits("quarantine.enter") == 0
        out = [t2.quarantined_names(), dict(t2.quarantine_reasons), t2.per_query_counters()]
        out.append([canon(t2.process(b)) for b in batches(q.Record, 6, seed=7)[4:]])
        t2.reinstate("crash")
        out += [t2.quarantined_names(), canon(t2.process(batches(q.Record, 1, seed=99)[0]))]
        return out

    names, reasons, pq, cont, after, last = both(run)
    assert names == ["crash"] and reasons == {"crash": "manual"} and after == []
    assert all(qn != "crash" for batch in cont for qn, _, _ in batch)
    assert pq == t.per_query_counters()


def test_widen_with_quarantined_tenant(tmp_path):
    """A live widening with a quarantined tenant: the isolation state moves
    with the bank, a checkpoint pins it, and the widened bank's stream
    equals an unwidened twin's, in both packages."""
    wide = dict(CFG, max_runs=16, slab_entries=48, max_walk=12)

    def run(p, name):
        bs = batches(p.Record, 5, seed=41)
        ref = tenant(p)
        sup = supervisor(p, tmp_path, name, retry_backoff_ms=0.0)
        out = [canon(sup.process(b)) for b in bs[:2]]
        assert out == [canon(ref.process(b)) for b in bs[:2]]
        ref.quarantine("crash", "capacity")
        sup._quarantine_for("crash", "capacity")
        sup._widen(p.Config(**wide))
        assert sup.tenant.batch.config.max_runs == 16 and sup.checkpoints >= 1
        for b in bs[2:]:
            got = canon(sup.process(b))
            assert got == canon(ref.process(b))
            out.append(got)
        return out, sup.tenant.quarantined_names(), sup.per_query_counters()

    both(run)


def test_admission_shedding_ledger_and_atomic_rollback():
    """A token bucket sheds a flooding tenant's records with typed
    ``tenant_quota`` dead letters; ``offered == admitted + shed +
    quarantined_dropped`` per tenant; an injected ``"quota.shed"`` fault
    rolls the batch's ledger back, so its retry meets the same buckets."""
    def run(p, name):
        t = tenant(p, admission=p.m.AdmissionPolicy(rate_per_batch=2.0, burst=2.0),
                   clock=Clock())
        bs = batches(p.Record, 4, per_batch=12, seed=7)
        out = [canon(t.process(b)) for b in bs[:2]]
        led = t.admission_ledger()
        snap = t.metrics_snapshot()
        before = t.admission_ledger()
        with p.fp.FAILPOINTS.session({"quota.shed": [0]}):
            with pytest.raises(p.fp.InjectedIOError):
                t.process(bs[2])
            assert t.admission_ledger() == before
            out.append(canon(t.process(bs[2])))
        return out, led, snap, p.render(snap), t.admission_ledger(), [
            (d.record.key, d.record.value, d.record.timestamp, d.reason, d.detail, d.corr)
            for d in t.admission.dead_letters]

    out, led, snap, text, after, dead = both(run)
    assert set(led) == {"alpha", "beta", "gamma"}
    for row in list(led.values()) + list(after.values()):
        assert row["offered"] == row["admitted"] + row["shed"] + row["quarantined_dropped"]
    shed = sum(r["shed"] for r in led.values())
    assert shed > 0 and snap["dead_letters"] == {REASON_TENANT_QUOTA: shed}
    assert snap["admission_shed_total"] == shed == snap["dead_letter_depth"]
    assert 'dead_letters_total{reason="tenant_quota"}' in text


def test_shed_quarantined_drops_ledgered():
    """``shed_quarantined=True``: a quarantined tenant's records drop at the
    door (``quarantined_dropped``), in both packages."""
    def run(p, name):
        pol = p.m.AdmissionPolicy(rate_per_batch=100.0, shed_quarantined=True,
                                  key_tenant=lambda k: {"alpha": "spike"}.get(k, "crash"))
        t = tenant(p, admission=pol)
        bs = batches(p.Record, 3, seed=5)
        out = [canon(t.process(bs[0]))]
        t.quarantine("crash", "manual")
        out += [canon(t.process(b)) for b in bs[1:]]
        return out, t.admission_ledger()

    _, led = both(run)
    assert led["crash"]["quarantined_dropped"] > 0


def test_misbehave_quarantines_offender_and_defers_on_enter_fault(tmp_path):
    """A ``"tenant.misbehave"`` fault quarantines exactly the named tenant;
    a ``"quarantine.enter"`` fault defers it to the recovery; compliant
    tenants' streams equal the fault-free run's in both packages."""
    def run(p, name):
        bs = batches(p.Record, 4, seed=19)
        ref = tenant(p)
        want = [canon(ref.process(b)) for b in bs]
        sup = supervisor(p, tmp_path, name, checkpoint_every=100, max_retries=3,
                         retry_backoff_ms=0.0)
        with p.fp.FAILPOINTS.session({"quarantine.enter": [0]}):
            p.fp.FAILPOINTS.arm("tenant.misbehave", hits=[1],
                                exc=lambda: p.m.TenantMisbehave("crash"))
            got = [canon(sup.process(b)) for b in bs]
            enters = p.fp.FAILPOINTS.hits("quarantine.enter")
        compliant = lambda ms: [m for m in ms if m[0] != "crash"]
        assert got[0] == want[0]
        assert [compliant(g) for g in got[1:]] == [compliant(r) for r in want[1:]]
        return (got, enters, sup.quarantines, sup.tenant.quarantined_names(),
                sup.tenant_quarantines, sup.recoveries)

    got, enters, decisions, names, quarantines, recoveries = both(run)
    assert enters == 2 and decisions == {"crash": "misbehave"} and names == ["crash"]
    assert quarantines == 1 and recoveries == 1
    assert all(m[0] != "crash" for g in got[1:] for m in g)


def test_poisoned_predicate_attributed_and_quarantined(tmp_path):
    """A tenant predicate that starts raising is attributed by
    ``find_poison`` and its owner quarantined; the compliant tenant's
    matches are unaffected, in both packages."""
    flag = {"on": False}

    def poison(th):
        def pred(k, v, ts_, st, th=th):
            if flag["on"]:
                raise RuntimeError("tenant predicate corrupted")
            return v["x"] >= th

        return pred

    def make(Q):
        return {"spike": q_stencil(Q, 8, 3, 7),
                "toxic": (Q().select("a").where(ge(8)).then().select("b").where(lt(3))
                          .then().select("c").where(poison(7)).build())}

    def run(p, name):
        flag["on"] = False
        stamps = iter(range(1, 100))
        b1, b2, b3 = ([p.Record(key="alpha", value={"x": x}, timestamp=next(stamps))
                       for x in xs]
                      for xs in ([9, 2, 8], [9, 1, 7, 8, 0, 9, 9, 2, 8], [8, 2, 7]))
        sup = supervisor(p, tmp_path, name, patterns=make, lanes=2, checkpoint_every=10,
                         max_retries=2, retry_backoff_ms=0.0)
        got = [canon(sup.process(b1))]
        flag["on"] = True
        got += [canon(sup.process(b2)), canon(sup.process(b3))]
        flag["on"] = False
        oracle = tenant(p, patterns=make, lanes=2)
        want = [canon(oracle.process(b)) for b in (b1, b2, b3)]
        spikes = lambda ms: [m for m in ms if m[0] == "spike"]
        assert [spikes(g) for g in got] == [spikes(r) for r in want]
        return sup.quarantines, sup.tenant.quarantined_names(), [spikes(g) for g in got]

    decisions, names, spikes = both(run)
    assert decisions == {"toxic": "predicate_raise"} and names == ["toxic"]
    assert sum(map(len, spikes)) > 0


def test_escalation_denied_for_over_quota_tenant(tmp_path):
    def run(p, name):
        patterns = lambda Q: {"spike": q_stencil(Q, 8, 3, 7), "flood": q_hybrid(Q, 0, 10, 99)}
        sup = supervisor(p, tmp_path, name, patterns=patterns, retry_backoff_ms=0.0,
                         auto_escalate=p.Escalation(),
                         quarantine_policy=p.m.QuarantinePolicy(trip_streak=1),
                         quotas={"flood": p.Quota(max_live_lanes=1)})
        for b in batches(p.Record, 3, per_batch=16, seed=13):
            sup.process(b)
        snap = sup.metrics_snapshot()
        return (sup.tenant_escalation_denied, sup.quarantines, sup.escalations,
                sup.tenant.batch.config.max_runs, sup.per_query_counters(),
                snap["tenant_escalation_denied"], snap["tenant_quarantines"])

    denied, decisions, escalations, max_runs, pq, _, quarantines = both(run)
    assert denied >= 1 and decisions.get("flood") == "capacity" and escalations == 0
    assert max_runs == CFG["max_runs"] and quarantines == 1
    assert pq["flood"]["run_drops"] > 0 and pq["spike"]["run_drops"] == 0


def test_escalation_widens_for_compliant_trips(tmp_path):
    def run(p, name):
        patterns = lambda Q: {"spike": q_stencil(Q, 8, 3, 7), "greedy": q_hybrid(Q, 0, 10, 99)}
        sup = supervisor(p, tmp_path, name, patterns=patterns, retry_backoff_ms=0.0,
                         auto_escalate=p.Escalation())
        bs = batches(p.Record, 2, per_batch=45, seed=7)
        out = [canon(sup.process(bs[0]))]
        cfg = dataclasses.asdict(sup.tenant.batch.config)
        out.append(canon(sup.process(bs[1])))
        return (out, cfg, sup.escalations, sup.tenant_escalation_denied, sup.quarantines,
                sup.checkpoints, sup.per_query_counters())

    _, cfg, escalations, denied, decisions, checkpoints, _ = both(run)
    assert escalations >= 1 and denied == 0 and decisions == {}
    assert cfg["max_runs"] > CFG["max_runs"] and checkpoints >= 1


def test_retry_backoff_deterministic(tmp_path):
    def run(p, name):
        sup = supervisor(p, tmp_path, name, max_retries=3, retry_backoff_ms=100.0,
                         retry_backoff_cap_ms=400.0)
        sleeps = []
        sup._sleep = sleeps.append
        bs = batches(p.Record, 2, seed=19)
        sup.process(bs[0])
        with p.fp.FAILPOINTS.session({"device.dispatch": [0, 1]}):
            sup.process(bs[1])
        zero = supervisor(p, tmp_path, name + "z", max_retries=2, retry_backoff_ms=0.0)
        none = []
        zero._sleep = none.append
        with p.fp.FAILPOINTS.session({"device.dispatch": [0]}):
            zero.process(batches(p.Record, 1, seed=19)[0])
        return sleeps, round(sup.retry_backoff_ms_total, 9), sup.recoveries >= 1, none

    sleeps, total, recovered, none = both(run)
    rng = np.random.default_rng((2, 0))
    assert len(sleeps) == 2 and recovered and none == []
    assert sleeps[0] == pytest.approx(100.0 * (0.5 + 0.5 * float(rng.random())) / 1000.0)
    assert total == pytest.approx(sum(sleeps) * 1000.0)


def test_chaos_flood_and_misbehave_exactly_once_for_compliant(tmp_path):
    """Seeded chaos plus a misbehaving tenant, with quotas and admission
    on: compliant tenants' matches once in order, the admission ledger
    equal to the fault-free run's, equal in both packages."""
    def run(p, name):
        kwargs = dict(admission=p.m.AdmissionPolicy(rate_per_batch=5.0, burst=6.0),
                      quotas={"crash": p.Quota(match_rate_budget=2.0)})
        bs = batches(p.Record, 8, seed=19)
        ref = tenant(p, **kwargs)
        want = [canon(ref.process(b)) for b in bs]
        schedule = p.fp.random_schedule(seed=3, horizon=8, rate=0.3, sites=(
            "device.dispatch", "device.result", "checkpoint.save"))
        with p.fp.FAILPOINTS.session(schedule):
            sup = supervisor(p, tmp_path, name, checkpoint_every=2, max_retries=8,
                             retry_backoff_ms=0.0, **kwargs)
            got = []
            for i, b in enumerate(bs):
                if i == 5:
                    p.fp.FAILPOINTS.arm("tenant.misbehave",
                                        hits=[p.fp.FAILPOINTS.hits("tenant.misbehave")],
                                        exc=lambda: p.m.TenantMisbehave("crash"))
                got.append(canon(sup.process(b)))
        compliant = lambda ms: [m for m in ms if m[0] != "crash"]
        assert [compliant(g) for g in got] == [compliant(r) for r in want]
        assert sup.admission_ledger() == ref.admission_ledger()
        pq_s, pq_r = sup.per_query_counters(), ref.per_query_counters()
        assert pq_s["spike"] == pq_r["spike"] and pq_s["dip"] == pq_r["dip"]
        snap = sup.metrics_snapshot()
        return (got, sup.recoveries, sup.quarantines, sup.admission_ledger(),
                snap["tenant_quarantines"], snap["quarantined_queries"])

    got, recoveries, decisions, ledger, quarantines, dark = both(run)
    assert recoveries > 0 and decisions == {"crash": "misbehave"}
    assert quarantines == 1 and dark == 1
    for row in ledger.values():
        assert row["offered"] == row["admitted"] + row["shed"] + row["quarantined_dropped"]


# -- the latency ledger on the tenant path ---------------------------------------


def test_tenant_latency_equals_jax_and_cross_loads(tmp_path):
    """``TenantCEP(latency=True)`` on a pinned clock: the ledger's snapshot
    (segments, per-query e2e) equals the JAX package's; a tenant checkpoint
    carrying it restores in both packages on the restored runtime's
    clock."""
    paths = {}

    def run(p, name):
        t = tenant(p, clock=Clock(), latency=True)
        out = [canon(t.process(b)) for b in batches(p.Record, 3, seed=7)]
        paths[name] = str(tmp_path / f"lat-{name}.ckpt")
        p.m.save_tenant_checkpoint(t, paths[name])
        return out, t.metrics_snapshot()["latency"]

    out, lat = both(run)
    assert lat["records"] == 60 and set(lat["per_query"]) <= {"spike", "dip", "crash"}
    assert lat["per_query"]

    def restored(p, name):
        res = []
        for path in paths.values():
            clock = Clock()
            t2 = p.m.restore_tenant(make_patterns(p.Q), path, clock=clock, **p.kw)
            assert t2.ledger.clock is clock
            t2.process(batches(p.Record, 4, seed=7)[3])
            res.append(t2.ledger.snapshot())
        return res

    a, b = both(restored)
    assert a == b and a["records"] == 80


def test_tenant_supervisor_keeps_pinned_clock_after_recovery(tmp_path):
    def run(p, name):
        clock = Clock()
        sup = supervisor(p, tmp_path, name, checkpoint_every=1, retry_backoff_ms=0.0,
                         clock=clock, latency=True)
        bs = batches(p.Record, 3, seed=7)
        sup.process(bs[0])
        with p.fp.FAILPOINTS.session({"device.dispatch": [0]}):
            sup.process(bs[1])
        assert sup.recoveries == 1 and sup.tenant.ledger.clock is clock
        sup.process(bs[2])
        return sup.tenant.ledger.snapshot()

    assert both(run)["records"] == 60
