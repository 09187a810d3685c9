"""The port's capacity estimation (``engine/sizing.py``) against the JAX
package's, after ``tests/test_sizing.py`` and ``tests/test_escalation.py``.

* ``probe``: the same ``ProbeReport`` field by field (counters, every
  occupancy maximum, the config), eager and lazy, on ``tests/test_sizing.
  py``'s kleene trace;
* ``suggest`` and ``autosize``: the same ``EngineConfig``, loss-free on the
  sample in both packages;
* ``escalate``, ``escalate_ingest`` and ``EscalationPolicy`` on the cases
  of ``tests/test_escalation.py:50-76`` (and the hot-tier and ingest
  variants): the same result.

JAX reports and policies cross over through ``convert.to_torch``.
"""

import dataclasses

import pytest

import torch_scenarios as ts
from kafkastreams_cep_tpu.compiler.tables import lower as jlower
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.engine import EscalationPolicy as JPolicy
from kafkastreams_cep_tpu.engine import sizing as jsizing
from kafkastreams_cep_tpu.runtime.ingest import IngestPolicy as JIngestPolicy
from kafkastreams_cep_tpu_torch.compiler.tables import lower
from kafkastreams_cep_tpu_torch.convert import to_torch
from kafkastreams_cep_tpu_torch.engine import (
    EngineConfig, EscalationPolicy, ProbeReport, autosize, capacity_counters,
    escalate, probe, suggest,
)
from kafkastreams_cep_tpu_torch.engine import sizing
from kafkastreams_cep_tpu_torch.runtime import IngestPolicy

from test_sizing import sample_events

TINY = dict(max_runs=4, slab_entries=8, slab_preds=2, dewey_depth=8, max_walk=6)


def kleene(Q):
    """``tests/test_sizing.py: kleene_pattern``."""
    return (
        Q().select("a").where(lambda k, v, ts_, st: v["x"] == 0)
        .then().select("b").one_or_more().skip_till_any_match()
        .where(lambda k, v, ts_, st: (0 < v["x"]) & (v["x"] < 8))
        .then().select("c").where(lambda k, v, ts_, st: v["x"] >= 8)
        .build()
    )


def samples(T=48):
    _, jev = sample_events(T=T)
    return jev, ts.from_jax(jev)


@pytest.mark.parametrize("conf", [TINY, dict(TINY, lazy_extraction=True, handle_ring=8)])
def test_probe_report_equals_jax(conf):
    jev, tev = samples()
    want = jsizing.probe(kleene(ts.JQuery), jev, JConfig(**conf), sweep_every=16)
    got = probe(kleene(ts.TQuery), tev, EngineConfig(**conf), sweep_every=16, device="cpu")
    assert isinstance(got, ProbeReport)
    assert got == to_torch(want)
    assert got.counters["run_drops"] > 0


def test_suggest_equals_jax():
    jev, tev = samples(T=16)
    generous = dict(max_runs=64, slab_entries=128, slab_preds=16, dewey_depth=24,
                    max_walk=32)
    jrep = jsizing.probe(kleene(ts.JQuery), jev, JConfig(**generous), sweep_every=8)
    trep = probe(kleene(ts.TQuery), tev, EngineConfig(**generous), sweep_every=8,
                 device="cpu")
    assert trep == to_torch(jrep)
    got = suggest(lower(kleene(ts.TQuery)), trep)
    assert got == to_torch(jsizing.suggest(jlower(kleene(ts.JQuery)), jrep))
    assert got.max_runs % 8 == 0 and got.slab_entries % 8 == 0


def test_autosize_equals_jax_and_is_loss_free():
    jev, tev = samples()
    want = jsizing.autosize(kleene(ts.JQuery), jev, start=JConfig(**TINY), sweep_every=16)
    got = autosize(kleene(ts.TQuery), tev, start=EngineConfig(**TINY), sweep_every=16,
                   device="cpu")
    assert got == to_torch(want)
    rep = probe(kleene(ts.TQuery), tev, got, sweep_every=16, device="cpu")
    assert not any(capacity_counters(rep.counters).values()), rep.counters


SEED = dict(max_runs=4, slab_entries=16, slab_preds=2, dewey_depth=8, max_walk=8)
CEILING = dict(max_runs=64, slab_entries=128, slab_preds=16, dewey_depth=32, max_walk=32)


@pytest.mark.parametrize("start,tripped,policy", [
    (SEED, {"run_drops": 3, "slab_pred_drops": 1}, dict(max_config=CEILING)),
    (SEED, {"run_drops": 5}, dict(max_config=SEED)),
    (SEED, {"run_drops": 5, "slab_trunc": 2}, dict(max_config=dict(SEED, max_runs=8))),
    (SEED, {"run_drops": 1}, dict(growth=4.0, max_config=CEILING)),
    (dict(SEED, slab_entries=64, slab_hot_entries=16),
     {"slab_full_drops": 2, "handle_overflows": 1, "slab_missing": 9}, {}),
])
def test_escalate_equals_jax(start, tripped, policy):
    def pol(Config, Policy):
        kw = dict(policy)
        if "max_config" in kw:
            kw["max_config"] = Config(**kw["max_config"])
        return Policy(**kw)

    jpol = pol(JConfig, JPolicy)
    tpol = pol(EngineConfig, EscalationPolicy)
    assert to_torch(jpol) == tpol
    want = jsizing.escalate(JConfig(**start), tripped, jpol)
    got = escalate(EngineConfig(**start), tripped, tpol)
    assert got == (None if want is None else to_torch(want))


def test_escalate_pins_the_seed_cases():
    """``tests/test_escalation.py:50-76`` on the port alone."""
    seed, ceiling = EngineConfig(**SEED), EngineConfig(**CEILING)
    out = escalate(seed, {"run_drops": 3, "slab_pred_drops": 1},
                   EscalationPolicy(max_config=ceiling))
    assert (out.max_runs, out.slab_preds, out.slab_entries) == (8, 8, 16)
    assert escalate(seed, {"run_drops": 5}, EscalationPolicy(max_config=seed)) is None
    out = escalate(seed, {"run_drops": 1}, EscalationPolicy(growth=4.0, max_config=ceiling))
    assert out.max_runs == 16


@pytest.mark.parametrize("policy,tripped,ceiling", [
    (dict(), {"late_dropped": 3}, None),
    (dict(grace_ms=500, reorder_depth=100), {"reorder_evictions": 2, "quarantined": 7}, None),
    (dict(grace_ms=500), {"late_dropped": 1, "reorder_evictions": 1},
     dict(grace_ms=800, reorder_depth=4096)),
    (dict(), {"quarantined": 4}, None),
])
def test_escalate_ingest_equals_jax(policy, tripped, ceiling):
    want = jsizing.escalate_ingest(
        JIngestPolicy(**policy), tripped,
        max_policy=None if ceiling is None else JIngestPolicy(**ceiling))
    got = sizing.escalate_ingest(
        IngestPolicy(**policy), tripped,
        max_policy=None if ceiling is None else IngestPolicy(**ceiling))
    assert (got is None) == (want is None)
    if got is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    stats = dict(tripped, admitted=10)
    assert sizing.ingest_capacity_counters(stats) == jsizing.ingest_capacity_counters(stats)
