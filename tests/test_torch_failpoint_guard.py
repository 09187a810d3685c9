"""Guards over the port's failure sites and metrics surface, after
``tests/test_failpoint_guard.py`` and ``tests/test_metrics_guard.py``.

* Every ``_failpoint("...")`` call under ``kafkastreams_cep_tpu_torch/`` names
  a site registered in the port's ``utils/failpoints.py: SITES``, and some
  other ``tests/test_torch_*.py`` file arms each one (``tenant.misbehave``
  and ``quota.shed`` included).
* Every top-level key of the port's fat snapshots (a supervisor with the
  ingest guard, tiering, attribution, a latency ledger with an SLO and a
  recovery; a tenant supervisor with admission and a ledger) is in the
  README's metrics reference table, and every Prometheus family rendered
  from them carries ``# HELP`` and ``# TYPE`` before its first sample.
"""

import pathlib
import re

import numpy as np

import torch_scenarios as ts
from kafkastreams_cep_tpu_torch import EngineConfig, Query, Record, Supervisor
from kafkastreams_cep_tpu_torch.runtime import IngestPolicy
from kafkastreams_cep_tpu_torch.runtime.tenant import AdmissionPolicy, TenantSupervisor
from kafkastreams_cep_tpu_torch.utils import failpoints as fp
from kafkastreams_cep_tpu_torch.utils.latency import LatencyLedger, SLOTracker
from kafkastreams_cep_tpu_torch.utils.telemetry import render_prometheus

_THIS = pathlib.Path(__file__)
ROOT = _THIS.parent.parent
PKG = ROOT / "kafkastreams_cep_tpu_torch"
README = ROOT / "README.md"
CFG = dict(max_runs=16, slab_entries=48, slab_preds=6, dewey_depth=10, max_walk=10)


def fired_sites():
    called = set()
    for p in PKG.rglob("*.py"):
        if (PKG / "build") in p.parents:  # build outputs, not sources
            continue
        for m in re.finditer(r"_failpoint\(\s*[\"']([a-z_.]+)[\"']\s*\)", p.read_text()):
            called.add(m.group(1))
    return called


def test_port_sites_are_registered():
    called = fired_sites()
    assert {"tenant.misbehave", "quota.shed", "device.dispatch"} <= called
    unknown = called - set(fp.SITES)
    assert not unknown, f"port fire() sites {sorted(unknown)} are not in failpoints.SITES"


def test_every_port_site_is_armed_by_a_port_test():
    corpus = "\n".join(p.read_text() for p in _THIS.parent.glob("test_torch_*.py")
                       if p.name != _THIS.name)
    unarmed = sorted(s for s in fired_sites() if f'"{s}"' not in corpus)
    assert not unarmed, f"port failpoint sites {unarmed} are armed by no test_torch_* file"


# -- the metrics surface -----------------------------------------------------------


def _fat_snapshots(tmp_path):
    cfg = EngineConfig(**dict(CFG, tiering=True, stage_attribution=True))
    sup = Supervisor(ts.strict3(Query), 1, cfg, checkpoint_path=str(tmp_path / "g.ckpt"),
                     checkpoint_every=2, gc_interval=1, ingest=IngestPolicy(grace_ms=0),
                     latency=LatencyLedger(slo=SLOTracker(threshold_s=1.0)), device="cpu",
                     retry_backoff_ms=0)
    vals = [ts.A, ts.B, ts.C, ts.X, ts.A, ts.B, ts.C, ts.X]
    with fp.FAILPOINTS.session({"device.result": [2]}):
        for i, v in enumerate(vals):
            sup.process([Record("k", v, 1000 + i, offset=i)])
    assert sup.recoveries == 1
    ge = lambda th: lambda k, v, ts_, st: v["x"] >= th  # noqa: E731
    patterns = {"spike": (Query().select("a").where(ge(8)).then().select("b").where(ge(1))
                          .build())}
    tsup = TenantSupervisor(patterns, 2, EngineConfig(**dict(CFG, dewey_depth=32)),
                            checkpoint_path=str(tmp_path / "t.ckpt"), latency=True,
                            admission=AdmissionPolicy(rate_per_batch=1.0), device="cpu")
    rng = np.random.default_rng(3)
    tsup.process([Record(f"k{i % 2}", {"x": int(rng.integers(0, 10))}, i) for i in range(12)])
    return sup.metrics_snapshot(), tsup.metrics_snapshot()


def _reference_table() -> str:
    m = re.search(r"<!-- metrics-reference-start -->(.*?)<!-- metrics-reference-end -->",
                  README.read_text(), re.S)
    assert m, "README.md lost its metrics-reference markers"
    return m.group(1)


def test_every_port_snapshot_key_is_documented(tmp_path):
    table = _reference_table()
    snaps = _fat_snapshots(tmp_path)
    assert "latency" in snaps[0] and "latency" in snaps[1]
    undocumented = sorted({k for snap in snaps for k in snap if f"`{k}`" not in table})
    assert not undocumented, f"port metrics_snapshot() keys {undocumented} are undocumented"


def test_every_port_prometheus_family_has_help_and_type(tmp_path):
    helped, typed, missing = set(), set(), []
    for snap in _fat_snapshots(tmp_path):
        for line in render_prometheus(snap).splitlines():
            if line.startswith("# HELP "):
                helped.add(line.split()[2])
            elif line.startswith("# TYPE "):
                typed.add(line.split()[2])
            elif line:
                name = re.match(r"([a-zA-Z_:][a-zA-Z0-9_:]*)", line).group(1)
                family = re.sub(r"_(bucket|sum|count)$", "", name)
                if not ({name, family} & helped and {name, family} & typed):
                    missing.append(line)
    assert not missing, f"samples without # HELP/# TYPE: {missing[:5]}"
    for family in ("cep_latency_seconds", "cep_slo_burn", "cep_phase_seconds",
                   "cep_latency_query_seconds"):
        assert family in helped and family in typed, family
