"""The port's tenant isolation against the JAX package's, after
``tests/test_tenant_isolation.py`` and at its sizes: the same numpy-seeded
events through the JAX package (``CEP_WALK_KERNEL=0``) and the port on the
CPU, held equal bit for bit.

* quotas (``match_rate_budget=0``, ``pred_eval_budget``,
  ``max_live_lanes`` with its one-batch lag): ``quota_shed``, the throttle
  verdicts and the outputs, the other tenants equal to an unquotaed bank;
* quarantine and reinstatement: the survivors equal a bank without the
  victim and JAX's bank under the same schedule; the isolation ledger
  round-trips.

Fixtures (the mixed bank, its config and trace) come from
``tests/test_torch_multitenant.py``.
"""

import numpy as np
import pytest

import torch_scenarios as ts
from kafkastreams_cep_tpu.compiler.multitenant import TenantQuota as JQuota
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.parallel.tenantbank import TenantBankMatcher as JTenant
from kafkastreams_cep_tpu_torch import EngineConfig
from kafkastreams_cep_tpu_torch.compiler.multitenant import TenantQuota
from kafkastreams_cep_tpu_torch.parallel.tenantbank import TenantBankMatcher
from test_torch_multitenant import (  # noqa: F401 (jnp_path is a fixture)
    CFG,
    assert_out_equal,
    assert_tenant_states_equal,
    jnp_path,
    mixed,
    q_hybrid,
    trace,
)


@pytest.mark.parametrize("kind", ["match_rate", "pred_eval", "live_lanes"])
def test_quotas_equal_jax(jnp_path, kind):
    """A quotaed tenant's sheds, throttle verdicts and outputs equal JAX's
    batch by batch (the one-batch lag included), and the other tenants equal
    an unquotaed bank."""
    K, T = 4, 16
    if kind == "match_rate":
        pats, quota, seed = lambda Q: mixed(Q)[:3], dict(match_rate_budget=0.0), 201
    elif kind == "pred_eval":
        pats, quota, seed = lambda Q: mixed(Q)[:2], dict(pred_eval_budget=100), 71
    else:
        pats = lambda Q: [mixed(Q)[0], q_hybrid(Q, 8, 3, 99)]
        quota, seed = dict(max_live_lanes=0), 301
    names = ["free", "capped", "other"][:len(pats(ts.TQuery))]
    jb = JTenant(pats(ts.JQuery), K, JConfig(**CFG), names=names,
                 quotas={"capped": JQuota(**quota)})
    tb = TenantBankMatcher(pats(ts.TQuery), K, EngineConfig(**CFG), names=names,
                           quotas={"capped": TenantQuota(**quota)}, device="cpu")
    ref = TenantBankMatcher(pats(ts.TQuery), K, EngineConfig(**CFG), names=names,
                            device="cpu")
    js, tst, rs = jb.init_state(), tb.init_state(), ref.init_state()
    others = [i for i in range(len(names)) if i != 1]
    for b in range(3):
        ev = trace(K, T, seed + b)
        js, jo = jb.scan(js, ts.to_jax(ev))
        tst, to = tb.scan(tst, ev)
        rs, ro = ref.scan(rs, ev)
        assert_out_equal(jo, to, f"batch {b}")
        for f in to._fields:
            np.testing.assert_array_equal(getattr(to, f)[others].numpy(),
                                          getattr(ro, f)[others].numpy())
        assert tb.iso_state()["quota_shed"].tolist() == jb.iso_state()["quota_shed"].tolist()
        assert tb.iso.throttled.tolist() == jb.iso.throttled.tolist()
        if kind == "live_lanes":
            assert tb.iso.quota_shed[1] == (0 if b < 2 else tb.iso.quota_shed[1])
            assert bool(tb.iso.throttled[1]) == (b >= 1)
    assert tb.iso.quota_shed[1] > 0
    assert tb.per_query_counters(tst) == jb.per_query_counters(js)
    if kind != "live_lanes":
        assert not to.count[1].any()


@pytest.mark.parametrize("victim", [1, 3], ids=["shared-prefix", "private"])
def test_quarantine_blast_radius_equals_jax(jnp_path, victim):
    """Quarantine mid-stream, then reinstate: the survivors equal a bank
    that never held the victim and JAX's bank under the same schedule; the
    victim emits nothing while dark; the ledger round-trips."""
    K, T = 5, 16
    names = [f"q{i}" for i in range(5)]
    keep = [i for i in range(5) if i != victim]
    jb = JTenant(mixed(ts.JQuery), K, JConfig(**CFG), names=names)
    tb = TenantBankMatcher(mixed(ts.TQuery), K, EngineConfig(**CFG), names=names,
                           device="cpu")
    ref = TenantBankMatcher([mixed(ts.TQuery)[i] for i in keep], K, EngineConfig(**CFG),
                            device="cpu")
    js, tst, rs = jb.init_state(), tb.init_state(), ref.init_state()
    for b in range(4):
        if b == 1:
            jb.quarantine(victim)
            tb.quarantine(victim)
            assert tb.quarantined_qids == [victim]
        if b == 3:
            jb.reinstate(victim)
            tb.reinstate(victim)
        ev = trace(K, T, 501 + b)
        js, jo = jb.scan(js, ts.to_jax(ev))
        tst, to = tb.scan(tst, ev)
        rs, ro = ref.scan(rs, ev)
        assert_out_equal(jo, to, f"batch {b}")
        assert_tenant_states_equal(js, tst, f"batch {b}")
        for f in to._fields:
            np.testing.assert_array_equal(getattr(to, f)[keep].numpy(),
                                          getattr(ro, f).numpy(), err_msg=f"batch {b} {f}")
        if b in (1, 2):
            assert not to.count[victim].any()
    pq, pr = tb.per_query_counters(tst), ref.per_query_counters(rs)
    iso = ("quota_shed", "quota_throttled", "quarantined")
    for ri, qi in enumerate(keep):
        assert ({k: v for k, v in pq[f"q{qi}"].items() if k not in iso}
                == {k: v for k, v in pr[f"q{ri}"].items() if k not in iso})
    assert pq == jb.per_query_counters(js)
    # The ledger round-trips, quarantine included.
    tb.quarantine(victim)
    saved = tb.iso_state()
    fresh = TenantBankMatcher(mixed(ts.TQuery), K, EngineConfig(**CFG), names=names,
                              device="cpu")
    fresh.load_iso_state(saved)
    assert fresh.quarantined_qids == [victim]
    assert fresh._disabled_cols == tb._disabled_cols
    got = fresh.iso_state()
    for k, v in saved.items():
        assert np.array_equal(np.asarray(got[k]), np.asarray(v)), k
    with pytest.raises(ValueError, match="no query"):
        tb.quarantine(9)
