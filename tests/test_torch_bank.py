"""The port's ``CEPBank`` against the JAX package's, after
``tests/test_bank.py``.

The same records go through both banks (the JAX one on its jnp path,
``CEP_WALK_KERNEL=0``; the port's on the CPU), and the ``(query, key,
Sequence)`` triples, each member's counters and the whole bank snapshot
(its key set, and every value but the wall-clock ones) are held equal; an
empty bank raises.
"""

import numpy as np
import pytest

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.runtime import CEPBank as JBank
from kafkastreams_cep_tpu.runtime import Record as JRecord
from kafkastreams_cep_tpu_torch import EngineConfig, Record
from kafkastreams_cep_tpu_torch.runtime import CEPBank

CFG = dict(max_runs=32, slab_entries=64, slab_preds=8, dewey_depth=16, max_walk=16)
QUERIES = {"strict": ts.strict3, "skip": ts.skip_till_next, "any": ts.skip_till_any}


def triples(out):
    return [(name, key, ts.canon_matches([(key, seq)])[0][1]) for name, key, seq in out]


@pytest.mark.parametrize("conf", [{}, dict(lazy_extraction=True, handle_ring=16),
                                  dict(stage_attribution=True)],
                         ids=["eager", "lazy", "attribution"])
def test_bank_equals_jax(monkeypatch, conf):
    monkeypatch.setenv("CEP_WALK_KERNEL", "0")
    monkeypatch.delenv("CEP_SCAN_KERNEL", raising=False)
    cfg = dict(CFG, **conf)
    jb = JBank({n: b(ts.JQuery) for n, b in QUERIES.items()}, 3, JConfig(**cfg))
    tb = CEPBank({n: b(ts.TQuery) for n, b in QUERIES.items()}, 3, EngineConfig(**cfg),
                 device="cpu")
    rng = np.random.default_rng(11)
    n = 0
    for batch in range(2):
        codes = rng.integers(0, 5, size=24)
        keys = rng.choice(["k0", "k1", "k2"], size=24)
        recs = [(str(k), int(c), 1000 + 40 * batch + i) for i, (k, c) in
                enumerate(zip(keys, codes))]
        jout = jb.process([JRecord(*r) for r in recs])
        tout = tb.process([Record(*r) for r in recs])
        assert triples(tout) == triples(jout), f"batch {batch}"
        n += len(tout)
    assert n > 0 and {name for name, _, _ in triples(tout)} <= set(QUERIES)
    assert tb.counters() == jb.counters()
    assert_snapshots_equal(tb.metrics_snapshot(), jb.metrics_snapshot())


#: Snapshot values that are wall-clock readings: the phase seconds, the
#: device rate derived from them, and each phase histogram's sum and
#: percentiles (its observation count is compared).
WALL_CLOCK = {"events_per_second_device"}
WALL_CLOCK_PHASE = {"sum", "p50", "p95", "p99", "p999", "mean", "max", "min", "buckets"}


def assert_snapshots_equal(tsnap, jsnap):
    """The whole bank snapshot: the same keys but the port's own
    ``layers`` (the child spans inside the phases and their work counts),
    and equal values but the wall-clock ones (whose keys must still
    agree)."""
    assert set(tsnap) - {"layers"} == set(jsnap), set(tsnap) ^ set(jsnap)
    assert "layers" in tsnap and "layers" not in jsnap
    for k in jsnap:
        if k.endswith("_seconds") or k in WALL_CLOCK:
            continue
        if k == "phases":
            assert set(tsnap[k]) == set(jsnap[k])
            for phase, h in jsnap[k].items():
                assert set(tsnap[k][phase]) == set(h), phase
                for field, v in h.items():
                    if field not in WALL_CLOCK_PHASE:
                        assert tsnap[k][phase][field] == v, (phase, field)
            continue
        assert tsnap[k] == jsnap[k], k


def test_bank_runs_queries_independently():
    bank = CEPBank({"strict": ts.strict3(ts.TQuery), "skip": ts.skip_till_next(ts.TQuery)},
                   num_lanes=2, config=EngineConfig(**CFG), device="cpu")
    records = [Record("k", v, 1000 + i) for i, v in enumerate([ts.A, ts.B, ts.C, ts.D])]
    by_query = {}
    for name, key, seq in bank.process(records):
        by_query.setdefault(name, []).append(ts.canon(seq))
    assert by_query["strict"] == [{"first": [0], "second": [1], "latest": [2]}]
    assert by_query["skip"] == [{"first": [0], "second": [2], "latest": [3]}]
    assert all(v == 0 for c in bank.counters().values() for v in c.values())


def test_bank_rejects_empty():
    with pytest.raises(ValueError, match="at least one"):
        CEPBank({}, num_lanes=1, device="cpu")
