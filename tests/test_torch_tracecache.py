"""The port's built-program cache (``utils/tracecache.py``) against the JAX
package's, after ``tests/test_tracecache.py``.

Both modules run the same lookup, eviction, bypass and disable sequences
and report equal ``stats()``; rebuilt port matchers (``BatchMatcher``, the
tenant bank, a processor restored from its checkpoint) take their step
phases, generated whole-scan sources, group programs and screen from the
cache instead of building them again, with unchanged results; the
processor's snapshot carries ``trace_cache`` with JAX's keys.  Each test
saves both caches and puts them back, so no entry or counter leaks into a
later file.
"""

import numpy as np
import pytest
import torch

import torch_scenarios as ts
from kafkastreams_cep_tpu.utils import tracecache as jtc
from kafkastreams_cep_tpu_torch import EngineConfig, Record
from kafkastreams_cep_tpu_torch.convert import state_arrays
from kafkastreams_cep_tpu_torch.ops import scan_codegen
from kafkastreams_cep_tpu_torch.parallel.batch import BatchMatcher
from kafkastreams_cep_tpu_torch.parallel.tenantbank import TenantBankMatcher
from kafkastreams_cep_tpu_torch.runtime import CEPProcessor, restore_processor, save_checkpoint
from kafkastreams_cep_tpu_torch.utils import tracecache as ttc

CFG = dict(max_runs=8, slab_entries=16, slab_preds=4, dewey_depth=8, max_walk=8)
MODS = {"jax": jtc, "torch": ttc}


def _saved(mod):
    return (mod._store.copy(), mod._hits, mod._misses, mod._evictions)


def _restore(mod, saved):
    store, mod._hits, mod._misses, mod._evictions = saved
    mod._store.clear()
    mod._store.update(store)


@pytest.fixture(autouse=True)
def fresh_caches(monkeypatch):
    """Each test starts from two empty caches at the default capacity; the
    caches before it come back after it."""
    monkeypatch.delenv("CEP_TRACE_CACHE", raising=False)
    saved = {name: _saved(mod) for name, mod in MODS.items()}
    for mod in MODS.values():
        mod.clear()
    yield
    for name, mod in MODS.items():
        _restore(mod, saved[name])


def builder(log, tag):
    def build():
        log.append(tag)
        return ("built", tag, len(log))

    return build


#: Lookup sequences: (capacity setting, [(namespace, key)]); a ``None`` key
#: is an unkeyable pattern.
SEQUENCES = {
    "namespaces": ("", [("ns", "k"), ("ns", "k"), ("other", "k"), ("ns", "k")]),
    "lru": ("2", [("ns", "a"), ("ns", "b"), ("ns", "a"), ("ns", "c"), ("ns", "a"),
                  ("ns", "b"), ("ns", "c"), ("ns", "c")]),
    "unkeyable": ("", [("ns", None), ("ns", None), ("ns", "k"), ("ns", "k")]),
    "disabled": ("0", [("ns", "k"), ("ns", "k"), ("ns", "j")]),
    "off": ("off", [("ns", "k"), ("ns", "k")]),
    "capacity_one": ("1", [("a", 1), ("b", 1), ("a", 1), ("a", 1), ("b", 2), ("b", 2)]),
    "junk_setting": ("many", [("ns", "k"), ("ns", "k")]),
    "tuple_keys": ("3", [("batch.step", (("t", 1), (8, 16), "cpu")),
                         ("batch.step", (("t", 1), (8, 16), "cpu")),
                         ("batch.sweep", (8, True)), ("batch.scan", ("t", 2)),
                         ("batch.drain", ("x",)), ("batch.sweep", (8, True))]),
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_stats_equal_jax_on_the_same_sequence(monkeypatch, name):
    setting, seq = SEQUENCES[name]
    monkeypatch.setenv("CEP_TRACE_CACHE", setting)
    logs = {}
    for pkg, mod in MODS.items():
        log = logs.setdefault(pkg, [])
        got = [mod.lookup(ns, key, builder(log, (ns, key))) for ns, key in seq]
        logs[pkg] = (log, got)
    assert logs["torch"] == logs["jax"]
    assert ttc.stats() == jtc.stats()
    assert ttc.capacity() == jtc.capacity()
    for mod in MODS.values():
        mod.clear()
    assert ttc.stats() == jtc.stats() == dict(entries=0, hits=0, misses=0, evictions=0,
                                              capacity=jtc.capacity())


def test_batch_matcher_rebuild_hits_the_cache(monkeypatch):
    """A rebuilt ``BatchMatcher`` of a known (pattern, config, device) takes
    its step phases and scan sources from the cache, and scans as a fresh
    build does."""
    monkeypatch.setenv("CEP_SCAN_KERNEL", "1")
    pat = ts.strict3(ts.TQuery)
    ev = ts.events("letters", np.random.default_rng(3), 4, 12)
    first = BatchMatcher(pat, 4, EngineConfig(**CFG), device="cpu")
    s1, o1 = first.scan(first.init_state(), ev)
    mid = ttc.stats()
    assert mid["misses"] == 2 and mid["hits"] == 0  # batch.step and batch.scan
    calls = []
    real = scan_codegen.generate
    monkeypatch.setattr(scan_codegen, "generate", lambda *a: calls.append(1) or real(*a))
    again = BatchMatcher(pat, 8, EngineConfig(**CFG), device="cpu")  # K is not in the key
    assert again.phases is first.phases and again._scan_sources is first._scan_sources
    s2, o2 = again.scan(first.init_state(), ev)
    assert not calls  # the whole-scan source was not generated again
    after = ttc.stats()
    assert after["hits"] == 2 and after["entries"] == mid["entries"]
    x, y = state_arrays(s1), state_arrays(s2)
    assert x.keys() == y.keys() and all((x[k] == y[k]).all() for k in x)
    assert all(torch.equal(a, b) for a, b in zip(o1, o2))
    other = BatchMatcher(pat, 4, EngineConfig(**dict(CFG, max_walk=6)), device="cpu")
    assert other.phases is not first.phases  # another config, another entry


def test_processor_restore_and_tenant_bank_hit_the_cache(tmp_path):
    proc = CEPProcessor(ts.strict3(ts.TQuery), 4, EngineConfig(**CFG), epoch=0,
                        device="cpu")
    recs = [Record("k", v, 1000 + i) for i, v in enumerate((ts.A, ts.B, ts.C, ts.A))]
    out = proc.process(recs)
    save_checkpoint(proc, str(tmp_path / "p.ckpt"))
    before = ttc.stats()
    back = restore_processor(ts.strict3(ts.TQuery), str(tmp_path / "p.ckpt"), device="cpu")
    assert ttc.stats()["hits"] > before["hits"]
    assert back.batch.phases is proc.batch.phases
    assert len(out) == 1 and back.counters() == proc.counters()
    pats = [ts.strict3(ts.TQuery), ts.skip_till_any(ts.TQuery), ts.kleene_one_or_more(ts.TQuery)]
    cfg = EngineConfig(**dict(CFG, dewey_depth=32))
    b1 = TenantBankMatcher(pats, 2, cfg, device="cpu")
    mid = ttc.stats()
    b2 = TenantBankMatcher(pats, 2, cfg, device="cpu")
    assert ttc.stats()["hits"] > mid["hits"] and ttc.stats()["entries"] == mid["entries"]
    assert [g.programs for g in b2._groups] == [g.programs for g in b1._groups]
    assert b2._screen is b1._screen


def test_snapshot_trace_cache_has_the_jax_keys():
    proc = CEPProcessor(ts.strict3(ts.TQuery), 4, EngineConfig(**CFG), epoch=0,
                        device="cpu")
    proc.process([Record(0, v, t) for t, v in enumerate((ts.A, ts.B, ts.C))])
    tc = proc.metrics_snapshot()["trace_cache"]
    assert set(tc) == set(jtc.stats()) == {"entries", "hits", "misses", "evictions",
                                           "capacity"}
    assert tc["entries"] >= 1 and tc["misses"] >= 1
    assert tc["capacity"] == ttc._DEFAULT_CAPACITY == jtc._DEFAULT_CAPACITY
