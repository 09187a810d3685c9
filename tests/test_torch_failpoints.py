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
