"""The port's shard fault tolerance against the JAX package's, after
``tests/test_shard_fault.py:167-528``, ``tests/test_chaos.py:247-335``
(kill one shard) and ``tests/test_resume_crashwindow.py:252``.

The port's meshes are CPU placements of one process.  Each scenario holds
the port to the JAX package: ``surviving_mesh`` keeps the devices the JAX
one keeps; a lane move on a mesh equals the JAX package's move; a shard
lost, probed dead or declared lagging is evacuated onto the survivors and
the stream, the canonical state and the counters end as the JAX package's
fault-free single-device run ends; a hot-key rebalance drops and doubles
nothing; a checkpoint of a two-shard mesh resumes on one shard and on no
mesh.
"""

import collections
import os
import shutil

import jax
import numpy as np
import pytest

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.parallel import key_mesh as j_key_mesh
from kafkastreams_cep_tpu.parallel import surviving_mesh as j_surviving_mesh
from kafkastreams_cep_tpu.runtime import CEPProcessor as JProcessor
from kafkastreams_cep_tpu.runtime import Record as JRecord
from kafkastreams_cep_tpu.runtime import move_lanes as j_move_lanes
from kafkastreams_cep_tpu.runtime.migrate import canonical_state as j_canonical
from kafkastreams_cep_tpu_torch import CEPProcessor, EngineConfig, Record
from kafkastreams_cep_tpu_torch.convert import state_arrays
from kafkastreams_cep_tpu_torch.parallel import ShardLost, key_mesh, surviving_mesh
from kafkastreams_cep_tpu_torch.runtime import ShardPolicy, Supervisor, move_lanes
from kafkastreams_cep_tpu_torch.runtime.checkpoint import load_checkpoint
from kafkastreams_cep_tpu_torch.runtime.migrate import canonical_state
from kafkastreams_cep_tpu_torch.utils import failpoints as fp
from kafkastreams_cep_tpu_torch.utils.telemetry import InMemoryTraceSink

KEYS4 = ["k0", "k1", "k2", "k3"]
# tests/test_shard_fault.py's SUP_DIMS: loss-free on these streams, so the
# exactly-once and state-parity claims mean something.
SUP = dict(max_runs=64, slab_entries=96, slab_preds=12, dewey_depth=24, max_walk=12)


@pytest.fixture(autouse=True)
def clear_failpoints():
    yield
    fp.FAILPOINTS.clear()


def stream(R, keys, n, seed, start=0):
    """tests/test_shard_fault.py:250's seeded stream, explicit offsets."""
    rng = np.random.default_rng(seed)
    offs = {k: start for k in keys}
    out = []
    for i in range(n):
        k = keys[int(rng.integers(len(keys)))]
        out.append(R(k, int(rng.integers(0, 5)), 1000 + start * 8 + i, offset=offs[k]))
        offs[k] += 1
    return out


def skew_batches(R, seed):
    """tests/test_shard_fault.py:384: a warm-up batch touches all four
    lanes, then only k0 and k1 (shard 0 of a two-shard mesh) get work."""
    rng = np.random.default_rng(seed)
    offs = {k: 0 for k in KEYS4}
    batches = []
    for i in range(8):
        recs = []
        for j in range(8):
            k = KEYS4[int(rng.integers(2))] if i else KEYS4[j % 4]
            recs.append(R(k, int(rng.integers(0, 5)), 1000 + 8 * i + j, offset=offs[k]))
            offs[k] += 1
        batches.append(recs)
    return batches


def canon(matches):
    return sorted((k, tuple(sorted((stage, tuple(e.offset for e in evs))
                                   for stage, evs in seq.as_map().items())))
                  for k, seq in matches)


def as_jax(batches):
    return [[JRecord(*r) for r in b] for b in batches]


def jax_oracle(batches, conf=SUP, query=ts.skip_till_any, lanes=4):
    """The JAX package's fault-free single-device run of the same batches:
    its processor and its emitted matches."""
    proc = JProcessor(query(ts.JQuery), lanes, JConfig(**conf), gc_interval=0)
    out = [m for b in as_jax(batches) for m in proc.process(b)] + proc.flush()
    return proc, out


def assert_canonical_equal(jax_state, port_proc, msg=""):
    a = state_arrays(j_canonical(jax_state))
    b = state_arrays(canonical_state(port_proc.host_state()))
    assert a.keys() == b.keys(), msg
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=f"{msg} {name}")


def meshed_supervisor(tmp_path, mesh, **kw):
    return Supervisor(ts.skip_till_any(ts.TQuery), 4, EngineConfig(**SUP),
                      checkpoint_path=str(tmp_path / "s.ckpt"),
                      journal_path=str(tmp_path / "s.jrnl"), checkpoint_every=2,
                      gc_interval=0, retry_backoff_ms=0, mesh=mesh, **kw)


def lost(shard):
    return lambda: ShardLost("injected device loss", shard=shard)


# -- surviving_mesh and move_lanes -----------------------------------------------


@pytest.mark.skipif(jax.device_count() < 8, reason="needs the 8-device virtual mesh")
def test_surviving_mesh_keeps_the_jax_packages_devices():
    jmesh = j_key_mesh(jax.devices()[:8])
    mesh = key_mesh([f"cpu:{i}" for i in range(8)])
    for dead, lanes in (([3], 16), ([0, 1, 2, 3, 4, 5], 16), ([7], 14), ([2, 5], 12)):
        jsub = j_surviving_mesh(jmesh, dead, lanes)
        sub = surviving_mesh(mesh, dead, lanes)
        assert [d.index for d in sub.devices] == [d.id for d in jsub.devices.flat]
        assert sub.axis_names == tuple(jsub.axis_names)
    with pytest.raises(ValueError, match="every mesh shard is dead"):
        surviving_mesh(mesh, range(8), 16)


def test_move_lanes_on_a_mesh_equals_jax():
    """A lane move on a two-shard mesh (the same mesh, as a rebalance does)
    equals the JAX package's move: the emitted stream, the canonical state
    row for row and the counters; a second move lands on one device."""
    perm = np.array([2, 0, 3, 1])
    head, tail = stream(Record, KEYS4, 24, 5), stream(Record, KEYS4, 24, 6, start=6)
    more = stream(Record, KEYS4, 16, 7, start=12)
    j = JProcessor(ts.skip_till_any(ts.JQuery), 4, JConfig(**SUP), gc_interval=0)
    jm = list(j.process(as_jax([head])[0]))
    j = j_move_lanes(ts.skip_till_any(ts.JQuery), j, perm)
    jm += j.process(as_jax([tail])[0]) + j.flush()

    mesh = key_mesh(["cpu"] * 2)
    p = CEPProcessor(ts.skip_till_any(ts.TQuery), 4, EngineConfig(**SUP), gc_interval=0,
                     mesh=mesh)
    pm = list(p.process(head))
    p = move_lanes(ts.skip_till_any(ts.TQuery), p, perm)
    assert p.mesh is mesh and p._lane_of == dict(j._lane_of)
    pm += p.process(tail) + p.flush()
    assert canon(pm) == canon(jm) and pm
    assert_canonical_equal(j.state, p, "move_lanes on a mesh")
    assert p.counters() == j.counters() and not any(p.counters().values())
    single = move_lanes(ts.skip_till_any(ts.TQuery), p, np.argsort(perm), mesh=None)
    j = j_move_lanes(ts.skip_till_any(ts.JQuery), j, np.argsort(perm))
    assert single.mesh is None
    assert canon(single.process(more)) == canon(j.process(as_jax([more])[0]))
    assert_canonical_equal(j.state, single, "moved back onto one device")


def test_move_lanes_fault_leaves_old_processor_intact():
    """``rebalance.move`` fires before anything moves: the old meshed
    processor keeps its assignment and goes on as the JAX one does."""
    proc = CEPProcessor(ts.skip_till_any(ts.TQuery), 4, EngineConfig(**SUP), gc_interval=0,
                        mesh=key_mesh(["cpu"] * 2))
    first = stream(Record, KEYS4, 16, 1)
    later = stream(Record, KEYS4, 16, 2, start=4)
    got = list(proc.process(first))
    lanes_before = dict(proc._lane_of)
    with fp.FAILPOINTS.session({"rebalance.move": [0]}):
        with pytest.raises(fp.InjectedIOError):
            move_lanes(ts.skip_till_any(ts.TQuery), proc, [1, 0, 3, 2])
    assert proc._lane_of == lanes_before
    got += proc.process(later) + proc.flush()
    _, want = jax_oracle([first, later])
    assert canon(got) == canon(want)


# -- the supervisor: evacuation, probe, stragglers, rebalancing --------------------


def test_supervisor_evacuates_lost_shard(tmp_path):
    """A ShardLost at ``shard.dispatch`` evacuates onto the surviving
    sub-mesh and the stream goes on degraded: matches, canonical state
    and counters are the JAX package's fault-free single-device run's."""
    batches = [stream(Record, KEYS4, 8, 40 + i, start=2 * i) for i in range(4)]
    sup = meshed_supervisor(tmp_path, key_mesh(["cpu"] * 2))
    assert sup._shard_policy == ShardPolicy()
    got = list(sup.process(batches[0]))
    with fp.FAILPOINTS.session({"shard.dispatch": [0]}, exc=lost(1)):
        got += sup.process(batches[1])
    assert sup.evacuations == 1 and sup.recoveries == 0
    assert sup._mesh().size == 1 and sup.processor.mesh.size == 1
    for b in batches[2:]:
        got += sup.process(b)
    got += sup.processor.flush()
    oracle, want = jax_oracle(batches)
    assert canon(got) == canon(want)
    assert_canonical_equal(oracle.state, sup.processor, "post-evacuation")
    assert sup.processor.counters() == oracle.counters()
    assert not any(sup.processor.counters().values())
    snap = sup.metrics_snapshot(per_lane=False)
    assert snap["evacuations"] == 1 and snap["phases"]["evacuate"]["count"] == 1
    # The post-evacuation snapshot pinned the one-shard assignment.
    assert load_checkpoint(sup.checkpoint_path)["header"]["mesh_size"] == 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_unmeshed_shard_loss_crashes(tmp_path, pkg):
    """With no mesh there is nowhere to evacuate: ShardLost escapes like an
    exhausted retry, in both packages."""
    if pkg == "jax":
        from kafkastreams_cep_tpu.parallel import ShardLost as JLost
        from kafkastreams_cep_tpu.runtime import ShardPolicy as JPolicy
        from kafkastreams_cep_tpu.runtime import Supervisor as JSup
        from kafkastreams_cep_tpu.utils import failpoints as jfp

        sup = JSup(ts.skip_till_any(ts.JQuery), 2, JConfig(**SUP), gc_interval=0,
                   checkpoint_path=str(tmp_path / "j.ckpt"), shard_policy=JPolicy())
        recs, f, exc = as_jax([stream(Record, ["k0", "k1"], 8, 3)])[0], jfp, JLost
    else:
        sup = Supervisor(ts.skip_till_any(ts.TQuery), 2, EngineConfig(**SUP), gc_interval=0,
                         checkpoint_path=str(tmp_path / "t.ckpt"), shard_policy=ShardPolicy(),
                         device="cpu")
        recs, f, exc = stream(Record, ["k0", "k1"], 8, 3), fp, ShardLost
    try:
        with f.FAILPOINTS.session({"device.dispatch": [0, 1]},
                                  exc=lambda: exc("injected", shard=0)):
            with pytest.raises(exc):
                sup.process(recs)
    finally:
        f.FAILPOINTS.clear()
    assert sup.evacuations == 0


def test_shard_probe_routes_generic_error_to_evacuation(tmp_path):
    batches = [stream(Record, KEYS4, 8, 60 + i, start=2 * i) for i in range(3)]
    sup = meshed_supervisor(tmp_path, key_mesh(["cpu"] * 2), shard_probe=lambda: [0])
    got = list(sup.process(batches[0]))
    with fp.FAILPOINTS.session({"device.dispatch": [0]}):
        got += sup.process(batches[1])
    assert sup.evacuations == 1 and sup.recoveries == 0
    got += sup.process(batches[2]) + sup.processor.flush()
    assert canon(got) == canon(jax_oracle(batches)[1])


def test_evacuation_span_and_stall_carry_the_batch_correlation(tmp_path):
    """The evacuation span and the ledger's ``stall.evacuate`` exemplar
    name the batch the evacuation rolled back, and the ledger, restored
    from the checkpoint header, keeps the batches of both sides."""
    batches = [stream(Record, KEYS4, 8, 90 + i, start=2 * i) for i in range(2)]
    sink = InMemoryTraceSink()
    sup = meshed_supervisor(tmp_path, key_mesh(["cpu"] * 2), trace_sink=sink, latency=True)
    sup.process(batches[0])
    with fp.FAILPOINTS.session({"shard.dispatch": [0]}, exc=lost(1)):
        sup.process(batches[1])
    assert sup.evacuations == 1
    span = sink.spans("evacuate")[0]
    assert span["dead_shards"] == [1] and span["survivors"] == 1
    assert len([s for s in sink.spans("supervisor.batch") if s["corr"] == span["corr"]]) == 1
    ex = sup.processor.ledger.exemplars["stall.evacuate"]
    assert ex["corr"] == span["corr"] and ex["seconds"] > 0
    snap = sup.metrics_snapshot(per_lane=False)
    assert snap["latency"]["stalls"]["evacuate"]["count"] == 1
    assert snap["latency"]["batches"] >= 2


def test_straggler_declaration_and_evacuation(tmp_path):
    policy = ShardPolicy(straggler_factor=2.0, straggler_window=4, straggler_streak=3)
    batches = [stream(Record, KEYS4, 8, 80 + i, start=2 * i) for i in range(3)]
    sup = meshed_supervisor(tmp_path, key_mesh(["cpu"] * 2), shard_policy=policy)
    got = list(sup.process(batches[0]))
    declared = False
    for _ in range(5):
        sup.observe_shard_latency(0, 0.010)
        declared = sup.observe_shard_latency(1, 0.200) or declared
    assert declared and sup.stragglers == 1 and sup.evacuations == 0
    got += sup.process(batches[1])  # the batch boundary evacuates it
    assert sup.evacuations == 1 and not sup._lagging and sup._mesh().size == 1
    got += sup.process(batches[2]) + sup.processor.flush()
    assert canon(got) == canon(jax_oracle(batches)[1])
    assert sup.metrics_snapshot(per_lane=False)["stragglers"] == 1


REBALANCE = ShardPolicy(rebalance_skew=1.2, rebalance_min_hops=8, rebalance_streak=1,
                        rebalance_cooldown=0)


def test_hot_key_rebalance_is_lossfree(tmp_path):
    """Shard 0 takes all the work; a checkpoint boundary moves hot lanes
    and the stream is the JAX package's, nothing dropped or doubled."""
    sink = InMemoryTraceSink()
    sup = meshed_supervisor(tmp_path, key_mesh(["cpu"] * 2), shard_policy=REBALANCE,
                            trace_sink=sink)
    batches = skew_batches(Record, 9)
    got = [m for b in batches for m in sup.process(b)] + sup.processor.flush()
    assert sup.rebalances >= 1 and sup.lanes_moved >= 1 and sup.rebalance_failures == 0
    oracle, want = jax_oracle(batches)
    assert canon(got) == canon(want)
    assert not any(sup.processor.counters().values())
    snap = sup.metrics_snapshot(per_lane=False)
    assert (snap["rebalances"], snap["lanes_moved"]) == (sup.rebalances, sup.lanes_moved)
    assert snap["phases"]["rebalance"]["count"] >= 1
    span = sink.spans("rebalance")[0]
    assert span["lanes_moved"] >= 1 and span["hot_keys"]
    # The moved lanes hold the keys' state: the canonical state, rows
    # permuted by the key routing, is the JAX run's.
    perm = np.array([oracle._lane_of[sup.processor._key_of[i]] for i in range(4)])
    a = state_arrays(j_canonical(oracle.state))
    b = state_arrays(canonical_state(sup.processor.host_state()))
    for name in a:
        np.testing.assert_array_equal(a[name][perm], b[name], err_msg=name)


def test_rebalance_move_fault_keeps_the_old_assignment(tmp_path):
    sup = meshed_supervisor(tmp_path, key_mesh(["cpu"] * 2), shard_policy=REBALANCE)
    batches = skew_batches(Record, 9)
    got = []
    with fp.FAILPOINTS.session({"rebalance.move": list(range(99))}):
        for b in batches:
            got += sup.process(b)
    got += sup.processor.flush()
    assert sup.rebalances == 0 and sup.rebalance_failures >= 1
    assert canon(got) == canon(jax_oracle(batches)[1])


# -- kill-one-shard chaos (tests/test_chaos.py:247) ------------------------------------

CHAOS = dict(max_runs=16, slab_entries=48, slab_preds=8, dewey_depth=16, max_walk=12)


def chaos_batches(seed, n_batches=6, size=4):
    """tests/test_chaos.py:75's stream."""
    rng = np.random.default_rng(seed)
    offs = collections.defaultdict(int)
    batches, t = [], 0
    for _ in range(n_batches):
        recs = []
        for _ in range(size):
            k = ("k0", "k1")[int(rng.integers(2))]
            recs.append(Record(k, int(rng.integers(0, 5)), 1000 + t, offset=offs[k]))
            offs[k] += 1
            t += 1
        batches.append(recs)
    return batches


def chaos_key(key, seq):
    return (key, tuple(sorted((stage, tuple(sorted(e.offset for e in evs)))
                              for stage, evs in seq.as_map().items())))


@pytest.mark.parametrize("seed", [0, 3])
def test_kill_one_shard_chaos_ends_in_the_jax_oracle(tmp_path, seed):
    """At a seed-chosen batch one shard of two dies; process crashes (and
    resumes onto the mesh the last snapshot pinned) interleave; the end
    state and the emitted multiset are the JAX package's fault-free run's."""
    batches = chaos_batches(seed)
    rng = np.random.default_rng(seed + 20_000)
    ck, jr = str(tmp_path / "c.ckpt"), str(tmp_path / "c.jrnl")
    mesh = key_mesh(["cpu"] * 2)

    def make(resume, m):
        args = (ts.skip_till_any(ts.TQuery), 2, EngineConfig(**CHAOS))
        kw = dict(checkpoint_path=ck, journal_path=jr, checkpoint_every=2, gc_interval=0,
                  retry_backoff_ms=0, mesh=m)
        return Supervisor.resume(*args, **kw) if resume else Supervisor(*args, **kw)

    sup = make(False, mesh)
    emitted = collections.Counter()
    kill_at, dead = int(rng.integers(1, len(batches))), int(rng.integers(2))
    killed, evacuations, crashes, i, guard = False, 0, 0, 0, 0
    while i < len(batches):
        guard += 1
        assert guard < 200, "the schedule made no progress"
        if i == kill_at and not killed:
            fp.FAILPOINTS.arm("shard.dispatch", times=1, exc=lost(dead))
        crash_after = rng.random() < 0.15
        try:
            for k, seq in sup.process(batches[i]):
                emitted[chaos_key(k, seq)] += 1
            i += 1
        finally:
            killed = killed or fp.FAILPOINTS.hits("shard.dispatch") > 0
            fp.FAILPOINTS.clear()
        evacuations = max(evacuations, sup.evacuations)
        if crash_after:
            crashes += 1
            cur = sup._proc_kwargs.get("mesh", mesh)
            del sup
            sup = make(True, cur)
            i = 0  # an at-least-once source re-submits all; dedup absorbs
    assert killed and evacuations >= 1, (seed, killed, evacuations)
    want = collections.Counter()
    j = JProcessor(ts.skip_till_any(ts.JQuery), 2, JConfig(**CHAOS), gc_interval=0)
    for b in as_jax(batches):
        for k, seq in j.process(b):
            want[chaos_key(k, seq)] += 1
    for k, seq in j.flush():
        want[chaos_key(k, seq)] += 1
    assert emitted == want, f"seed {seed}: crashes {crashes}"
    assert_canonical_equal(j.state, sup.processor, f"seed {seed}")
    assert not any(sup.processor.counters().values())


# -- resume on a shrunk mesh (tests/test_resume_crashwindow.py:252) -----------------------


def test_resume_on_shrunk_mesh(tmp_path):
    """A two-shard supervisor's snapshot and journal resume on a one-shard
    mesh and on no mesh; replay and later traffic match the JAX package's
    uninterrupted single-device run."""
    keys = ("k0", "k1")
    vals = [ts.A, ts.B, ts.C, ts.A, ts.B]
    batches = [[Record(k, v, 1000 + 10 * i + j, offset=i) for j, k in enumerate(keys)]
               for i, v in enumerate(vals)]
    tail = [Record(k, ts.C, 9000 + j, offset=5) for j, k in enumerate(keys)]
    ck, jr = str(tmp_path / "mesh.ckpt"), str(tmp_path / "mesh.jrnl")
    conf = dict(max_runs=16, slab_entries=48, slab_preds=6, dewey_depth=10, max_walk=10)
    sup = Supervisor(ts.strict3(ts.TQuery), 2, EngineConfig(**conf), checkpoint_path=ck,
                     journal_path=jr, checkpoint_every=3, gc_interval=0,
                     mesh=key_mesh(["cpu"] * 2))
    emitted = [m for b in batches for m in sup.process(b)]
    assert sup.checkpoints >= 1
    assert load_checkpoint(ck)["header"]["mesh_size"] == 2
    del sup  # the crash
    frozen = {p: p + ".frozen" for p in (ck, jr, ck + ".prev", jr + ".prev")
              if os.path.exists(p)}
    for p, f in frozen.items():
        shutil.copy(p, f)
    j = JProcessor(ts.strict3(ts.JQuery), 2, JConfig(**conf), gc_interval=0)
    want = [m for b in as_jax(batches + [tail]) for m in j.process(b)]
    for target in (key_mesh(["cpu"]), None):
        for p, f in frozen.items():
            shutil.copy(f, p)
        kw = dict(mesh=target) if target is not None else dict(device="cpu")
        res = Supervisor.resume(ts.strict3(ts.TQuery), 2, EngineConfig(**conf),
                                checkpoint_path=ck, journal_path=jr, gc_interval=0, **kw)
        assert res._seq == len(batches)
        assert res.processor.mesh is target
        more = res.process(tail)
        assert ts.canon_matches(emitted + more) == ts.canon_matches(want)
        assert_canonical_equal(j.state, res.processor, f"resumed onto {target}")
