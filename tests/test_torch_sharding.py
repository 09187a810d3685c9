"""The port's mesh (``parallel/sharding.py`` and the meshed processor,
checkpoint and supervisor) against the JAX package's, after
``tests/test_parallel.py`` and ``tests/test_sharded_runtime.py``.

The JAX side runs on the suite's eight virtual CPU devices; the port's
mesh is eight (or four, or two) CPU placements of one process.  Every case
holds the two bit for bit: the scan's outputs, the state leaves gathered in
logical lane order, the summed, per-stage and per-lane counters, the
emitted streams and their order.  A checkpoint written on one mesh size
restores on another, in either package.  The JAX runs are made once per
module (a JAX mesh program costs seconds to compile).
"""

import jax
import numpy as np
import pytest
import torch

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.parallel import ShardedMatcher as JSharded
from kafkastreams_cep_tpu.parallel import key_mesh as j_key_mesh
from kafkastreams_cep_tpu.runtime import CEPProcessor as JProcessor
from kafkastreams_cep_tpu.runtime import Record as JRecord
from kafkastreams_cep_tpu.runtime.checkpoint import restore_processor as j_restore
from kafkastreams_cep_tpu.runtime.checkpoint import save_checkpoint as j_save
from kafkastreams_cep_tpu.utils.latency import LatencyLedger as JLedger
from kafkastreams_cep_tpu_torch import CEPProcessor, EngineConfig, Record
from kafkastreams_cep_tpu_torch.convert import state_arrays
from kafkastreams_cep_tpu_torch.parallel import (
    BatchMatcher, ShardedMatcher, ShardedState, key_mesh,
)
from kafkastreams_cep_tpu_torch.runtime import Supervisor, check_health
from kafkastreams_cep_tpu_torch.runtime.checkpoint import (
    load_checkpoint, restore_processor, save_checkpoint,
)
from kafkastreams_cep_tpu_torch.utils.latency import LatencyLedger

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs the 8-device virtual mesh")

K, T = 16, 24
# tests/test_sharded_runtime.py's tight config: the kleene trace overflows
# it differently on every lane, so a cross-shard mixup changes the totals.
TIGHT = dict(max_runs=8, slab_entries=24, slab_preds=4, dewey_depth=8, max_walk=8)


def kleene(Q):
    """tests/test_sharded_runtime.py:180's counter-heavy kleene query."""
    return (
        Q().select("a").where(lambda k, v, ts, st: v["x"] == 0)
        .then().select("b").one_or_more().skip_till_any_match()
        .where(lambda k, v, ts, st: (0 < v["x"]) & (v["x"] < 8))
        .then().select("c").where(lambda k, v, ts, st: v["x"] >= 8)
        .build()
    )


def kleene_events(seed=11):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 10, size=(K, T)).astype(np.int32)
    ev = ts.events("letters", rng, K, T)
    return ev._replace(value={"x": torch.as_tensor(xs)})


@pytest.fixture(scope="module")
def jax_scan():
    """The JAX ShardedMatcher's scan of the kleene trace on 8 devices, with
    stage attribution: outputs, state leaves, stats and the telemetry."""
    events = kleene_events()
    cfg = JConfig(**TIGHT, stage_attribution=True)
    sm = JSharded(kleene(ts.JQuery), K, j_key_mesh(jax.devices()[:8]), cfg)
    state, out = sm.scan(sm.init_state(), sm.shard_events(ts.to_jax(events)))
    return dict(
        events=events, state=jax.device_get(state),
        out={f: np.asarray(getattr(out, f)) for f in out._fields},
        stats=sm.stats(state), stage=sm.stage_counters(state),
        per_lane=sm.per_lane_counters(state),
        snap=sm.metrics_snapshot(state, watermark=5000, clock=lambda: 6.0,
                                 ledgers=ledgers(JLedger)),
    )


def ledgers(Ledger):
    """Two hosts' latency ledgers, each with a stall (the merged one goes
    into the snapshot's ``latency``)."""
    out = []
    for i, seconds in enumerate((0.25, 0.5)):
        led = Ledger(clock=lambda: 0.0)
        led.observe_stall("evacuate", seconds, corr=f"batch-{i}")
        out.append(led)
    return out


@pytest.mark.parametrize("scan_kernel", ["0", "1"])
def test_sharded_scan_equals_jax(jax_scan, monkeypatch, scan_kernel):
    """Per step (the walk pass on every shard) and as one whole scan a
    shard (``CEP_SCAN_KERNEL=1``, the plain version on the CPU): outputs,
    gathered state, stats, stage and per-lane counters and the snapshot
    equal the JAX mesh's, and the stats are nonzero where it matters."""
    monkeypatch.setenv("CEP_SCAN_KERNEL", scan_kernel)
    cfg = EngineConfig(**TIGHT, stage_attribution=True)
    sm = ShardedMatcher(kleene(ts.TQuery), K, key_mesh(["cpu"] * 8), cfg)
    assert sm.uses_scan_kernel == (scan_kernel == "1") and sm.per_shard == 2
    state, out = sm.scan(sm.init_state(), jax_scan["events"])
    assert isinstance(state, ShardedState) and len(state.shards) == 8
    for f in out._fields:
        np.testing.assert_array_equal(getattr(out, f).numpy(), jax_scan["out"][f], err_msg=f)
    ts.assert_states_equal(jax_scan["state"], sm.gather(state))
    stats = sm.stats(state)
    assert stats == jax_scan["stats"]
    assert sum(stats[n] for n in ("run_drops", "slab_full_drops", "slab_pred_drops")) > 0
    assert sm.counters(state) == {n: stats[n] for n in sm.counters(state)}
    assert sm.stage_counters(state) == jax_scan["stage"]
    assert sm.per_lane_counters(state) == jax_scan["per_lane"]
    snap = sm.metrics_snapshot(state, watermark=5000, clock=lambda: 6.0,
                               ledgers=ledgers(LatencyLedger))
    assert snap["latency"]["stalls"]["evacuate"]["count"] == 2
    assert snap == jax_scan["snap"]


def test_sharded_equals_unsharded_batch_matcher(jax_scan):
    """The mesh is invisible: the port's own single-device BatchMatcher
    gives the same outputs and state."""
    cfg = EngineConfig(**TIGHT, stage_attribution=True)
    bm = BatchMatcher(kleene(ts.TQuery), K, cfg, device="cpu")
    st, out = bm.scan(bm.init_state(), jax_scan["events"])
    for f in out._fields:
        np.testing.assert_array_equal(getattr(out, f).numpy(), jax_scan["out"][f])
    ts.assert_states_equal(jax_scan["state"], st)


def test_sharded_step_single_event():
    """One sharded step (tests/test_parallel.py:83)."""
    n = 8
    conf = dict(max_runs=16, slab_entries=48, slab_preds=6, dewey_depth=10, max_walk=10)
    jm = JSharded(ts.strict3(ts.JQuery), n, j_key_mesh(jax.devices()[:8]), JConfig(**conf))
    sm = ShardedMatcher(ts.strict3(ts.TQuery), n, key_mesh(["cpu"] * 8), EngineConfig(**conf))
    i32 = torch.int32
    ev = ts.events("letters", np.random.default_rng(0), n, 1)
    ev = ev._replace(key=torch.arange(n, dtype=i32), value=torch.zeros(n, dtype=i32),
                     ts=torch.full((n,), 1000, dtype=i32), off=torch.zeros(n, dtype=i32),
                     valid=torch.ones(n, dtype=torch.bool))
    state, out = sm.step(sm.init_state(), sm.shard_events(ev))
    jstate, jout = jm.step(jm.init_state(), jm.shard_events(ts.to_jax(ev)))
    assert int(out.count.sum()) == 0
    assert sm.stats(state) == jm.stats(jstate) and sm.stats(state)["alive_runs"] == 2 * n
    ts.assert_states_equal(jax.device_get(jstate), sm.gather(state))


def test_gather_place_round_trip_and_refusals():
    cfg = EngineConfig(**TIGHT)
    sm = ShardedMatcher(kleene(ts.TQuery), K, key_mesh(["cpu"] * 4), cfg)
    state, _ = sm.scan(sm.init_state(), kleene_events(3))
    host = sm.gather(state)
    back = sm.place_arrays(state_arrays(host))
    for a, b in zip(state.shards, back.shards):
        ts.assert_states_equal(a, b)
    with pytest.raises(ValueError, match="divisible"):
        ShardedMatcher(kleene(ts.TQuery), 6, key_mesh(["cpu"] * 4), cfg)
    with pytest.raises(ValueError, match="lane axis"):
        sm.place_arrays({k: v[:3] for k, v in state_arrays(host).items()})


def test_key_mesh_names_cuda_only_with_a_gpu():
    mesh = key_mesh(["cpu"] * 3, axis="time")
    assert mesh.size == 3 and mesh.axis_names == ("time",)
    if torch.cuda.is_available():
        assert key_mesh().size == torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match="cuda"):
        key_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        key_mesh(["cuda:0", "cuda:0"])


# -- the meshed processor, checkpoint and supervisor ---------------------------------

NUM_LANES = 16
RT = dict(max_runs=8, slab_entries=24, slab_preds=4, dewey_depth=8, max_walk=8)


def rt_pattern(Q):
    """tests/test_sharded_runtime.py:40's query."""
    return (
        Q().select("lo").where(lambda k, v, ts, st: v["x"] < 3)
        .then().select("hi").skip_till_next_match()
        .where(lambda k, v, ts, st: v["x"] > 6)
        .build()
    )


def rt_batches(R, n=144, seed=3, size=24):
    rng = np.random.default_rng(seed)
    recs = [R(int(rng.integers(0, NUM_LANES)), {"x": int(rng.integers(0, 10))}, 1000 + i)
            for i in range(n)]
    return [recs[i:i + size] for i in range(0, n, size)]


def fmt(matches):
    return [(key, [(name, tuple(e.offset for e in evs)) for name, evs in seq.as_map().items()])
            for key, seq in matches]


CUT = 3


@pytest.fixture(scope="module")
def jax_stream(tmp_path_factory):
    """The JAX processor on its 8-device mesh over the stream: each
    batch's emissions, and a checkpoint after batch CUT."""
    d = tmp_path_factory.mktemp("jaxmesh")
    proc = JProcessor(rt_pattern(ts.JQuery), NUM_LANES, JConfig(**RT),
                      mesh=j_key_mesh(jax.devices()[:8]))
    out = []
    for i, b in enumerate(rt_batches(JRecord)):
        out.append(fmt(proc.process(b)))
        if i + 1 == CUT:
            j_save(proc, str(d / "j8.ckpt"))
    return dict(out=out, ckpt=str(d / "j8.ckpt"), counters=proc.counters())


def test_meshed_processor_emits_the_jax_mesh_stream(jax_stream, tmp_path):
    """Emission parity, and crash, restore and replay on the same mesh
    (tests/test_sharded_runtime.py:79-110)."""
    mesh = key_mesh(["cpu"] * 8)
    proc = CEPProcessor(rt_pattern(ts.TQuery), NUM_LANES, EngineConfig(**RT), mesh=mesh)
    assert proc.lane_shards() == [k // 2 for k in range(NUM_LANES)]
    bs = rt_batches(Record)
    got = [fmt(proc.process(b)) for b in bs[:CUT]]
    path = str(tmp_path / "t8.ckpt")
    save_checkpoint(proc, path)
    header = load_checkpoint(path)["header"]
    assert header["mesh_size"] == 8 and header["lane_shards"] == proc.lane_shards()
    got += [fmt(proc.process(b)) for b in bs[CUT:]]
    assert got == jax_stream["out"] and any(got)
    assert proc.counters() == jax_stream["counters"]
    del proc  # the crash
    restored = restore_processor(rt_pattern(ts.TQuery), path, mesh=mesh)
    assert [fmt(restored.process(b)) for b in bs[CUT:]] == jax_stream["out"][CUT:]


def test_checkpoints_cross_load_across_mesh_sizes(jax_stream, tmp_path):
    """A JAX snapshot of 8 shards restores on a 4-shard port mesh and on
    one device; a port snapshot of 4 shards restores on a 2-device JAX
    mesh; each continues with the uninterrupted stream
    (tests/test_sharded_runtime.py:112-140)."""
    bs, jbs = rt_batches(Record), rt_batches(JRecord)
    want = jax_stream["out"][CUT:]
    port4 = restore_processor(rt_pattern(ts.TQuery), jax_stream["ckpt"],
                              mesh=key_mesh(["cpu"] * 4))
    single = restore_processor(rt_pattern(ts.TQuery), jax_stream["ckpt"], device="cpu")
    assert port4.mesh.size == 4 and single.mesh is None
    path = str(tmp_path / "t4.ckpt")
    save_checkpoint(port4, path)
    assert load_checkpoint(path)["header"]["mesh_size"] == 4
    jax2 = j_restore(rt_pattern(ts.JQuery), path, mesh=j_key_mesh(jax.devices()[:2]))
    for i, (b, jb) in enumerate(zip(bs[CUT:], jbs[CUT:])):
        assert fmt(port4.process(b)) == want[i]
        assert fmt(single.process(b)) == want[i]
        assert fmt(jax2.process(jb)) == want[i]
    with pytest.raises(ValueError, match="divisible"):
        restore_processor(rt_pattern(ts.TQuery), path, mesh=key_mesh(["cpu"] * 3))


@pytest.mark.parametrize("mode", ["pipeline", "lazy"])
def test_meshed_pipelined_and_lazy_processors(jax_stream, mode):
    """A pipelined meshed processor (each batch's matches one call late)
    emits the JAX mesh's stream in order; a lazy one (handles drained on
    every shard every second batch, deferred ones ordered by completion
    step and lane) the unmeshed lazy processor's, which
    tests/test_torch_lazy.py holds against the JAX package's; a sweep every
    batch."""
    extra = {} if mode == "pipeline" else dict(lazy_extraction=True, handle_ring=64)
    kw = dict(pipeline=True) if mode == "pipeline" else dict(drain_interval=2)
    proc = CEPProcessor(rt_pattern(ts.TQuery), NUM_LANES, EngineConfig(**RT, **extra),
                        mesh=key_mesh(["cpu"] * 4), gc_interval=1, **kw)
    got = [m for b in rt_batches(Record) for m in proc.process(b)] + proc.flush()
    if mode == "pipeline":
        want = [m for batch in jax_stream["out"] for m in batch]
    else:
        one = CEPProcessor(rt_pattern(ts.TQuery), NUM_LANES, EngineConfig(**RT, **extra),
                           device="cpu", gc_interval=1, **kw)
        want = fmt([m for b in rt_batches(Record) for m in one.process(b)] + one.flush())
    assert fmt(got) == want and got
    assert proc.counters() == jax_stream["counters"]


def test_meshed_processor_refuses_tiering():
    with pytest.raises(ValueError, match="single-chip"):
        CEPProcessor(rt_pattern(ts.TQuery), NUM_LANES, EngineConfig(**RT, tiering=True),
                     mesh=key_mesh(["cpu"] * 2))


def test_meshed_supervisor_crash_and_resume(jax_stream, tmp_path):
    """The supervisor flow (checkpoints, journal, a process crash and
    ``Supervisor.resume``) on a meshed processor emits the JAX mesh's
    stream (tests/test_sharded_runtime.py:142-168)."""
    ck, jr = str(tmp_path / "sup.ckpt"), str(tmp_path / "sup.jrnl")
    bs = rt_batches(Record)
    sup = Supervisor(rt_pattern(ts.TQuery), NUM_LANES, EngineConfig(**RT), checkpoint_path=ck,
                     journal_path=jr, checkpoint_every=2, mesh=key_mesh(["cpu"] * 8))
    got = [fmt(sup.process(b)) for b in bs[:4]]
    del sup  # the process crash
    sup2 = Supervisor.resume(rt_pattern(ts.TQuery), NUM_LANES, EngineConfig(**RT),
                             checkpoint_path=ck, journal_path=jr, mesh=key_mesh(["cpu"] * 8))
    assert sup2.processor.mesh.size == 8 and sup2._seq == 4
    got += [fmt(sup2.process(b)) for b in bs[4:]]
    assert got == jax_stream["out"]
    snap = sup2.metrics_snapshot()
    assert snap["evacuations"] == 0 and len(snap["per_lane"]["walk_hops"]) == NUM_LANES


def test_meshed_processor_snapshot_and_columns(monkeypatch):
    """The meshed processor's telemetry is the unmeshed one's (the tier
    counters as structural zeros, per-lane rows in lane order), and the
    columnar path and the whole-scan switch run on the mesh too."""
    monkeypatch.setenv("CEP_SCAN_KERNEL", "1")
    rng = np.random.default_rng(4)
    n = 96
    keys = rng.integers(0, NUM_LANES, size=n)
    xs = rng.integers(0, 10, size=n).astype(np.int32)
    stamps = 1000 + np.arange(n, dtype=np.int64)
    procs = [CEPProcessor(rt_pattern(ts.TQuery), NUM_LANES, EngineConfig(**RT), mesh=m,
                          device="cpu", gc_events_interval=1)
             for m in (None, key_mesh(["cpu"] * 4))]
    outs = [fmt(p.process_columns(keys, {"x": xs}, stamps)) for p in procs]
    assert outs[0] == outs[1] and outs[0]
    assert procs[1].uses_scan_kernel
    a, b = (p.metrics_snapshot() for p in procs)
    for key in ("per_lane", "per_key", "run_drops", "walk_hops", "prefix_fires"):
        assert a[key] == b[key], key
    assert a.keys() == b.keys()
    assert check_health(procs[1]).counters == check_health(procs[0]).counters
    assert check_health(procs[1]).healthy
