"""The port's slab, Dewey, renorm and decode passes against the JAX
package's, on random states made with numpy from a seed — every leaf bit
for bit.  The JAX functions run ``vmap``ped over the lane axis the port
writes out."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine.matcher import StepOutput as JStepOutput
from kafkastreams_cep_tpu.ops import decode as jdecode
from kafkastreams_cep_tpu.ops import dewey_ops as jdewey
from kafkastreams_cep_tpu.ops import renorm as jrenorm
from kafkastreams_cep_tpu.ops import slab as jslab
from kafkastreams_cep_tpu_torch.convert import to_numpy, to_torch
from kafkastreams_cep_tpu_torch.engine.matcher import StepOutput
from kafkastreams_cep_tpu_torch.ops import decode, dewey_ops, renorm, walk_inputs
from kafkastreams_cep_tpu_torch.ops import slab as tslab

from test_slab_batched import seed_slab

E, MP, D, W = 16, 4, 6, 8
JAX_CLASSES = {"SlabState": jslab.SlabState, "PutOps": jslab.PutOps}


def random_versions(rng, n, depth=D):
    vlen = rng.integers(0, depth + 1, size=n).astype(np.int32)
    ver = rng.integers(0, 3, size=(n, depth)).astype(np.int32)
    ver[np.arange(depth)[None, :] >= vlen[:, None]] = 0
    return ver, vlen


def assert_slabs_equal(got, want, msg=""):
    for f, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{msg} {f}")


@pytest.mark.parametrize("seed", range(3))
def test_dewey_ops_equal_jax(seed):
    rng = np.random.default_rng(seed)
    q, ql = random_versions(rng, 400)
    p, pl = random_versions(rng, 400)
    p[:200], pl[:200] = q[:200], ql[:200]  # equal pairs, then bump some
    p[:100] = np.asarray(jax.vmap(jdewey.add_run)(p[:100], pl[:100]))
    np.testing.assert_array_equal(
        dewey_ops.add_run(ts.to_t(q), ts.to_t(ql)).numpy(),
        np.asarray(jax.vmap(jdewey.add_run)(q, ql)),
    )
    for a, b in zip(dewey_ops.add_stage(ts.to_t(q), ts.to_t(ql)),
                    jax.vmap(jdewey.add_stage)(q, ql)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = dewey_ops.is_compatible(ts.to_t(q), ts.to_t(ql), ts.to_t(p), ts.to_t(pl))
    want = jax.vmap(jdewey.is_compatible)(q, ql, p, pl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


def lanes(seed, K=6):
    rng = np.random.default_rng(seed)
    slab = jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]),
        *[seed_slab(rng) for _ in range(K)],
    )
    return rng, slab


@pytest.mark.parametrize("seed", range(3))
def test_single_op_puts_equal_jax(seed):
    rng, slab = lanes(seed)
    K = slab.stage.shape[0]
    ver, vlen = random_versions(rng, K)
    cur = rng.integers(0, 3, size=K).astype(np.int32)
    prev = rng.integers(0, 3, size=K).astype(np.int32)
    prev_off = rng.integers(0, 6, size=K).astype(np.int32)
    off = np.full(K, 9, np.int32)
    en = rng.random(K) < 0.8
    got = tslab.put_first(to_torch(slab), ts.to_t(cur), ts.to_t(off),
                          ts.to_t(ver), ts.to_t(vlen), ts.to_t(en))
    want = jax.vmap(jslab.put_first)(slab, cur, off, ver, vlen, en)
    assert_slabs_equal(got, want, "put_first")
    got = tslab.put(to_torch(slab), ts.to_t(cur), ts.to_t(off), ts.to_t(prev),
                    ts.to_t(prev_off), ts.to_t(ver), ts.to_t(vlen), ts.to_t(en))
    want = jax.vmap(jslab.put)(slab, cur, off, prev, prev_off, ver, vlen, en)
    assert_slabs_equal(got, want, "put")


@pytest.mark.parametrize("seed", range(3))
def test_single_walks_equal_jax(seed):
    rng, slab = lanes(seed)
    K = slab.stage.shape[0]
    live = np.asarray(slab.stage) >= 0
    pick = np.array([rng.choice(np.flatnonzero(live[k])) for k in range(K)])
    stage = np.asarray(slab.stage)[np.arange(K), pick]
    off = np.asarray(slab.off)[np.arange(K), pick]
    ver, vlen = random_versions(rng, K)
    ver[:, 0], vlen = 1, np.maximum(vlen, 2)
    en = rng.random(K) < 0.9
    args = [ts.to_t(x) for x in (stage, off, ver, vlen)]
    got = tslab.branch(to_torch(slab), *args, W, ts.to_t(en))
    want = jax.vmap(lambda s, st, of, v, vl, e: jslab.branch(
        s, st, of, v, vl, max_walk=W, enable=e))(slab, stage, off, ver, vlen, en)
    assert_slabs_equal(got, want, "branch")
    for remove in (False, True):
        got = tslab.peek(to_torch(slab), *args, W, remove, ts.to_t(en))
        want = jax.vmap(lambda s, st, of, v, vl, e: jslab.peek(
            s, st, of, v, vl, max_walk=W, remove=remove, enable=e,
        ))(slab, stage, off, ver, vlen, en)
        assert_slabs_equal(got[0], want[0], f"peek remove={remove}")
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", range(3))
def test_puts_batched_equals_jax(seed):
    E_, MP_, D_, _, R, H = 48, 8, 12, 12, 24, 3
    arrs = walk_inputs.random_inputs(100 + seed, 11, E_, MP_, D_, R, H)
    slab, _, puts, ev_off = walk_inputs.as_tensors(arrs, "cpu")
    got = tslab.puts_batched(slab, puts, ev_off)
    want = jax.vmap(jslab.puts_batched)(
        to_numpy(slab, JAX_CLASSES), to_numpy(puts, JAX_CLASSES), ev_off.numpy()
    )
    assert_slabs_equal(got, want, "puts_batched")
    assert int((got.full_drops - slab.full_drops).sum()) > 0


@pytest.mark.parametrize("seed", range(3))
def test_mark_sweep_equals_jax(seed):
    E_, MP_, D_, _, R, H = 48, 8, 12, 12, 24, 3
    arrs = walk_inputs.random_inputs(200 + seed, 7, E_, MP_, D_, R, H)
    slab, *_ = walk_inputs.as_tensors(arrs, "cpu")
    rng = np.random.default_rng(seed)
    run_off = rng.integers(-1, 12, size=(7, 10)).astype(np.int32)
    got = tslab.mark_sweep(slab, ts.to_t(run_off), 5)
    want = jax.vmap(lambda s, ro: jslab.mark_sweep(s, None, ro, 5))(
        to_numpy(slab, JAX_CLASSES), run_off
    )
    assert_slabs_equal(got, want, "mark_sweep")
    assert int((got.stage < 0).sum()) > int((slab.stage < 0).sum())


def engine_state(seed, K=3, T=12):
    """A JAX engine state after a straddle-heavy trace: runs whose versions
    grew one zero digit per ignored event, the shape renorm exists for."""
    from kafkastreams_cep_tpu.engine import EngineConfig, EventBatch
    from kafkastreams_cep_tpu.parallel import BatchMatcher

    jpat, _ = ts.both(ts.straddle)
    bm = BatchMatcher(jpat, K, EngineConfig(
        max_runs=16, slab_entries=48, slab_preds=8, dewey_depth=16, max_walk=12,
    ))
    base = np.asarray([0] + [6] * 6 + [1, 6, 6, 7, 6], np.int32)[:T]
    xs = np.stack([np.roll(base, k) for k in range(K)])
    xs[:, 0] = 0
    xs[:, seed % T] = 0
    ev = EventBatch(
        key=jnp.zeros((K, T), jnp.int32),
        value={"x": jnp.asarray(xs)},
        ts=jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (K, T)),
        off=jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (K, T)),
        valid=jnp.ones((K, T), bool),
    )
    state, _ = bm.scan(bm.init_state(), ev)
    return state


@pytest.mark.parametrize("seed", range(2))
def test_renorm_lane_equals_jax(seed):
    st = engine_state(seed)
    got = renorm.renorm_lane(
        *[to_torch(x) for x in (st.ver, st.vlen, st.alive, st.id_pos)],
        to_torch(st.slab),
    )
    want = jax.vmap(jrenorm.renorm_lane)(st.ver, st.vlen, st.alive, st.id_pos, st.slab)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert_slabs_equal(got[2], want[2], "renorm slab")
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[3].sum()) > 0  # some positions were deletable


@pytest.mark.parametrize("seed", range(3))
def test_safe_positions_random_equal_jax(seed):
    rng = np.random.default_rng(seed)
    K, R_, N = 5, 8, 20

    def vers(n):
        # Runs of zeros after a leading digit: many positions are deletable.
        vlen = rng.integers(1, D + 1, size=(K, n)).astype(np.int32)
        ver = np.where(rng.random((K, n, D)) < 0.8, 0, 1).astype(np.int32)
        ver[..., 0] = rng.integers(1, 3, size=(K, n))
        ver[np.arange(D) >= vlen[..., None]] = 0
        return ver, vlen

    rv, rl = vers(R_)
    pv, pl = vers(N)
    alive = rng.random((K, R_)) < 0.7
    seed_ = alive & (rng.random((K, R_)) < 0.2)
    live = rng.random((K, N)) < 0.8
    got = renorm.safe_positions(*[ts.to_t(x) for x in (rv, rl, alive, seed_, pv, pl, live)])
    want = jax.vmap(jrenorm.safe_positions)(rv, rl, alive, seed_, pv, pl, live)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_v = renorm.delete_positions(ts.to_t(pv), ts.to_t(pl), got)
    want_v = jax.vmap(jrenorm.delete_positions)(pv, pl, want)
    for a, b in zip(got_v, want_v):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("budget", [4, 64])
def test_compact_matches_equals_jax(budget):
    rng = np.random.default_rng(budget)
    K, T, R, W_ = 3, 5, 4, 6
    count = np.where(rng.random((K, T, R)) < 0.3, rng.integers(1, W_, (K, T, R)), 0)
    stage = rng.integers(-1, 4, size=(K, T, R, W_)).astype(np.int32)
    off = rng.integers(-1, 9, size=(K, T, R, W_)).astype(np.int32)
    out = (stage, off, count.astype(np.int32))
    got = decode.compact_matches(StepOutput(*[ts.to_t(x) for x in out]), budget)
    want = jdecode.compact_matches(JStepOutput(*[jnp.asarray(x) for x in out]), budget)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
