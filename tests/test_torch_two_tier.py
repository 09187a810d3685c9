"""The port's two-tier slab (``EngineConfig.slab_hot_entries``) against the
JAX package's, bit for bit.

The cases of ``tests/test_two_tier.py``: new entries land hot, a demotion
moves the least-recent hot entry with its refs and pointers, an allocation
drops only when the whole slab is full, and a walk resolves a demoted tail
in the overflow tier.  Then random op sequences (``put_first``, ``put``,
``branch``, ``peek`` over several lanes), the step's puts op by op
(``_puts_sequential``) plus ``walks_compacted(hot_entries)`` under
pressure, and the engine step by step at E=16, E_hot=8 — every slab leaf
and counter equal to the JAX package's on the same numpy-seeded inputs.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.engine import TPUMatcher as JMatcher
from kafkastreams_cep_tpu.ops import slab as jslab
from kafkastreams_cep_tpu_torch import EngineConfig, TPUMatcher
from kafkastreams_cep_tpu_torch.convert import to_numpy
from kafkastreams_cep_tpu_torch.ops import slab as tslab
from kafkastreams_cep_tpu_torch.ops import walk_inputs

from test_torch_engine import step_both
from test_two_tier import EH, MP, D, E, W, put_chain, ver

JAX_CLASSES = {"SlabState": jslab.SlabState, "PutOps": jslab.PutOps}


def i32(*xs):
    return torch.tensor(xs, dtype=torch.int32)


def tver(*comps):
    """One lane's Dewey version as ``[1, D]`` / ``[1]`` tensors."""
    v, l = ver(*comps)
    return ts.to_t(v)[None], ts.to_t(l).reshape(1)


ON = torch.tensor([True])


def tput_chain(slab, n, hot_entries, start_off=0):
    """``test_two_tier.put_chain`` on the port's one-lane slab."""
    v1, l1 = tver(1)
    slab = tslab.put_first(slab, i32(0), i32(start_off), v1, l1, ON,
                           hot_entries=hot_entries)
    v10, l10 = tver(1, 0)
    for i in range(1, n):
        slab = tslab.put(
            slab, i32(i % 3), i32(start_off + i), i32((i - 1) % 3),
            i32(start_off + i - 1), v10, l10, ON, hot_entries=hot_entries,
        )
    return slab


def assert_lane_equal(jax_slab, torch_slab, msg=""):
    """A one-lane JAX slab equals lane 0 of the port's, leaf by leaf."""
    for f in jax_slab._fields:
        np.testing.assert_array_equal(
            getattr(torch_slab, f)[0].numpy(), np.asarray(getattr(jax_slab, f)),
            err_msg=f"{msg} {f}",
        )


def both_chains(n, small_e=E):
    j = put_chain(jslab.make(small_e, MP, D), n, hot_entries=EH)
    t = tput_chain(tslab.make(1, small_e, MP, D), n, hot_entries=EH)
    assert_lane_equal(j, t, f"chain of {n}")
    return j, t


def test_new_entries_land_hot_until_full():
    _, t = both_chains(EH)
    assert np.flatnonzero(t.stage[0].numpy() >= 0).tolist() == list(range(EH))
    assert int(t.demotions[0]) == 0


def test_demotion_moves_least_recent_hot_entry():
    j, t = both_chains(EH)
    v10, l10 = ver(1, 0)
    j = jslab.put(j, 2, EH, (EH - 1) % 3, EH - 1, v10, l10, hot_entries=EH)
    tv, tl = tver(1, 0)
    t = tslab.put(t, i32(2), i32(EH), i32((EH - 1) % 3), i32(EH - 1), tv, tl,
                  ON, hot_entries=EH)
    assert_lane_equal(j, t, "after demotion")
    assert int(t.demotions[0]) == 1
    stage, off = t.stage[0].numpy(), t.off[0].numpy()
    ovf = {(int(s), int(o)) for s, o in zip(stage[EH:], off[EH:]) if s >= 0}
    assert ovf == {(0, 0)}  # the least-recent entry, now in the overflow tier


def test_demoted_entry_keeps_refs_and_pointers():
    j, t = both_chains(EH)
    v1, l1 = ver(1)
    j = jslab.branch(j, 0, 0, v1, l1, max_walk=1, hot_entries=EH)
    tv1, tl1 = tver(1)
    t = tslab.branch(t, i32(0), i32(0), tv1, tl1, 1, ON, hot_entries=EH)
    refs0, pver0 = int(t.refs[0, 0]), t.pver[0, 0].clone()
    v10, l10 = ver(1, 0)
    j = jslab.put(j, 2, EH, (EH - 1) % 3, EH - 1, v10, l10, hot_entries=EH)
    tv, tl = tver(1, 0)
    t = tslab.put(t, i32(2), i32(EH), i32((EH - 1) % 3), i32(EH - 1), tv, tl,
                  ON, hot_entries=EH)
    assert_lane_equal(j, t, "after demotion")
    e = int(np.flatnonzero((t.stage[0].numpy() == 0) & (t.off[0].numpy() == 0))[0])
    assert e >= EH and int(t.refs[0, e]) == refs0
    assert torch.equal(t.pver[0, e], pver0)


def test_full_drop_only_when_whole_slab_full():
    small_e = 12  # hot 8 + overflow 4
    j, t = both_chains(small_e, small_e)
    assert int(t.full_drops[0]) == 0 and int(t.demotions[0]) == small_e - EH
    v10, l10 = ver(1, 0)
    j = jslab.put(j, 2, small_e, (small_e - 1) % 3, small_e - 1, v10, l10,
                  hot_entries=EH)
    tv, tl = tver(1, 0)
    t = tslab.put(t, i32(2), i32(small_e), i32((small_e - 1) % 3),
                  i32(small_e - 1), tv, tl, ON, hot_entries=EH)
    assert_lane_equal(j, t, "full")
    assert int(t.full_drops[0]) == 1


def test_hot_miss_overflow_hit_walk_path():
    n = EH + 4  # the 4 oldest entries are demoted
    j, t = both_chains(n)
    v10, l10 = ver(1, 0)
    j, jst, jof, jn = jslab.peek(j, (n - 1) % 3, n - 1, v10, l10,
                                 max_walk=2 * W, remove=False, hot_entries=EH)
    tv, tl = tver(1, 0)
    t, tst, tof, tn = tslab.peek(t, i32((n - 1) % 3), i32(n - 1), tv, tl,
                                 2 * W, False, ON, hot_entries=EH)
    assert_lane_equal(j, t, "after the walk")
    np.testing.assert_array_equal(tst[0].numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tof[0].numpy(), np.asarray(jof))
    assert int(tn[0]) == int(jn)
    assert int(t.overflow_walks[0]) > 0
    assert int(t.hot_hits[0]) + int(t.hot_misses[0]) == int(tn[0])


def test_random_op_sequences_equal_jax():
    """Random put_first/put/branch/peek sequences over 5 lanes, each lane
    with its own arguments and enable bit: the port's batched ops against
    ``jax.vmap`` of the JAX package's, state compared after every op."""
    K, rng = 5, np.random.default_rng(77)
    j = jax.vmap(lambda _: jslab.make(E, MP, D))(np.arange(K))
    t = tslab.make(K, E, MP, D)
    off = 0
    vm = {
        "put_first": jax.vmap(functools.partial(jslab.put_first, hot_entries=EH)),
        "put": jax.vmap(functools.partial(jslab.put, hot_entries=EH)),
        "branch": jax.vmap(functools.partial(jslab.branch, max_walk=W, hot_entries=EH)),
        "peek": jax.vmap(functools.partial(jslab.peek, max_walk=W, remove=True,
                                           hot_entries=EH)),
    }
    for step in range(60):
        op = ("put_first", "put", "branch", "peek")[int(rng.integers(0, 4))] if off else "put_first"
        stage = rng.integers(0, 3, size=K).astype(np.int32)
        comps = rng.integers(1, 3, size=(K, 2))
        vv = np.stack([np.asarray(ver(*map(int, c))[0]) for c in comps])
        vl = np.stack([np.asarray(ver(*map(int, c))[1]) for c in comps])
        en = rng.random(K) < 0.8
        if op == "put_first":
            offs = np.full(K, off, np.int32)
            j = vm[op](j, stage, offs, vv, vl, en)
            t = tslab.put_first(t, *map(ts.to_t, (stage, offs, vv, vl, en)),
                                hot_entries=EH)
            off += 1
        elif op == "put":
            prev = rng.integers(0, off, size=K).astype(np.int32)
            offs = np.full(K, off, np.int32)
            args = (stage, offs, prev % 3, prev, vv, vl, en)
            j = vm[op](j, *args)
            t = tslab.put(t, *map(ts.to_t, args), hot_entries=EH)
            off += 1
        else:
            tgt = rng.integers(0, off, size=K).astype(np.int32)
            args = (tgt % 3, tgt, vv, vl)
            if op == "branch":
                j = vm[op](j, *args, enable=en)
                t = tslab.branch(t, *map(ts.to_t, args), W, ts.to_t(en),
                                 hot_entries=EH)
            else:
                j, *jout = vm[op](j, *args, enable=en)
                t, *tout = tslab.peek(t, *map(ts.to_t, args), W, True,
                                      ts.to_t(en), hot_entries=EH)
                for a, b in zip(tout, jout):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for f in t._fields:
            np.testing.assert_array_equal(
                getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                err_msg=f"step {step} {op} {f}",
            )
    assert int(t.demotions.sum()) > 0 and int(t.overflow_walks.sum()) > 0


@pytest.mark.parametrize("seed", range(3))
def test_sequential_puts_and_walks_under_pressure_equal_jax(seed):
    """The step's puts op by op (``_puts_sequential``), then
    ``walks_compacted(hot_entries)``, on synthetic lanes whose hot tier is
    full: every leaf equal to ``jax.vmap`` of the JAX package's."""
    E_, MP_, D_, W_, R, H = 16, 4, 6, 8, 4, 2
    K = 12
    arrs = walk_inputs.random_inputs(seed, K, E_, MP_, D_, R, H, hot_entries=8)
    slab, walkers, puts, ev_off = walk_inputs.as_tensors(arrs, "cpu")
    PW = walkers[0].shape[1]
    got = tslab.puts_batched(slab, puts, ev_off, hot_entries=8)
    want = jax.vmap(functools.partial(jslab.puts_batched, hot_entries=8))(
        to_numpy(slab, JAX_CLASSES), to_numpy(puts, JAX_CLASSES), ev_off.numpy()
    )
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert int((got.demotions - slab.demotions).sum()) > 0
    t_out = tslab.walks_compacted(got, *walkers, W_, PW - R, R, hot_entries=8)
    j_out = jax.vmap(functools.partial(
        jslab.walks_compacted, max_walk=W_, budget=1, out_base=PW - R,
        out_rows=R, hot_entries=8,
    ))(want, *[w.numpy() for w in walkers])
    for f in t_out[0]._fields:
        np.testing.assert_array_equal(getattr(t_out[0], f).numpy(),
                                      np.asarray(getattr(j_out[0], f)), err_msg=f)
    for a, b in zip(t_out[1:], j_out[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(t_out[0].overflow_walks.sum()) > 0


PRESSURE = dict(max_runs=8, slab_entries=16, slab_hot_entries=8, slab_preds=4,
                dewey_depth=8, max_walk=8)


def test_engine_per_step_state_equals_jax():
    """The stock query at E=16, E_hot=8 (``test_two_tier.PRESSURE_CFG``):
    every state leaf after every step equals the JAX engine's, and the run
    demotes, walks the overflow tier and drops."""
    tb, state = step_both("stock", K=4, T=40, seed=21, **PRESSURE)
    hot = tb.hot_counters(state)
    assert hot["slab_demotions"] > 0 and hot["slab_overflow_walks"] > 0
    assert tb.counters(state)["slab_full_drops"] > 0


@pytest.mark.parametrize("bad", [4, 7, 16, 24])
def test_invalid_hot_entries_rejected(bad):
    conf = dict(PRESSURE, slab_hot_entries=bad)
    with pytest.raises(ValueError, match="slab_hot_entries"):
        JMatcher(ts.stock(ts.JQuery), JConfig(**conf))
    with pytest.raises(ValueError, match="slab_hot_entries"):
        TPUMatcher(ts.stock(ts.TQuery), EngineConfig(**conf), device="cpu")
