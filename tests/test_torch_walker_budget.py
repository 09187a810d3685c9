"""``EngineConfig.walker_budget > 1``: the port's lockstep walk pass against
the JAX package's, after ``tests/test_slab_batched.py``.

* ``walks_batched`` (every walker of a lane in one lockstep pass) and
  ``walks_compacted(budget=2, 4)`` (queue-order batches of that many) equal
  ``jax.vmap`` of the JAX functions on random slabs, every leaf and
  counter, in the walk-pass kernel's modes;
* the collision case of ``tests/test_slab_batched.py:298-337``: two remove
  walkers meeting at one entry count ``collisions`` at budget 2 and none
  at budget 1, in both packages;
* the engine at budget 4 equals the JAX engine at budget 4 step by step,
  eager, lazy with a drain, and on the two-tier slab; the budget reaches
  ``StackedBankMatcher`` too.

On a CUDA tensor the walk-pass kernel serves every walker alone whatever
the budget (the JAX package's Pallas kernel does the same), so these hold
the plain pass on the CPU; ``chip_smoke.py`` holds budget 4 on the card
against budget 1.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import torch_scenarios as ts
from kafkastreams_cep_tpu.ops import slab as jslab
from kafkastreams_cep_tpu_torch import EngineConfig
from kafkastreams_cep_tpu_torch.convert import to_numpy, to_torch
from kafkastreams_cep_tpu_torch.ops import slab as tslab
from kafkastreams_cep_tpu_torch.ops import walk_kernel

from test_slab_batched import mkver, seed_slab
from test_torch_engine import run_both
from test_torch_walk_kernel import JAX_CLASSES, assert_pass_equal, mode_inputs


def jax_pass(slab, walkers, kw, budget):
    """``jax.vmap`` of the JAX package's puts then ``walks_compacted`` at
    ``budget``."""
    s = to_numpy(slab, JAX_CLASSES)
    EH = kw["hot_entries"]
    if kw["put_ops"] is not None:
        s = jax.vmap(functools.partial(jslab.puts_batched, hot_entries=EH))(
            s, to_numpy(kw["put_ops"], JAX_CLASSES), kw["ev_off"].numpy())
    walks = jax.vmap(functools.partial(
        jslab.walks_compacted, max_walk=kw["max_walk"], budget=budget,
        out_base=kw["out_base"], out_rows=kw["out_rows"], hot_entries=EH,
        drain=kw["drain"],
    ))
    return walks(s, *[w.numpy() for w in walkers])


@pytest.mark.parametrize("budget,config,mode", [
    (2, "test_walk_kernel", "default"), (4, "test_walk_kernel", "default"),
    (2, "headline", "default"), (4, "headline", "all"),
    (3, "misaligned", "two_tier"), (2, "test_walk_kernel", "drain"),
    (4, "headline", "attribution"),
])
def test_lockstep_pass_equals_jax(budget, config, mode):
    slab, walkers, kw = mode_inputs(budget, config, mode, 9)
    if mode == "default":
        kw.update(hot_entries=0, drain=False)
    got = walk_kernel.walk_pass(slab, *walkers, budget=budget, **kw)
    want = jax_pass(slab, walkers, kw, budget)
    assert_pass_equal(got, want, f"budget={budget} {config} {mode}")


@pytest.mark.parametrize("seed", range(3))
def test_walks_batched_equals_jax(seed):
    """Every walker of a lane in one lockstep pass, branch and remove
    walkers mixed, against ``jax.vmap(walks_batched)``."""
    slab, walkers, kw = mode_inputs(seed, "test_walk_kernel", "all", 7)
    slab = walk_kernel.walk_pass_plain(slab, *[w[:, :0] for w in walkers],
                                       kw["max_walk"], 0, 0, put_ops=kw["put_ops"],
                                       ev_off=kw["ev_off"], hot_entries=8)[0]
    en, stage, off, ver, vlen, rm, out = walkers
    got = tslab.walks_batched(slab, en, stage, off, ver, vlen, rm, out,
                              kw["max_walk"], hot_entries=8, drain=True)
    want = jax.vmap(functools.partial(
        jslab.walks_batched, max_walk=kw["max_walk"], hot_entries=8, drain=True,
    ))(to_numpy(slab, JAX_CLASSES), *[w.numpy() for w in walkers])
    assert_pass_equal(got, want, f"seed={seed}")


def collision_lanes(K=3):
    """``tests/test_slab_batched.py:298-337``'s slab on ``K`` lanes: two
    remove walkers of one chain, the second lineage branched onto it."""
    rng = np.random.default_rng(7)
    v11, l11 = mkver(1, 1)

    def lane():
        slab = seed_slab(rng)
        return jslab.branch(slab, 2, 3, v11, l11, 8)

    slab = jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                                  *[lane() for _ in range(K)])
    walkers = (
        np.ones((K, 2), bool), np.full((K, 2), 2, np.int32), np.full((K, 2), 3, np.int32),
        np.broadcast_to(np.asarray(v11), (K, 2, v11.shape[0])).copy(),
        np.full((K, 2), int(l11), np.int32), np.ones((K, 2), bool), np.ones((K, 2), bool),
    )
    return slab, walkers


@pytest.mark.parametrize("budget", [1, 2])
def test_collisions_counted_in_lockstep_only(budget):
    slab, walkers = collision_lanes()
    got = tslab.walks_compacted(to_torch(slab), *[ts.to_t(w) for w in walkers], 8,
                                0, 2, budget=budget)
    want = jax.vmap(functools.partial(
        jslab.walks_compacted, max_walk=8, budget=budget, out_base=0, out_rows=2,
    ))(slab, *walkers)
    assert_pass_equal(got, want, f"budget={budget}")
    if budget == 1:
        assert int(got[0].collisions.sum()) == 0
    else:
        assert (got[0].collisions > 0).all()
        lock = tslab.walks_batched(to_torch(slab), *[ts.to_t(w) for w in walkers], 8)
        assert torch.equal(lock[0].collisions, got[0].collisions)


@pytest.mark.parametrize("name,cfg", [
    ("skip_any", {}),
    ("stock", dict(lazy_extraction=True, handle_ring=32, slab_entries=64)),
    ("kleene", dict(slab_hot_entries=8, stage_attribution=True)),
])
def test_engine_at_budget_4_equals_jax(name, cfg):
    """Eager, lazy (then one drain) and two-tier with attribution, at
    budget 4, state and outputs compared after every step."""
    tb, tst, jb, js = run_both(name, K=4, T=16, seed=5, walker_budget=4, **cfg)
    if cfg.get("lazy_extraction"):
        assert int(tst.hr_count.sum()) > 0
        j_state, j_out = jb.drain(js)
        t_state, t_out = tb.drain(tst)
        ts.assert_states_equal(j_state, t_state, "after drain")
        for f in j_out._fields:
            np.testing.assert_array_equal(getattr(t_out, f).numpy(),
                                          np.asarray(getattr(j_out, f)), err_msg=f)
    assert tb.walk_counters(tst)["walk_hops"] > 0


def test_stacked_bank_takes_the_budget():
    """A stacked bank's step goes through the same lockstep pass: at budget
    2 each query's block of lanes equals its own matcher at budget 2."""
    from kafkastreams_cep_tpu_torch import BatchMatcher
    from kafkastreams_cep_tpu_torch.parallel.stacked import StackedBankMatcher

    conf = EngineConfig(max_runs=12, slab_entries=32, slab_preds=6, dewey_depth=10,
                        max_walk=10, walker_budget=2)
    pat = ts.skip_till_any(ts.TQuery)
    K, T = 4, 32
    ev = ts.events("letters", np.random.default_rng(4), K, T)
    bank = StackedBankMatcher([pat, pat], K, conf, device="cpu")
    st, out = bank.scan(bank.init_state(), ev)
    one = BatchMatcher(pat, K, conf, device="cpu")
    s1, o1 = one.scan(one.init_state(), ev)
    assert int(o1.count.sum()) > 0
    for q in range(2):
        for a, b in zip(out, o1):
            assert torch.equal(a[q], b), q
        part = type(st)(*[x[q * K:(q + 1) * K] if torch.is_tensor(x) else
                          type(x)(*[y[q * K:(q + 1) * K] for y in x]) for x in st])
        ts.assert_states_equal(s1, part, f"query {q}")
