"""The port's walk pass (the plain version of the CUDA walk-pass kernel)
against the JAX package's walk pass and its Pallas kernel.

* against ``jax.vmap(walks_compacted)`` (after ``jax.vmap(puts_batched)``
  when puts are on): every slab leaf, counter and output bit for bit, on
  several seeds of the synthetic inputs and of ``tests/test_walk_kernel.py``'s
  walker sets;
* against ``walk_pass_kernel(..., interpret=True)`` at K=128: the Pallas
  kernel prunes pointers by shifting in place where the jnp pass compacts at
  the walker's end, so the two differ only in storage behind ``npreds``;
  the comparison masks that dead storage (``test_slab_batched.canon_slab``).

Both comparisons run in each of the kernel's modes too: the two-tier slab
(``hot_entries``, on inputs whose hot tier is full so that puts demote),
stage attribution (``stage_hops [K, S]``), the lazy drain (``drain=True``,
the handle ring as the walker queue) and all three together.

The CUDA kernel itself runs only on a GPU: the ``cuda``-marked tests hold
it against the plain version there (the misaligned config too, and a slab
too wide for eight lanes a block) and skip on a machine without one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenarios as ts
from kafkastreams_cep_tpu.ops import slab as jslab
from kafkastreams_cep_tpu.ops.walk_kernel import walk_pass_kernel as pallas_walk_pass
from kafkastreams_cep_tpu_torch.convert import to_numpy, to_torch
from kafkastreams_cep_tpu_torch.ops import walk_inputs, walk_kernel

from test_slab_batched import assert_slab_equal, seed_slab
from test_walk_kernel import OUT_BASE, OUT_ROWS, W, random_walkers

CONFIGS = {
    "test_walk_kernel": (16, 4, 6, 8, 4, 2),  # E, MP, D, W, R, H
    "headline": (48, 8, 12, 12, 24, 3),
    # Rows of E*4, E*MP*4 and E*MP*D*4 bytes, none a multiple of 16: the
    # kernel's block copies take their scalar heads and tails.
    "misaligned": (25, 3, 5, 6, 4, 2),
}
#: The GPU tests' configs besides: lanes whose arena is too large for eight
#: a block, so that the kernel's blocks serve 5-7.
CUDA_CONFIGS = dict(CONFIGS, wide=(1536, 8, 12, 12, 24, 3))
JAX_CLASSES = {"SlabState": jslab.SlabState, "PutOps": jslab.PutOps}


def jax_walk_pass(slab, walkers, puts, ev_off, W, out_base, out_rows,
                  hot_entries=0, drain=False):
    """``jax.vmap`` of the JAX package's puts then walks (budget 1)."""
    s = to_numpy(slab, JAX_CLASSES)
    if puts is not None:
        s = jax.vmap(functools.partial(jslab.puts_batched, hot_entries=hot_entries))(
            s, to_numpy(puts, JAX_CLASSES), ev_off.numpy())
    walks = jax.vmap(functools.partial(
        jslab.walks_compacted, max_walk=W, budget=1, out_base=out_base,
        out_rows=out_rows, hot_entries=hot_entries, drain=drain,
    ))
    return walks(s, *[w.numpy() for w in walkers])


MODES = ("two_tier", "attribution", "drain", "all")


def mode_inputs(seed, config, mode, K, device="cpu"):
    """One mode's slab-phase inputs and arguments: ``(slab, walkers, kw)``
    where ``kw`` holds ``max_walk, out_base, out_rows, put_ops, ev_off,
    hot_entries, drain``.  A drain's queue is the handle ring: every walker
    removes and emits, and all rows are output rows."""
    E, MP, D, W_, R, H = CUDA_CONFIGS[config]
    EH = (16 if E == 48 else 8) if mode in ("two_tier", "all") else 0
    S = walk_inputs.NUM_STAGES if mode in ("attribution", "all") else 0
    drain = mode in ("drain", "all")
    arrs = walk_inputs.random_inputs(seed, K, E, MP, D, R, H, hot_entries=EH)
    slab, walkers, puts, ev_off = walk_inputs.as_tensors(arrs, device, stage_hops=S)
    PW = walkers[0].shape[1]
    kw = dict(max_walk=W_, out_base=PW - R, out_rows=R, put_ops=puts,
              ev_off=ev_off, hot_entries=EH, drain=drain)
    if drain:
        ones = torch.ones_like(walkers[0])
        walkers = (*walkers[:5], ones, ones)
        kw.update(out_base=0, out_rows=PW)
        if mode == "drain":
            kw.update(put_ops=None, ev_off=None)
    return slab, walkers, kw


def assert_pass_equal(got, want, msg):
    (slab_t, *out_t), (slab_j, *out_j) = got, want
    for f, a, b in zip(slab_t._fields, slab_t, slab_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{msg} {f}")
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=msg)


@pytest.mark.parametrize("with_puts", [False, True])
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", range(3))
def test_plain_pass_equals_jax_pass(seed, config, with_puts):
    E, MP, D, W_, R, H = CONFIGS[config]
    K = 9
    arrs = walk_inputs.random_inputs(seed, K, E, MP, D, R, H)
    slab, walkers, puts, ev_off = walk_inputs.as_tensors(arrs, "cpu")
    if not with_puts:
        puts = None
    PW = walkers[0].shape[1]
    got = walk_kernel.walk_pass(
        slab, *walkers, W_, PW - R, R, put_ops=puts, ev_off=ev_off
    )
    want = jax_walk_pass(slab, walkers, puts, ev_off, W_, PW - R, R)
    assert_pass_equal(got, want, f"seed={seed} {config} puts={with_puts}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", range(2))
def test_plain_pass_modes_equal_jax(seed, config, mode):
    slab, walkers, kw = mode_inputs(seed, config, mode, 9)
    got = walk_kernel.walk_pass(slab, *walkers, **kw)
    want = jax_walk_pass(slab, walkers, kw["put_ops"], kw["ev_off"],
                         kw["max_walk"], kw["out_base"], kw["out_rows"],
                         kw["hot_entries"], kw["drain"])
    assert_pass_equal(got, want, f"seed={seed} {config} {mode}")
    new = got[0]
    if kw["hot_entries"] and kw["put_ops"] is not None:
        assert int((new.demotions - slab.demotions).sum()) > 0
    if kw["drain"]:
        assert int(new.drain_hops.sum()) > int(slab.drain_hops.sum())
        assert torch.equal(new.extract_hops, slab.extract_hops)
    if new.stage_hops.shape[1]:
        hops = sum(int((getattr(new, c) - getattr(slab, c)).sum())
                   for c in ("walk_hops", "extract_hops", "drain_hops"))
        assert int(new.stage_hops.sum()) <= hops  # out-of-range stages drop


@pytest.mark.parametrize("mode", MODES)
def test_plain_pass_modes_match_pallas_interpret(mode):
    """One K=128 case per mode through the interpret-mode Pallas kernel."""
    slab, walkers, kw = mode_inputs(5, "test_walk_kernel", mode, 128)
    t_slab, *t_out = walk_kernel.walk_pass(slab, *walkers, **kw)
    puts = kw["put_ops"]
    j_slab, *j_out = pallas_walk_pass(
        to_numpy(slab, JAX_CLASSES), *[jnp.asarray(w.numpy()) for w in walkers],
        max_walk=kw["max_walk"], out_base=kw["out_base"],
        out_rows=kw["out_rows"], interpret=True,
        put_ops=None if puts is None else to_numpy(puts, JAX_CLASSES),
        ev_off=None if puts is None else jnp.asarray(kw["ev_off"].numpy()),
        hot_entries=kw["hot_entries"], drain=kw["drain"],
    )
    for k in range(128):
        lane_t = jax.tree_util.tree_map(lambda x: x[k].numpy(), tuple(t_slab))
        lane_j = jax.tree_util.tree_map(lambda x: np.asarray(x[k]), tuple(j_slab))
        assert_slab_equal(jslab.SlabState(*lane_j), jslab.SlabState(*lane_t),
                          f"{mode} lane {k}")
    for a, b in zip(t_out, j_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for c in ("walk_hops", "extract_hops", "drain_hops", "hot_hits",
              "hot_misses", "overflow_walks", "demotions", "stage_hops"):
        np.testing.assert_array_equal(
            getattr(t_slab, c).numpy(), np.asarray(getattr(j_slab, c)),
            err_msg=f"{mode} {c}")


def seeded_lanes(seed, K):
    """``tests/test_walk_kernel.py``'s per-lane slabs and walker sets."""
    rng = np.random.default_rng(400 + seed)
    slabs = [seed_slab(rng) for _ in range(K)]
    wks = [random_walkers(rng) for _ in range(K)]
    slab = jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *slabs)
    fields = ("en", "stage", "off", "ver", "vlen", "is_remove", "want_out")
    return slab, [np.stack([w[f] for w in wks]) for f in fields]


@pytest.mark.parametrize("seed", range(4))
def test_plain_pass_equals_jax_on_walk_kernel_sets(seed):
    slab, walkers = seeded_lanes(seed, 8)
    got = walk_kernel.walk_pass(
        to_torch(slab), *[ts.to_t(w) for w in walkers], W, OUT_BASE, OUT_ROWS
    )
    want = jax.vmap(functools.partial(
        jslab.walks_compacted, max_walk=W, budget=1, out_base=OUT_BASE,
        out_rows=OUT_ROWS,
    ))(slab, *walkers)
    assert_pass_equal(got, want, f"seed={seed}")


def test_plain_pass_matches_pallas_interpret():
    """K=128 lanes (the Pallas lane block) through the interpret-mode
    Pallas kernel, puts included, against the port's plain pass."""
    E, MP, D, W_, R, H = CONFIGS["test_walk_kernel"]
    K = 128
    arrs = walk_inputs.random_inputs(3, K, E, MP, D, R, H)
    slab, walkers, puts, ev_off = walk_inputs.as_tensors(arrs, "cpu")
    PW = walkers[0].shape[1]
    got = walk_kernel.walk_pass(
        slab, *walkers, W_, PW - R, R, put_ops=puts, ev_off=ev_off
    )
    j_slab, j_st, j_of, j_ct = pallas_walk_pass(
        to_numpy(slab, JAX_CLASSES), *[jnp.asarray(w.numpy()) for w in walkers],
        max_walk=W_, out_base=PW - R, out_rows=R, interpret=True,
        put_ops=to_numpy(puts, JAX_CLASSES), ev_off=jnp.asarray(ev_off.numpy()),
    )
    t_slab, t_st, t_of, t_ct = got
    for k in range(K):
        lane_t = jax.tree_util.tree_map(lambda x: x[k].numpy(), tuple(t_slab))
        lane_j = jax.tree_util.tree_map(lambda x: np.asarray(x[k]), tuple(j_slab))
        assert_slab_equal(
            jslab.SlabState(*lane_j), jslab.SlabState(*lane_t), f"lane {k}"
        )
    for a, b in ((t_st, j_st), (t_of, j_of), (t_ct, j_ct)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for c in ("walk_hops", "extract_hops", "trunc", "missing", "full_drops",
              "pred_drops"):
        np.testing.assert_array_equal(
            getattr(t_slab, c).numpy(), np.asarray(getattr(j_slab, c)), err_msg=c
        )


def test_cpu_tensors_take_the_plain_pass():
    E, MP, D, W_, R, H = CONFIGS["test_walk_kernel"]
    arrs = walk_inputs.random_inputs(0, 2, E, MP, D, R, H)
    slab, walkers, puts, ev_off = walk_inputs.as_tensors(arrs, "cpu")
    before = walk_kernel.walk_pass_kernel.launches
    walk_kernel.walk_pass(slab, *walkers, W_, walkers[0].shape[1] - R, R,
                          put_ops=puts, ev_off=ev_off)
    assert walk_kernel.walk_pass_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        walk_kernel.walk_pass_kernel(slab, *walkers, W_, walkers[0].shape[1] - R, R)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 37, 300])
def test_cuda_kernel_equals_plain(K):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the walk-pass kernel has no CPU build")
    E, MP, D, W_, R, H = CONFIGS["headline"]
    arrs = walk_inputs.random_inputs(K, K, E, MP, D, R, H)
    slab, walkers, puts, ev_off = walk_inputs.as_tensors(arrs, "cuda")
    PW = walkers[0].shape[1]
    before = walk_kernel.walk_pass_kernel.launches
    got = walk_kernel.walk_pass(slab, *walkers, W_, PW - R, R, put_ops=puts, ev_off=ev_off)
    want = walk_kernel.walk_pass_plain(slab, *walkers, W_, PW - R, R, put_ops=puts, ev_off=ev_off)
    assert walk_kernel.walk_pass_kernel.launches == before + 1
    for a, b in zip(list(got[0]) + list(got[1:]), list(want[0]) + list(want[1:])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("K", [1, 37, 300])
def test_cuda_kernel_modes_equal_plain(K, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the walk-pass kernel has no CPU build")
    slab, walkers, kw = mode_inputs(K, "headline", mode, K, device="cuda")
    kern = walk_kernel.walk_pass_kernel
    name = walk_kernel.mode_name(kw["hot_entries"], slab.stage_hops.shape[1],
                                 kw["drain"])
    before = kern.launches_by_mode.get(name, 0)
    got = walk_kernel.walk_pass(slab, *walkers, **kw)
    want = walk_kernel.walk_pass_plain(slab, *walkers, **kw)
    assert kern.launches_by_mode[name] == before + 1
    for a, b in zip(list(got[0]) + list(got[1:]), list(want[0]) + list(want[1:])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["misaligned", "wide"])
@pytest.mark.parametrize("mode", ("default",) + MODES)
def test_cuda_kernel_misaligned_equals_plain(mode, config):
    """K=37 lanes (the last block holds fewer than the others) of the
    misaligned config, and of the wide one, whose blocks serve fewer than
    eight lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the walk-pass kernel has no CPU build")
    if mode == "default":
        E, MP, D, W_, R, H = CUDA_CONFIGS[config]
        arrs = walk_inputs.random_inputs(37, 37, E, MP, D, R, H)
        slab, walkers, puts, ev_off = walk_inputs.as_tensors(arrs, "cuda")
        PW = walkers[0].shape[1]
        kw = dict(max_walk=W_, out_base=PW - R, out_rows=R, put_ops=puts, ev_off=ev_off)
    else:
        slab, walkers, kw = mode_inputs(37, config, mode, 37, device="cuda")
    if config == "wide":
        PP = kw["put_ops"].en.shape[1] if kw.get("put_ops") is not None else 0
        assert walk_kernel.WalkPassKernel.arena(slab, PP, kw.get("hot_entries", 0))[0] < 8
    got = walk_kernel.walk_pass_kernel(slab, *walkers, **kw)
    want = walk_kernel.walk_pass_plain(slab, *walkers, **kw)
    for a, b in zip(list(got[0]) + list(got[1:]), list(want[0]) + list(want[1:])):
        assert torch.equal(a, b)
