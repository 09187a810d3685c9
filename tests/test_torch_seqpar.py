"""The port's time-sharded stencil (``parallel/seqpar.py``) against the JAX
package's (``tests/test_seqpar.py``) on the suite's eight virtual devices,
and against the port's single-device ``StencilMatcher``: the same hits
element for element and the same offsets wherever a match completed,
matches straddling every chunk boundary included."""

import jax
import numpy as np
import pytest
import torch

import torch_scenarios as ts
from kafkastreams_cep_tpu.parallel import TimeShardedStencil as JTimeSharded
from kafkastreams_cep_tpu.parallel import key_mesh as j_key_mesh
from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch
from kafkastreams_cep_tpu_torch.engine.stencil import StencilMatcher
from kafkastreams_cep_tpu_torch.parallel import TimeShardedStencil, key_mesh

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs the 8-device virtual mesh")


def full_batch(codes):
    K, T = codes.shape
    i32 = torch.int32
    return EventBatch(
        key=torch.zeros((K, T), dtype=i32),
        value=torch.as_tensor(codes.astype(np.int32)),
        ts=torch.arange(T, dtype=i32)[None, :].expand(K, T),
        off=torch.arange(T, dtype=i32)[None, :].expand(K, T),
        valid=torch.ones((K, T), dtype=torch.bool),
    )


def straddling_codes(seed=31, K=4, T=256, chunk=32):
    rng = np.random.default_rng(seed)
    codes = rng.choice(5, size=(K, T), p=[0.4, 0.3, 0.2, 0.05, 0.05])
    for b in range(chunk - 1, T - 2, chunk):
        codes[1, b - 1], codes[1, b], codes[1, b + 1] = 0, 1, 2  # A B C over a boundary
    return codes


@pytest.mark.parametrize("n_dev", [8, 4])
def test_time_sharded_equals_jax_and_single_device(n_dev):
    query = ts.strict3
    codes = straddling_codes(chunk=256 // n_dev)
    events = full_batch(codes)
    K, T = codes.shape
    single = StencilMatcher(query(ts.TQuery), K, device="cpu")
    _, want = single.scan(single.init_state(), events)
    jsh = JTimeSharded(query(ts.JQuery), K, j_key_mesh(jax.devices()[:n_dev], axis="time"))
    jout = jsh.match(jsh.shard_events(ts.to_jax(events)))
    sharded = TimeShardedStencil(query(ts.TQuery), K, key_mesh(["cpu"] * n_dev, axis="time"))
    parts = sharded.shard_events(events)
    assert len(parts) == n_dev and all(p.ts.shape == (K, T // n_dev) for p in parts)
    got = sharded.match(parts)
    # Against JAX: every element, the halo's zero offsets included.
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(jout.hit))
    np.testing.assert_array_equal(got.offs.numpy(), np.asarray(jout.offs))
    # Against the single-device stencil: hits everywhere, offsets where hit.
    hit = want.hit.numpy()
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.offs.numpy()[hit], want.offs.numpy()[hit])
    assert hit[1].sum() >= n_dev - 1  # the boundary-straddling matches happened
    np.testing.assert_array_equal(sharded.match(events).hit.numpy(), hit)


def test_time_sharded_single_stage_and_padding():
    """A one-stage sequence needs no halo; padded slots never match."""
    one = ts.TQuery().select("a").where(ts.value_is(ts.A)).build()
    jone = ts.JQuery().select("a").where(ts.value_is(ts.A)).build()
    codes = straddling_codes(seed=5, K=3, T=64)
    events = full_batch(codes)
    events = events._replace(valid=torch.arange(64)[None, :].expand(3, 64) < 50)
    got = TimeShardedStencil(one, 3, key_mesh(["cpu"] * 8)).match(events)
    jsh = JTimeSharded(jone, 3, j_key_mesh(jax.devices()[:8]))
    jout = jsh.match(jsh.shard_events(ts.to_jax(events)))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(jout.hit))
    np.testing.assert_array_equal(got.offs.numpy(), np.asarray(jout.offs))
    assert not got.hit[:, 50:].any() and got.hit.any()


def test_time_sharded_rejects_indivisible():
    sharded = TimeShardedStencil(ts.strict3(ts.TQuery), 2, key_mesh(["cpu"] * 8, axis="time"))
    with pytest.raises(ValueError, match="divisible"):
        sharded.match(full_batch(np.zeros((2, 60), dtype=np.int64)))
