"""The port's ``CEPProcessor`` against the JAX package's, record for record.

The stock demo must print ``examples/stock_demo.py``'s four lines byte for
byte.  A multi-key stream must give the same ``(key, Sequence)`` list, in
the same order, as the JAX processor (its jnp path on the CPU) batch by
batch — across ``gc_interval`` sweeps, in pipelined mode, with replayed
offsets, through the decode fallback, and through checkpoints written by
one package and restored by the other — and the engine states must agree
leaf by leaf.
"""

import os
import sys

import numpy as np
import pytest

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.runtime import CEPProcessor as JProcessor
from kafkastreams_cep_tpu.runtime import Record as JRecord
from kafkastreams_cep_tpu.runtime import checkpoint as jckpt
from kafkastreams_cep_tpu_torch import CEPProcessor, EngineConfig, Record
from kafkastreams_cep_tpu_torch.runtime import checkpoint as tckpt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import stock_demo  # noqa: E402

CONFIG = dict(max_runs=16, slab_entries=48, slab_preds=8, dewey_depth=12,
              max_walk=12)


def test_stock_demo_prints_expected_lines():
    proc = CEPProcessor(
        ts.stock(ts.TQuery), num_lanes=1,
        config=EngineConfig(max_runs=32, slab_entries=64, slab_preds=8,
                            dewey_depth=16, max_walk=16),
        topic="StockEvents", device="cpu",
    )
    name_of = {i: ev["name"] for i, ev in enumerate(stock_demo.STOCK_EVENTS)}
    records = [
        Record("stocks", {"price": ev["price"], "volume": ev["volume"]}, 1000 + i)
        for i, ev in enumerate(stock_demo.STOCK_EVENTS)
    ]
    lines = [stock_demo.format_match(seq, name_of) for _, seq in proc.process(records)]
    assert lines == stock_demo.EXPECTED
    assert all(v == 0 for v in proc.counters().values())


def stream(seed, n_batches=6, per_batch=40, keys=("a", "b", 7, "d", 11)):
    """Batches of ``(key, value, timestamp)`` stock records over ``keys``."""
    rng = np.random.default_rng(seed)
    ts0 = 1_700_000_000_000
    batches, t = [], 0
    for _ in range(n_batches):
        batch = []
        for _ in range(per_batch):
            key = keys[int(rng.integers(0, len(keys)))]
            value = {"price": int(rng.integers(95, 126)),
                     "volume": int(rng.integers(700, 1101))}
            batch.append((key, value, ts0 + 10 * t))
            t += 1
        batches.append(batch)
    return batches


def pair(num_lanes=5, config=None, **kw):
    conf = dict(CONFIG, **(config or {}))
    jproc = JProcessor(ts.stock(ts.JQuery), num_lanes, JConfig(**conf), **kw)
    tproc = CEPProcessor(ts.stock(ts.TQuery), num_lanes, EngineConfig(**conf),
                         device="cpu", **kw)
    return jproc, tproc


def feed(jproc, tproc, batch, offsets=None):
    offs = offsets or [None] * len(batch)
    j = jproc.process([JRecord(k, v, t, o) for (k, v, t), o in zip(batch, offs)])
    t = tproc.process([Record(k, v, t, o) for (k, v, t), o in zip(batch, offs)])
    assert ts.canon_matches(j) == ts.canon_matches(t)
    return len(t)


def assert_same(jproc, tproc):
    ts.assert_states_equal(jproc.state, tproc.state)
    assert jproc.counters() == tproc.counters()
    assert jproc._lane_of == tproc._lane_of
    np.testing.assert_array_equal(jproc._next_offset, tproc._next_offset)
    assert [sorted(d) for d in jproc._events] == [sorted(d) for d in tproc._events]


def test_multi_key_stream_with_sweeps_equals_jax():
    jproc, tproc = pair(gc_interval=2, gc_events_interval=2)
    n = sum(feed(jproc, tproc, b) for b in stream(0))
    assert n > 0
    assert_same(jproc, tproc)
    assert tproc.metrics.batches == 6 and tproc.metrics.records_in == 240


def test_pipelined_mode_equals_jax():
    jproc, tproc = pair(pipeline=True, gc_interval=3)
    n = sum(feed(jproc, tproc, b) for b in stream(1))
    j, t = jproc.flush(), tproc.flush()
    assert ts.canon_matches(j) == ts.canon_matches(t)
    assert n + len(t) > 0
    assert_same(jproc, tproc)


def test_replay_dedup_and_decode_fallback_equal_jax():
    jproc, tproc = pair(decode_budget=2)
    batches = stream(2, n_batches=3)
    offsets = {}
    for b in batches:
        offs = []
        for k, _, _ in b:
            offsets[k] = offsets.get(k, 100) + 1
            offs.append(offsets[k])
        feed(jproc, tproc, b, offs)
        feed(jproc, tproc, b, offs)  # the same batch replayed: all dropped
    assert tproc.metrics.duplicates_dropped == jproc.metrics.duplicates_dropped > 0
    assert tproc.metrics.decode_fallbacks == jproc.metrics.decode_fallbacks > 0
    assert_same(jproc, tproc)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_cross_loads(writer, tmp_path):
    """A snapshot written by one package restores into both; the two
    restored processors then emit the same matches and reach the same
    state.  (Both restore from the file, so their batch counters, and with
    them the sweep cadence, restart together.)"""
    batches = stream(3)
    jproc, tproc = pair(gc_interval=4)
    for b in batches[:3]:
        feed(jproc, tproc, b)
    path = str(tmp_path / "snap.ckpt")
    if writer == "jax":
        jckpt.save_checkpoint(jproc, path)
    else:
        tckpt.save_checkpoint(tproc, path)
    jproc = jckpt.restore_processor(ts.stock(ts.JQuery), path)
    tproc = tckpt.restore_processor(ts.stock(ts.TQuery), path, device="cpu")
    assert_same(jproc, tproc)
    for b in batches[3:]:
        feed(jproc, tproc, b)
    assert_same(jproc, tproc)


def test_checkpoint_refuses_other_topology(tmp_path):
    _, tproc = pair()
    feed(*pair(), stream(4, n_batches=1)[0])
    path = str(tmp_path / "snap.ckpt")
    tckpt.save_checkpoint(tproc, path)
    with pytest.raises(ValueError, match="topology"):
        tckpt.restore_processor(ts.strict3(ts.TQuery), path, device="cpu")
