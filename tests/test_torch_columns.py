"""The port's columnar ingestion (``CEPProcessor.process_columns``) against
the JAX package's, batch by batch, on the CPU.

The cases of ``tests/test_runtime.py:380,439`` (per-record parity with the
events' values, timestamps and offsets; pipelined with the event GC; a
checkpoint round trip, written by either package and restored by both),
lazy extraction at ``drain_interval`` 1 and 3, and the tiered processor
with an event GC after every batch held against the untiered stream.
Events stay packed columns until a decode or the GC touches them; every
comparison is exact.  The validation cases, float schemas, string and
object keys and the snapshot are in ``test_torch_columns_validation.py``.
"""

import numpy as np
import pytest

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.runtime import CEPProcessor as JProcessor
from kafkastreams_cep_tpu.runtime import checkpoint as jckpt
from kafkastreams_cep_tpu_torch import CEPProcessor, EngineConfig, Record
from kafkastreams_cep_tpu_torch.runtime import checkpoint as tckpt
from test_torch_tiering import CFG as TIER_CFG
from test_torch_tiering import planted_codes, prefix_n_minus_1

STOCK = dict(max_runs=16, slab_entries=32, slab_preds=8, dewey_depth=12, max_walk=12)
SMALL = dict(max_runs=16, slab_entries=48, slab_preds=6, dewey_depth=10, max_walk=10)


def stock_columns(seed, n, keys):
    """``n`` stock records over ``keys`` keys, each run of ``keys`` records
    a permutation of the keys: every batch of a multiple of ``keys``
    records packs to the same ``T`` (one JAX compile a config)."""
    rng = np.random.default_rng(seed)
    return (np.concatenate([rng.permutation(keys) for _ in range(n // keys)]).astype(np.int64),
            {"price": rng.integers(90, 131, size=n).astype(np.int64),
             "volume": rng.integers(600, 1101, size=n).astype(np.int64)},
            1000 + np.arange(n, dtype=np.int64))


def cols(keys, values, tss, sl):
    vals = ({k: v[sl] for k, v in values.items()} if isinstance(values, dict)
            else values[sl])
    return keys[sl], vals, tss[sl]


def pair(builder=ts.stock, num_lanes=8, conf=STOCK, **kw):
    jproc = JProcessor(builder(ts.JQuery), num_lanes, JConfig(**conf), **kw)
    tproc = CEPProcessor(builder(ts.TQuery), num_lanes, EngineConfig(**conf),
                         device="cpu", **kw)
    return jproc, tproc


def feed_columns(jproc, tproc, *columns):
    j = jproc.process_columns(*columns)
    t = tproc.process_columns(*columns)
    assert ts.canon_matches(t) == ts.canon_matches(j)
    return ts.canon_matches(t)


def records_of(keys, values, tss, sl, R):
    return [R(int(keys[j]), {n: int(v[j]) for n, v in values.items()}, int(tss[j]))
            for j in range(*sl.indices(len(keys)))]


def assert_same(jproc, tproc):
    ts.assert_states_equal(jproc.state, tproc.state)
    assert tproc.counters() == jproc.counters()
    assert tproc._lane_of == jproc._lane_of
    np.testing.assert_array_equal(tproc._next_offset, jproc._next_offset)
    np.testing.assert_array_equal(tproc._off_base, jproc._off_base)
    assert len(tproc._col_batches) == len(jproc._col_batches)
    assert [sorted(d) for d in tproc._events] == [sorted(d) for d in jproc._events]
    assert tproc._watermark == jproc._watermark


def test_columns_equal_jax_and_the_record_path():
    """Batch by batch: the port's columns equal JAX's columns and the
    port's own record path, events' values, timestamps and offsets
    included; only the events a match touched were materialized."""
    keys, values, tss = stock_columns(31, 144, 8)
    jproc, tproc = pair()
    rproc = CEPProcessor(ts.stock(ts.TQuery), 8, EngineConfig(**STOCK), device="cpu")
    n = 0
    for i in range(0, 144, 48):
        sl = slice(i, i + 48)
        got = feed_columns(jproc, tproc, *cols(keys, values, tss, sl))
        assert got == ts.canon_matches(rproc.process(records_of(keys, values, tss, sl, Record)))
        n += len(got)
        assert_same(jproc, tproc)
    assert n > 0
    touched = sum(len(d) for d in tproc._events)
    assert 0 < touched < 144 and len(tproc._col_batches) == 3
    ev = next(e for d in tproc._events for e in d.values())
    assert type(ev.value["price"]) is int and type(ev.timestamp) is int


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_round_trip(writer, tmp_path):
    """Saving materializes the live column rows into the event mirror; the
    snapshot restores into both packages, which then agree on records and
    on more columns."""
    keys, values, tss = stock_columns(31, 144, 8)
    jproc, tproc = pair()
    for i in range(0, 144, 48):
        feed_columns(jproc, tproc, *cols(keys, values, tss, slice(i, i + 48)))
    path = str(tmp_path / "col.ckpt")
    if writer == "jax":
        jckpt.save_checkpoint(jproc, path)
    else:
        tckpt.save_checkpoint(tproc, path)
    assert not (jproc if writer == "jax" else tproc)._col_batches
    more = (np.asarray([1, 1, 3]),
            {"price": np.asarray([100, 120, 99]), "volume": np.asarray([1200, 800, 1050])},
            np.asarray([5000, 5001, 5002]))
    jres = jckpt.restore_processor(ts.stock(ts.JQuery), path)
    tres = tckpt.restore_processor(ts.stock(ts.TQuery), path, device="cpu")
    assert_same(jres, tres)
    got = feed_columns(jres, tres, *more)
    rec = tckpt.restore_processor(ts.stock(ts.TQuery), path, device="cpu")
    assert ts.canon_matches(rec.process(records_of(*more, slice(0, 3), Record))) == got
    assert_same(jres, tres)


def test_pipelined_columns_with_event_gc():
    """Columns, pipelining and an event GC every third batch together:
    the serial record path's stream, and JAX's batch by batch."""
    keys, values, tss = stock_columns(33, 240, 8)
    jproc, tproc = pair(pipeline=True, gc_events_interval=3)
    ref = CEPProcessor(ts.stock(ts.TQuery), 8, EngineConfig(**STOCK), device="cpu")
    got, want = [], []
    for i in range(0, 240, 40):
        sl = slice(i, i + 40)
        got += feed_columns(jproc, tproc, *cols(keys, values, tss, sl))
        want += ts.canon_matches(ref.process(records_of(keys, values, tss, sl, Record)))
        assert len(tproc._col_batches) == len(jproc._col_batches) <= 3
    j, t = jproc.flush(), tproc.flush()
    assert ts.canon_matches(t) == ts.canon_matches(j)
    got += ts.canon_matches(t)
    assert got == want and got
    assert_same(jproc, tproc)


@pytest.mark.parametrize("drain_interval", [1, 3])
def test_lazy_columns_equal_eager(drain_interval):
    """Lazy extraction over columns (handles drained every 1 or 3 batches,
    the rest by ``flush``) emits the eager matches, batch by batch as JAX's
    lazy processor does."""
    keys, values, tss = stock_columns(35, 192, 8)
    lazy = dict(STOCK, lazy_extraction=True, handle_ring=256)
    jproc, tproc = pair(conf=lazy, drain_interval=drain_interval)
    eager = CEPProcessor(ts.stock(ts.TQuery), 8, EngineConfig(**STOCK), device="cpu")
    got, want = [], []
    for i in range(0, 192, 48):
        sl = slice(i, i + 48)
        got += feed_columns(jproc, tproc, *cols(keys, values, tss, sl))
        want += ts.canon_matches(eager.process_columns(*cols(keys, values, tss, sl)))
    j, t = jproc.flush(), tproc.flush()
    assert ts.canon_matches(t) == ts.canon_matches(j)
    got += ts.canon_matches(t)
    # Handles deferred past their batch emit by (completion step, lane,
    # row) rather than arrival: the same matches, in the eager order only
    # when every batch drains.
    assert got and (got == want if drain_interval == 1 else sorted(map(repr, got))
                    == sorted(map(repr, want)))
    assert tproc.counters() == eager.counters()
    assert_same(jproc, tproc)


@pytest.mark.parametrize("scan_kernel", [False, True], ids=["per_step", "scan"])
def test_tiered_columns_with_gc_every_batch(scan_kernel, monkeypatch):
    """The tiered processor over columns with an event GC after every
    batch: a prefix held in the stencil carry straddles a batch (and GC)
    boundary, its events sit in a dropped column batch, and the stream is
    the untiered one (the events of the carry materialize before the
    batches drop)."""
    if scan_kernel:
        monkeypatch.setenv("CEP_SCAN_KERNEL", "1")
    K, total, chunk = 3, 50, 10
    codes = planted_codes(K, total)
    streams = []
    for conf in (TIER_CFG, dict(TIER_CFG, tiering=True)):
        proc = CEPProcessor(prefix_n_minus_1(ts.TQuery), K, EngineConfig(**conf),
                            gc_events_interval=1, device="cpu")
        assert proc.uses_scan_kernel == scan_kernel
        out = []
        for start in range(0, total, chunk):
            t = np.arange(start, start + chunk)
            out += proc.process_columns(
                np.repeat(np.arange(K), chunk), codes[:, t].reshape(-1),
                np.tile(1000 + t, K))
            assert not proc._col_batches
        streams.append(ts.canon_matches(out))
    assert streams[0] == streams[1]
    assert any(("pa", [(28, 1028, 0)]) in m and ("sd", [(34, 1034, 3)]) in m
               for _, m in streams[1])
