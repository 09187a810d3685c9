"""The port's columnar ingestion against the JAX package's, on the CPU:
the validation rejections of ``tests/test_satellites.py:39-120`` (the same
messages, and atomic: nothing of a refused batch stays behind), object
keys mixed with records and integer keys past int32 (the record path's key
codes), an empty batch, float schemas and string keys (values rebuilt from
the packed columns in the schema's dtypes), and ``metrics_snapshot`` after
columns.  Every comparison is exact.
"""

import numpy as np
import pytest

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.runtime import CEPProcessor as JProcessor
from kafkastreams_cep_tpu.runtime import Record as JRecord
from kafkastreams_cep_tpu_torch import CEPProcessor, EngineConfig, Record
from kafkastreams_cep_tpu_torch.runtime import InputRejected
from test_torch_columns import SMALL, STOCK, assert_same, cols, feed_columns, pair, stock_columns
from test_torch_ingest import Clock, assert_snapshots_equal


def test_float_schema_and_string_keys_equal_jax():
    """float32 values come back as the schema's floats; string keys map
    through the Python pass to their lane codes."""
    rng = np.random.default_rng(7)
    n = 64
    keys = np.array(["a", "b", "c", "d"])[np.concatenate([rng.permutation(4) for _ in range(16)])]
    vals = (rng.random(n) * 8).astype(np.float32)
    tss = 1000 + np.arange(n)
    jproc, tproc = pair(ts.float_fold, num_lanes=4, conf=SMALL)
    got = []
    for i in range(0, n, 32):
        got += feed_columns(jproc, tproc, *cols(keys, vals, tss, slice(i, i + 32)))
    assert got
    assert_same(jproc, tproc)
    ev = next(e for d in tproc._events for e in d.values())
    assert type(ev.value) is float and ev.key in ("a", "b", "c", "d")


def test_snapshot_after_columns_equals_jax():
    keys, values, tss = stock_columns(37, 192, 8)
    jproc = JProcessor(ts.stock(ts.JQuery), 8, JConfig(**STOCK), clock=Clock(), name="cols")
    tproc = CEPProcessor(ts.stock(ts.TQuery), 8, EngineConfig(**STOCK), clock=Clock(),
                         name="cols", device="cpu")
    for i in range(0, 192, 64):
        feed_columns(jproc, tproc, *cols(keys, values, tss, slice(i, i + 64)))
    assert_snapshots_equal(jproc.metrics_snapshot(), tproc.metrics_snapshot())


# -- validation (tests/test_satellites.py:39-120) --------------------------------


def key_pair(Q):
    """A two-stage query whose stages both read the key code."""
    return (
        Q().select("a").where(lambda k, v, ts, st: (k == 5) & (v == 0))
        .then().select("b").where(lambda k, v, ts, st: (k == 5) & (v == 1))
        .build()
    )


BAD = {
    "short_timestamps": (np.array([1, 2]), np.array([0, 0], np.int32), [1]),
    "scalar_timestamps": (np.array([1, 2]), np.array([0, 0], np.int32), 7),
    "2d_keys": (np.zeros((2, 2), np.int32), np.array([0, 0], np.int32), [1, 2]),
    "short_values": (np.array([1, 2]), np.array([0], np.int32), [1, 2]),
    "float_in_int": (np.array([1, 2]), np.array([0.5, 1.0]), [1, 2]),
    "structure": (np.array([1, 2]), {"x": np.array([0, 0])}, [1, 2]),
    "too_many_keys": (np.array([1, 2, 3]), np.array([0, 0, 0], np.int32), [1, 2, 3]),
    "time_range": (np.array([1, 2]), np.array([0, 0], np.int32), [1, 10**12]),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_rejections_equal_jax_and_are_atomic(case):
    """Each bad batch raises the same message in both packages and leaves
    no lane, offset or column batch behind; a good batch then works."""
    jproc, tproc = pair(ts.strict3, num_lanes=2, conf=SMALL)
    # One good batch first fixes the schema (int scalars) and the epoch.
    feed_columns(jproc, tproc, np.array([9]), np.array([ts.A], np.int32), [1])
    before = (dict(tproc._lane_of), tproc._next_offset.copy(), len(tproc._col_batches))
    with pytest.raises(ValueError) as je:
        jproc.process_columns(*BAD[case])
    with pytest.raises(InputRejected) as te:
        tproc.process_columns(*BAD[case])
    assert str(te.value) == str(je.value)
    assert (dict(tproc._lane_of), len(tproc._col_batches)) == (before[0], before[2])
    np.testing.assert_array_equal(tproc._next_offset, before[1])
    out = feed_columns(jproc, tproc, np.array([9, 9]),
                       np.array([ts.B, ts.C], np.int32), [2, 3])
    assert len(out) == 1
    assert_same(jproc, tproc)


def test_object_keys_mixed_with_records_keep_key_codes():
    """An int key through records and through an object column presents
    the same key code to predicates (``_key_code``, per element)."""
    jproc, tproc = pair(key_pair, num_lanes=4, conf=SMALL)
    assert tproc.process([Record(5, 0, 1)]) == jproc.process([JRecord(5, 0, 1)]) == []
    out = feed_columns(jproc, tproc, np.array([5, "other"], dtype=object),
                       np.array([1, 1], np.int32), [2, 2])
    assert len(out) == 1 and out[0][0] == 5
    out = feed_columns(jproc, tproc, np.array([5, "other", 5], dtype=object),
                       np.array([0, 0, 1], np.int32), [3, 3, 4])
    assert len(out) == 1 and out[0][0] == 5
    assert_same(jproc, tproc)


def test_out_of_range_int_keys_take_their_lane_code():
    jproc, tproc = pair(ts.strict3, num_lanes=3, conf=SMALL)
    big = 2**40
    assert feed_columns(jproc, tproc, np.array([big, "x"], dtype=object),
                        np.array([ts.A, ts.A], np.int32), [1, 1]) == []
    feed_columns(jproc, tproc, np.array([big, -big], dtype=object),
                 np.array([ts.B, ts.A], np.int32), [2, 2])
    assert tproc._lane_of[big] == 0 and tproc._lane_of[-big] == 2
    assert_same(jproc, tproc)


def test_empty_column_batch_is_a_no_op():
    jproc, tproc = pair(ts.strict3, num_lanes=2, conf=SMALL)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int32), np.zeros(0, np.int64))
    assert feed_columns(jproc, tproc, *empty) == []
    assert tproc.metrics.batches == 0 and not tproc._col_batches
