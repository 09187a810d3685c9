"""``chip_smoke.py``'s input memo (``inputs``), on the CPU at small sizes.

Each stream the script feeds its phases is built once per process and
handed out as fresh lists.  These tests hold every memoised builder's
records to a fresh build, field for field, and show that a list a phase
consumed (run through a CPU ``CEPProcessor`` on the plain kernels, then
emptied) leaves the memo's copy as built, so a later phase is fed what the
parent script fed it.
"""

import os
import sys

import numpy as np
import pytest

from kafkastreams_cep_tpu_torch import CEPProcessor, EngineConfig, Query, Record
from kafkastreams_cep_tpu_torch.runtime import IngestPolicy

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402


def fields(x):
    """Records (in lists and tuples, as the builders nest them) as plain
    data: each record's type, key and its type, value, timestamp, offset."""
    if isinstance(x, Record):
        return (type(x), x.key, type(x.key), x.value, type(x.timestamp), x.timestamp,
                x.offset)
    if isinstance(x, (list, tuple)):
        return [fields(v) for v in x]
    raise TypeError(type(x))


def esc_batch(K, T, b):
    """Phase 13 (b)'s batch as the parent script built it in line."""
    keys, prices, volumes = cs.processor_stream(K, T)
    N = K * T
    return [Record(int(keys[i]), {"price": int(prices[i]), "volume": int(volumes[i])},
                   b * N + i) for i in range(N)]


def headline_records(K, T):
    """Phase 11 (b)'s records as the parent script built them in line."""
    keys, prices, volumes = cs.processor_stream(K, T)
    return [Record(k, {"price": p, "volume": v}, t) for k, p, v, t in
            zip(keys.tolist(), prices.tolist(), volumes.tolist(), range(K * T))]


BUILDS = {
    "resilience_batches": (cs.resilience_batches, (Record, 16, 64, 8)),
    "processor_records": (cs.processor_records, (Record, 16, 8, 2)),
    "overload_batches": (cs.overload_batches, (Record, 16, 64)),
    "skew_batches": (cs.skew_batches, (Record, 16, 4, 3, 32)),
    "ooo_trace": (cs.ooo_trace, (Record, 8, 2)),
}


@pytest.fixture(autouse=True)
def fresh_memo():
    cs.INPUTS.clear()
    yield
    cs.INPUTS.clear()


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_memo_equals_a_fresh_build(name):
    builder, args = BUILDS[name]
    first, second = cs.inputs(builder, *args), cs.inputs(builder, *args)
    assert len(cs.INPUTS) == 1  # built once
    want = fields(builder(*args))
    assert fields(first) == want and fields(second) == want
    assert lists_fresh(first, second)


def lists_fresh(a, b):
    """Whether no list or tuple of ``a`` is one of ``b``'s (records are
    shared)."""
    if isinstance(a, Record) or not isinstance(a, (list, tuple)):
        return True
    return a is not b and all(lists_fresh(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("where", ["phase 11 (b)", "phase 13 (a)", "phase 13 (b)"])
def test_memo_equals_the_parent_scripts_inline_builds(where):
    """The streams the parent script built in line, or built again to keep
    a slice, equal what the memo hands out in their place."""
    if where == "phase 11 (b)":
        got, want = cs.inputs(cs.processor_records, Record, 16, 8, 0), headline_records(16, 8)
    elif where == "phase 13 (a)":
        got = cs.inputs(cs.resilience_batches, Record, 16, 64, 8)
        want = cs.resilience_batches(Record, 16, 64, 6) + got[6:]
        assert fields(got[6:]) == fields(cs.resilience_batches(Record, 16, 64, 8)[6:])
    else:
        got = [cs.inputs(cs.processor_records, Record, 16, 4, b) for b in range(3)]
        want = [esc_batch(16, 4, b) for b in range(3)]
    assert fields(got) == fields(want)


def consume(batches, lanes, guard):
    """Run ``batches`` through a CPU processor on the plain kernels, as a
    phase does, then empty and reorder the lists it was handed."""
    proc = CEPProcessor(cs.stock_pattern(Query), lanes, EngineConfig(**cs.HEADLINE), epoch=0,
                        ingest=IngestPolicy(grace_ms=cs.OOO_GRACE) if guard else None,
                        device="cpu")
    out = []
    for b in batches:
        out += proc.process(b)
    out += proc.drain_ingest() + proc.flush()
    for b in batches:
        b.reverse()
        b.clear()
    batches.clear()
    return out


CONSUMED = {
    "resilience_batches": (cs.resilience_batches, (Record, 16, 64, 8), False),
    "ooo_trace": (cs.ooo_trace, (Record, 64, 1), True),
    "processor_records": (cs.processor_records, (Record, 16, 64, 1), False),
}


@pytest.mark.parametrize("name", sorted(CONSUMED))
def test_a_consumed_list_leaves_the_memo_as_built(name):
    builder, args, guard = CONSUMED[name]
    handed = cs.inputs(builder, *args)
    if name == "ooo_trace":  # the shuffled stream, through the guard
        batches = [handed[1][i:i + 512] for i in range(0, len(handed[1]), 512)]
    elif name == "processor_records":
        batches = [handed]
    else:
        batches = handed
    out = consume(batches, args[1], guard)
    assert out  # the stream matched: the processor read every record
    want = fields(builder(*args))
    (key, memo), = cs.INPUTS.items()
    assert fields(memo) == want
    assert fields(cs.inputs(builder, *args)) == want


def test_numpy_inputs_are_copied():
    cols = cs.inputs(cs.processor_stream, 16, 8)
    cols[0][:] = -1
    again = cs.inputs(cs.processor_stream, 16, 8)
    assert all(np.array_equal(a, b) for a, b in zip(again, cs.processor_stream(16, 8)))
