"""The port's ``StencilMatcher`` (the whole-query stencil tier for strict
sequences) against the JAX package's, on ``tests/test_stencil.py``'s
cases: one batch, across batches with ragged valid prefixes (the carry
holding a match that spans a boundary), a one-stage pattern, and the
refusal of a pattern that is not a strict sequence.  Hits, match offsets
and the carry agree bit for bit; the JAX matcher's hits are the oracle's
(``tests/test_stencil.py``)."""

import numpy as np
import pytest
import torch

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine.stencil import StencilMatcher as JStencil
from kafkastreams_cep_tpu_torch.engine import EventBatch
from kafkastreams_cep_tpu_torch.engine.stencil import StencilMatcher, StencilOutput

from test_stencil import batch_of, oracle_hits, stencil_hits


def torch_batch(codes, offs, valid):
    codes = np.asarray(codes, np.int32)
    K, T = codes.shape
    return EventBatch(
        key=torch.zeros((K, T), dtype=torch.int32),
        value=ts.to_t(codes),
        ts=torch.arange(T, dtype=torch.int32).expand(K, T),
        off=ts.to_t(np.asarray(offs, np.int32)),
        valid=ts.to_t(np.asarray(valid, bool)),
    )


def scan_both(make_pattern, K, batches):
    """Both matchers over the same ``(codes, offs, valid)`` batches, carry
    and outputs compared after each; returns the port's hits."""
    jm = JStencil(make_pattern(ts.JQuery), K)
    tm = StencilMatcher(make_pattern(ts.TQuery), K, device="cpu")
    js, tst = jm.init_state(), tm.init_state()
    ts.assert_states_equal(js, tst, "init")
    hits = []
    for i, (codes, offs, valid) in enumerate(batches):
        js, jo = jm.scan(js, batch_of(codes, offs, valid))
        tst, to = tm.scan(tst, torch_batch(codes, offs, valid))
        ts.assert_states_equal(js, tst, f"carry after batch {i}")
        for f in StencilOutput._fields:
            np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                          err_msg=f"batch {i} {f}")
        hits += stencil_hits(to, tm.n)
    return hits


def test_rejects_non_strict_patterns():
    for make_pattern in (ts.kleene_one_or_more, ts.skip_till_any, ts.stock):
        with pytest.raises(ValueError, match="strict"):
            StencilMatcher(make_pattern(ts.TQuery), 1, device="cpu")


def test_single_batch_equals_jax():
    rng = np.random.default_rng(21)
    K, T = 16, 64
    codes = rng.choice(5, size=(K, T), p=[0.4, 0.3, 0.2, 0.05, 0.05])
    offs = np.broadcast_to(np.arange(T), (K, T))
    got = scan_both(ts.strict3, K, [(codes, offs, np.ones((K, T), bool))])
    want = [h for k in range(K) for h in oracle_hits(ts.strict3(ts.JQuery), codes[k])]
    assert sorted(got) == sorted(want) and got


def test_across_batches_and_ragged_equals_jax():
    rng = np.random.default_rng(22)
    K, total, T = 8, 96, 32
    codes = rng.choice(5, size=(K, total), p=[0.4, 0.3, 0.2, 0.05, 0.05])
    codes[0, 31], codes[0, 32], codes[0, 33] = 0, 1, 2
    consumed = np.zeros(K, dtype=int)
    batches = []
    for _ in range(3):
        counts = rng.integers(T // 2, T + 1, size=K)
        vals, offs = np.zeros((K, T), np.int64), np.zeros((K, T), np.int64)
        valid = np.zeros((K, T), bool)
        for k in range(K):
            c = min(int(counts[k]), total - consumed[k])
            vals[k, :c] = codes[k, consumed[k]:consumed[k] + c]
            offs[k, :c] = np.arange(consumed[k], consumed[k] + c)
            valid[k, :c] = True
            consumed[k] += c
        batches.append((vals, offs, valid))
    got = scan_both(ts.strict3, K, batches)
    want = [h for k in range(K)
            for h in oracle_hits(ts.strict3(ts.JQuery), codes[k, :consumed[k]])]
    assert sorted(got) == sorted(want)
    assert (31, 32, 33) in got


def test_single_stage_pattern_equals_jax():
    def only(Q):
        return Q().select("only").where(lambda k, v, ts_, st: v == 2).build()

    codes = np.array([[2, 0, 2, 2], [0, 0, 0, 2]])
    offs = np.broadcast_to(np.arange(4), (2, 4))
    got = scan_both(only, 2, [(codes, offs, np.ones((2, 4), bool))])
    assert sorted(got) == [(0,), (2,), (3,), (3,)]


def test_decode_builds_sequences():
    K, T = 2, 6
    codes = np.array([[0, 1, 2, 0, 1, 2], [4, 0, 1, 2, 4, 4]])
    m = StencilMatcher(ts.strict3(ts.TQuery), K, device="cpu")
    _, out = m.scan(m.init_state(), torch_batch(codes, np.broadcast_to(np.arange(T), (K, T)),
                                                np.ones((K, T), bool)))
    from kafkastreams_cep_tpu_torch.utils.events import Event

    events = [{t: Event(None, int(codes[k, t]), t, "s", 0, t) for t in range(T)}
              for k in range(K)]
    got = [(k, t, {s: [e.offset for e in evs] for s, evs in seq.as_map().items()})
           for k, t, seq in m.decode(out, events)]
    assert got == [(0, 2, {"latest": [2], "second": [1], "first": [0]}),
                   (0, 5, {"latest": [5], "second": [4], "first": [3]}),
                   (1, 3, {"latest": [3], "second": [2], "first": [1]})]


def test_carry_crosses_packages():
    """A JAX ``StencilState`` carries into the port (``convert.to_torch``)
    and the port's back into the JAX package, mid-stream, with a match
    spanning the boundary."""
    from kafkastreams_cep_tpu.engine.stencil import StencilState as JState
    from kafkastreams_cep_tpu_torch.convert import to_numpy, to_torch

    codes = np.array([[4, 4, 0, 1], [2, 0, 1, 2]]), np.array([[2, 0, 1, 2], [4, 0, 1, 2]])
    offs = np.arange(4)[None, :].repeat(2, 0), 4 + np.arange(4)[None, :].repeat(2, 0)
    valid = np.ones((2, 4), bool)
    jm = JStencil(ts.strict3(ts.JQuery), 2)
    tm = StencilMatcher(ts.strict3(ts.TQuery), 2, device="cpu")
    js, _ = jm.scan(jm.init_state(), batch_of(codes[0], offs[0], valid))
    tst, _ = tm.scan(tm.init_state(), torch_batch(codes[0], offs[0], valid))
    _, j_out = jm.scan(js, batch_of(codes[1], offs[1], valid))
    _, t_out = tm.scan(to_torch(js), torch_batch(codes[1], offs[1], valid))
    _, back = jm.scan(to_numpy(tst, {"StencilState": JState}), batch_of(codes[1], offs[1], valid))
    for f in StencilOutput._fields:
        np.testing.assert_array_equal(getattr(t_out, f).numpy(), np.asarray(getattr(j_out, f)))
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), np.asarray(getattr(j_out, f)))
    assert (2, 3, 4) in stencil_hits(t_out, 3)
