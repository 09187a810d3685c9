"""Shared helpers for the PyTorch-port suites (``test_torch_*.py``).

Every query is written once over a ``Query`` class, so the same predicate
and fold lambdas build a pattern in the JAX package and in the port; inputs
are made with numpy from a seed and handed to both.  States and outputs
are compared leaf by leaf through ``kafkastreams_cep_tpu_torch.convert``.
"""

import jax.numpy as jnp
import numpy as np
import torch

from kafkastreams_cep_tpu import Query as JQuery
from kafkastreams_cep_tpu.engine import EventBatch as JEventBatch
from kafkastreams_cep_tpu_torch import Query as TQuery
from kafkastreams_cep_tpu_torch.convert import state_arrays
from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch

A, B, C, D, X = 0, 1, 2, 3, 4


def value_is(code):
    return lambda k, v, ts, st: v == code


def strict3(Q):
    """NFATest.java:42-67 — strict contiguity SEQ(first, second, latest)."""
    return (
        Q().select("first").where(value_is(A))
        .then().select("second").where(value_is(B))
        .then().select("latest").where(value_is(C))
        .build()
    )


def kleene_one_or_more(Q):
    """NFATest.java:69-101 — SEQ(a, b, c+, d)."""
    return (
        Q().select("firstStage").where(value_is(A))
        .then().select("secondStage").where(value_is(B))
        .then().select("thirdStage").one_or_more().where(value_is(C))
        .then().select("latestState").where(value_is(D))
        .build()
    )


def skip_till_next(Q):
    """NFATest.java:104-132."""
    return (
        Q().select("first").where(value_is(A))
        .then().select("second").skip_till_next_match().where(value_is(C))
        .then().select("latest").skip_till_next_match().where(value_is(D))
        .build()
    )


def skip_till_any(Q):
    """NFATest.java:134-172 — nondeterministic branching."""
    return (
        Q().select("first").where(value_is(A))
        .then().select("second").where(value_is(B))
        .then().select("three").skip_till_any_match().where(value_is(C))
        .then().select("latest").skip_till_any_match().where(value_is(D))
        .build()
    )


def stock(Q):
    """The SASE stock query (``examples/stock_demo.py``)."""
    return (
        Q().select()
        .where(lambda k, v, ts, st: v["volume"] > 1000)
        .fold("avg", lambda k, v, curr: v["price"])
        .then().select().zero_or_more().skip_till_next_match()
        .where(lambda k, v, ts, st: v["price"] > st.get("avg"))
        .fold("avg", lambda k, v, curr: (curr + v["price"]) // 2)
        .fold("volume", lambda k, v, curr: v["volume"])
        .then().select().skip_till_next_match()
        .where(lambda k, v, ts, st: v["volume"] < 0.8 * st.get_or_else("volume", 0))
        .within(1, "h")
        .build()
    )


def float_fold(Q):
    """A float32 fold state read by a predicate (typed agg bit patterns)."""
    return (
        Q().select().where(lambda k, v, ts, st: v > 2)
        .fold("m", lambda k, v, curr: v * 0.5, init=0.0)
        .then().select().zero_or_more().skip_till_next_match()
        .where(lambda k, v, ts, st: v > st.get("m"))
        .fold("m", lambda k, v, curr: curr + v * 0.25, init=0.0)
        .then().select().skip_till_next_match()
        .where(lambda k, v, ts, st: v < st.get("m"))
        .build()
    )


def straddle(Q):
    """``tests/test_renorm.py``'s stock-shaped query: BEGIN-advanced runs
    straddle and append a version digit per ignored event."""
    return (
        Q().select("a").where(lambda k, v, ts, st: v["x"] == 0)
        .then().select("b").zero_or_more().skip_till_next_match()
        .where(lambda k, v, ts, st: (0 < v["x"]) & (v["x"] < 6))
        .then().select("c").skip_till_next_match()
        .where(lambda k, v, ts, st: v["x"] == 7)
        .build()
    )


SCENARIOS = {
    "strict3": (strict3, "letters"),
    "kleene": (kleene_one_or_more, "letters"),
    "skip_next": (skip_till_next, "letters"),
    "skip_any": (skip_till_any, "letters"),
    "stock": (stock, "stock"),
    "float_fold": (float_fold, "small"),
    "straddle": (straddle, "x"),
}

STOCKS = [
    {"price": 100, "volume": 1010},
    {"price": 120, "volume": 990},
    {"price": 120, "volume": 1005},
    {"price": 121, "volume": 999},
    {"price": 120, "volume": 999},
    {"price": 125, "volume": 750},
    {"price": 120, "volume": 950},
    {"price": 120, "volume": 700},
]


def both(builder):
    """The same query built in the JAX package and in the port."""
    return builder(JQuery), builder(TQuery)


def trace(kind: str, rng, K: int, T: int):
    """``[K, T]`` event values for a scenario kind, as numpy leaves."""
    if kind == "letters":
        return rng.integers(0, 5, size=(K, T)).astype(np.int32)
    if kind == "small":
        return rng.integers(0, 8, size=(K, T)).astype(np.int32)
    if kind == "x":
        return {"x": rng.choice([0, 1, 6, 6, 6, 7], size=(K, T)).astype(np.int32)}
    return {
        "price": rng.integers(90, 131, size=(K, T)).astype(np.int32),
        "volume": rng.integers(600, 1101, size=(K, T)).astype(np.int32),
    }


def events(kind: str, rng, K: int, T: int) -> EventBatch:
    """A port ``EventBatch [K, T]`` of ``trace(kind)`` values: key = lane,
    ts = 3t, off = t, every step valid."""
    values = trace(kind, rng, K, T)
    i32 = torch.int32
    return EventBatch(
        key=torch.arange(K, dtype=i32)[:, None].expand(K, T),
        value=({f: to_t(v) for f, v in values.items()}
               if isinstance(values, dict) else to_t(values)),
        ts=(torch.arange(T, dtype=i32) * 3)[None, :].expand(K, T),
        off=torch.arange(T, dtype=i32)[None, :].expand(K, T),
        valid=torch.ones((K, T), dtype=torch.bool),
    )


def to_jax(events: EventBatch) -> JEventBatch:
    """The same events as the JAX package's ``EventBatch``."""
    def j(x):
        if isinstance(x, dict):
            return {k: j(v) for k, v in x.items()}
        return jnp.asarray(x.numpy())

    return JEventBatch(*(j(x) for x in events))


def canon(seq) -> dict:
    """Order-insensitive form of a Sequence of either package."""
    return {
        stage: sorted(e.offset for e in events)
        for stage, events in seq.as_map().items()
    }


def canon_matches(matches):
    """``[(key, Sequence)]`` -> comparable plain data, keeping the order."""
    return [
        (key, [(stage, [(e.offset, e.timestamp, e.value) for e in evs])
               for stage, evs in seq.as_map().items()])
        for key, seq in matches
    ]


def assert_states_equal(jax_state, torch_state, msg=""):
    """Every leaf of a JAX state equals the port's, bit for bit."""
    a, b = state_arrays(jax_state), state_arrays(torch_state)
    assert a.keys() == b.keys(), msg
    for name in a:
        assert a[name].dtype == b[name].dtype, f"{msg} {name} dtype"
        np.testing.assert_array_equal(a[name], b[name], err_msg=f"{msg} {name}")


def to_t(x):
    return torch.as_tensor(np.array(x))


def from_jax(events) -> EventBatch:
    """A JAX package ``EventBatch`` as the port's (CPU tensors)."""
    def t(x):
        if isinstance(x, dict):
            return {k: t(v) for k, v in x.items()}
        return to_t(x)

    return EventBatch(*(t(x) for x in events))
