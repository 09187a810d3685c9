"""The port's host oracle (``kafkastreams_cep_tpu_torch/nfa/``) against the
JAX package's, and against the port's engine, on the CPU.

``nfa/dewey.py``, ``nfa/buffer.py`` and ``nfa/oracle.py`` are copies over
the port's front end.  The cases of ``tests/test_dewey.py``,
``test_buffer.py`` and ``test_oracle_nfa.py`` run through both packages on
the same inputs and must give equal results (versions, sequences, match
lists, run queues, fold state); numpy-seeded random traces of every
``tests/torch_scenarios.py`` scenario go through both oracles, and the port
oracle is held event by event against the port engine (``device="cpu"``).
"""

import dataclasses

import numpy as np
import pytest

import torch_scenarios as ts
from kafkastreams_cep_tpu import DeweyVersion as JDewey
from kafkastreams_cep_tpu import Event as JEvent
from kafkastreams_cep_tpu import OracleNFA as JOracle
from kafkastreams_cep_tpu.compiler import stages as jstages
from kafkastreams_cep_tpu.nfa.buffer import SharedVersionedBuffer as JBuffer
from kafkastreams_cep_tpu_torch import EngineConfig, MatcherSession, OracleNFA, TPUMatcher
from kafkastreams_cep_tpu_torch.compiler import stages as tstages
from kafkastreams_cep_tpu_torch.nfa import DeweyVersion, SharedVersionedBuffer
from kafkastreams_cep_tpu_torch.utils.events import Event

NOW = 1_700_000_000_000
PKGS = {
    "jax": dict(Dewey=JDewey, Event=JEvent, Buffer=JBuffer, stages=jstages, Oracle=JOracle,
                Q=ts.JQuery),
    "torch": dict(Dewey=DeweyVersion, Event=Event, Buffer=SharedVersionedBuffer,
                  stages=tstages, Oracle=OracleNFA, Q=ts.TQuery),
}


def plain(seq):
    """A Sequence of either package as plain data, order kept."""
    return [(stage, [(e.key, e.value, e.timestamp, e.topic, e.partition, e.offset)
                     for e in evs])
            for stage, evs in seq.as_map().items()]


def both(fn):
    """``fn(pkg)`` for each package; the two results must be equal."""
    j, t = fn(PKGS["jax"]), fn(PKGS["torch"])
    assert t == j
    return t


# -- nfa/dewey.py (tests/test_dewey.py) ------------------------------------------


@pytest.mark.parametrize("case", [
    lambda D: str(D(1)),
    lambda D: str(D("1.0.1")),
    lambda D: str(D(1).add_run()),
    lambda D: str(D(1).add_stage().add_run()),
    lambda D: str(D(1).add_stage()),
    lambda D: [D(a).is_compatible(D(b)) for a, b in (
        ("1.0", "2.0"), ("1.0.0", "1.0"), ("1.1", "1.0"), ("1.0", "1.1"), ("1.0", "1.0.0"))],
    lambda D: (D("1.0.1") == D((1, 0, 1)), hash(D("2.3")) == hash(D((2, 3))), len(D("4.0.2"))),
])
def test_dewey_cases_equal_jax(case):
    both(lambda p: case(p["Dewey"]))


def test_dewey_random_versions_equal_jax():
    """Seeded random versions: add_run / add_stage chains and every
    pair's compatibility, equal in both packages."""
    rng = np.random.default_rng(5)
    comps = [tuple(int(c) for c in rng.integers(0, 4, size=rng.integers(1, 5)))
             for _ in range(60)]

    def run(p):
        D = p["Dewey"]
        out = []
        for c in comps:
            v = D(c)
            for op in rng.integers(0, 2, size=3):
                v = v.add_run() if op else v.add_stage()
            out.append(str(v))
        out.append([D(a).is_compatible(D(b)) for a in comps for b in comps])
        return out

    state = rng.bit_generator.state
    j = run(PKGS["jax"])
    rng.bit_generator.state = state
    assert run(PKGS["torch"]) == j
    assert any(j[-1]) and not all(j[-1])


# -- nfa/buffer.py (tests/test_buffer.py) ----------------------------------------


def _buffer_fixture(p):
    E, S, T = p["Event"], p["stages"].Stage, p["stages"].StageType
    evs = [E(f"k{i}", f"v{i}", 1000000001 + i, "topic-test", 0, i) for i in range(5)]
    return evs, S("first", T.BEGIN), S("second", T.NORMAL), S("latest", T.FINAL)


def _one_run(p):
    (e1, e2, e3, _, _), first, second, latest = _buffer_fixture(p)
    D, buf = p["Dewey"], p["Buffer"]()
    buf.put_first(first, e1, D("1"))
    buf.put(second, e2, first, e1, D("1.0"))
    buf.put(latest, e3, second, e2, D("1.0.0"))
    return buf, (first, second, latest), (e1, e2, e3)


def test_buffer_one_run_equals_jax():
    def run(p):
        buf, (_, _, latest), (_, _, e3) = _one_run(p)
        seq = buf.get(latest, e3, p["Dewey"]("1.0.0"))
        return plain(seq), seq.size(), len(buf)

    out = both(run)
    assert out[1] == 3 and out[2] == 3


def test_buffer_branching_run_equals_jax():
    def run(p):
        (e1, e2, e3, e4, e5), first, second, latest = _buffer_fixture(p)
        D, buf = p["Dewey"], p["Buffer"]()
        buf.put_first(first, e1, D("1"))
        buf.put(second, e2, first, e1, D("1.0"))
        buf.put(latest, e3, second, e2, D("1.0.0"))
        buf.put(second, e3, second, e2, D("1.1"))
        buf.put(second, e4, second, e3, D("1.1"))
        buf.put(latest, e5, second, e4, D("1.1.0"))
        s1 = buf.get(latest, e3, D("1.0.0"))
        s2 = buf.get(latest, e5, D("1.1.0"))
        return plain(s1), plain(s2), s2.size()

    assert both(run)[2] == 5


def test_buffer_missing_predecessor_raises_in_both():
    for p in PKGS.values():
        (e1, e2, _, _, _), first, second, _ = _buffer_fixture(p)
        with pytest.raises(RuntimeError, match="cannot find predecessor"):
            p["Buffer"]().put(second, e2, first, e1, p["Dewey"]("1.0"))


def test_buffer_remove_and_branch_equal_jax():
    def run(p):
        buf, (first, second, latest), (e1, e2, e3) = _one_run(p)
        D = p["Dewey"]
        removed = plain(buf.remove(latest, e3, D("1.0.0")))
        gc = len(buf)
        buf2, _, _ = _one_run(p)
        buf2.branch(second, e2, D("1.0"))
        buf2.remove(latest, e3, D("1.0.0"))
        kept = plain(buf2.get(second, e2, D("1.1")))
        refs = sorted((k, e.refs, len(e.preds)) for k, e in buf2.store.items())
        return removed, gc, kept, refs

    out = both(run)
    assert out[1] == 0 and len(out[2]) == 2


# -- nfa/oracle.py (tests/test_oracle_nfa.py) ------------------------------------


def simulate(nfa, events):
    out = []
    for e in events:
        out.extend(nfa.match(e[0], e[1], e[2], topic=e[3], partition=e[4], offset=e[5]))
    return [plain(s) for s in out]


def letters(*vals, t0=NOW):
    return [(None, v, t0, "test", 0, i) for i, v in enumerate(vals)]


def oracle_of(builder, p, **kw):
    return p["Oracle"].from_pattern(builder(p["Q"]), **kw)


@pytest.mark.parametrize("name,vals,n", [
    ("strict3", "ABC", 1),
    ("kleene", "ABCCD", 1),
    ("skip_next", "ABCCD", 1),
    ("skip_any", "ABCCD", 2),
])
def test_nfatest_goldens_equal_jax(name, vals, n):
    codes = {"A": ts.A, "B": ts.B, "C": ts.C, "D": ts.D}
    trace = letters(*(codes[c] for c in vals))
    out = both(lambda p: simulate(oracle_of(ts.SCENARIOS[name][0], p), trace))
    assert len(out) == n


@dataclasses.dataclass(frozen=True)
class StockEvent:
    price: int
    volume: int


def stock_attr(Q):
    """``test_oracle_nfa.py: test_complex_pattern_with_state``'s query,
    over attribute values."""
    return (
        Q().select().where(lambda k, v, ts_, st: v.volume > 1000)
        .fold("avg", lambda k, v, curr: v.price)
        .then().select().zero_or_more().skip_till_next_match()
        .where(lambda k, v, ts_, st: v.price > st.get("avg"))
        .fold("avg", lambda k, v, curr: (curr + v.price) // 2)
        .fold("volume", lambda k, v, curr: v.volume)
        .then().select().skip_till_next_match()
        .where(lambda k, v, ts_, st: v.volume < 0.8 * st.get_or_else("volume", 0))
        .within(1, "h").build()
    )


def test_complex_pattern_with_state_equals_jax():
    trace = [(None, StockEvent(s["price"], s["volume"]), NOW, "test", 0, i)
             for i, s in enumerate(ts.STOCKS)]
    out = both(lambda p: simulate(oracle_of(stock_attr, p), trace))
    assert [{st: [e[5] for e in evs] for st, evs in m} for m in out] == [
        {"2": [5], "1": [4, 3, 2, 1], "0": [0]},
        {"2": [5], "1": [3], "0": [2]},
        {"2": [7], "1": [6, 5, 4, 3, 2, 1], "0": [0]},
        {"2": [7], "1": [5, 3], "0": [2]},
    ]


def ab(Q):
    return Q().select("a").where(ts.value_is(ts.A)).then().select("b").where(
        ts.value_is(ts.B)).build()


def test_independent_instances_equal_jax():
    def run(p):
        n0, n1 = oracle_of(ab, p), oracle_of(ab, p)
        out0 = n0.match(None, ts.A, NOW, offset=0) + n0.match(None, ts.B, NOW + 1, offset=1)
        out1 = n1.match(None, ts.B, NOW, offset=0) + n1.match(None, ts.A, NOW + 1, offset=1)
        return [plain(s) for s in out0], [plain(s) for s in out1]

    out0, out1 = both(run)
    assert len(out0) == 1 and not out1


def skip_first(Q):
    return (Q().select("first").skip_till_next_match().where(ts.value_is(ts.A))
            .then().select("last").where(ts.value_is(ts.B)).build())


def folded_count(Q):
    return (Q().select("a").where(ts.value_is(ts.A)).fold("n", lambda k, v, c: c + 1)
            .then().select("b").where(ts.value_is(ts.B)).build())


def test_run_queue_and_fold_state_equal_jax():
    """The first-stage skip keeps one begin run; dead runs' fold state is
    dropped every event; auto offsets never collide — with the same run
    queue (stage, version, run id) and fold entries in both packages."""
    def run(p):
        nfa = oracle_of(skip_first, p)
        for i in range(50):
            nfa.match(None, ts.X, NOW + i)
        runs = [(r.stage.name, str(r.version), r.seq) for r in nfa.runs]
        got = simulate(nfa, [(None, ts.A, NOW + 100, "test", 0, 100),
                             (None, ts.B, NOW + 101, "test", 0, 101)])
        folds = oracle_of(folded_count, p)
        for i in range(50):
            folds.match(None, ts.A, NOW + 2 * i)
            folds.match(None, ts.X, NOW + 2 * i + 1)
        auto = oracle_of(ts.kleene_one_or_more, p)
        autos = [plain(s) for v in (ts.A, ts.B, ts.C, ts.C, ts.D)
                 for s in auto.match(None, v, NOW)]
        return (runs, got, sorted(folds._agg_state.items()),
                [(r.seq, str(r.version)) for r in folds.runs], autos, auto._offset_counter)

    runs, got, folds, fruns, autos, counter = both(run)
    assert len(runs) == 1 and len(got) == 1
    assert len(folds) <= len(fruns)
    assert len(autos) == 1 and counter == 5


def planted(rng, T: int) -> np.ndarray:
    """A letters trace with planted ``A B C+ [D]`` runs between random
    letters, so every letters scenario matches."""
    out = []
    while len(out) < T:
        if rng.random() < 0.5:
            out += [ts.A, ts.B] + [ts.C] * int(rng.integers(1, 3))
            out += [ts.D] if rng.random() < 0.7 else []
        else:
            out += [int(x) for x in rng.integers(0, 5, size=3)]
    return np.asarray(out[:T], np.int32)


def lane_trace(kind, rng, T: int):
    """One lane's values of a scenario kind, as host scalars."""
    if kind == "letters":
        return [int(v) for v in planted(rng, T)]
    vals = ts.trace(kind, rng, 1, T)
    if isinstance(vals, dict):
        return [{f: c[0, t].item() for f, c in vals.items()} for t in range(T)]
    return [vals[0, t].item() for t in range(T)]


@pytest.mark.parametrize("name", sorted(ts.SCENARIOS))
@pytest.mark.parametrize("enforce", [False, True])
def test_random_traces_equal_jax_oracle(name, enforce):
    """Both oracles on seeded random traces of every scenario (enforced
    windows too): equal match lists, run queues and fold state.  Where the
    reference reaches a state it cannot walk (``buffer.put`` finds no
    predecessor: the float-fold and straddle scenarios), both raise at the
    same event with the same message."""
    builder, kind = ts.SCENARIOS[name]
    rng = np.random.default_rng(17)
    lanes = [lane_trace(kind, rng, 64) for _ in range(2)]

    def run(p):
        out = []
        for lane, vals in enumerate(lanes):
            nfa = oracle_of(builder, p, enforce_windows=enforce)
            try:
                for t, v in enumerate(vals):
                    out.append([plain(s) for s in nfa.match(f"k{lane}", v, 1000 + 3 * t)])
            except RuntimeError as e:
                out.append(("raised", t, str(e)))
            out.append(([(r.stage.name, str(r.version), r.seq, r.start_ts) for r in nfa.runs],
                        sorted(nfa._agg_state.items()), len(nfa.buffer)))
        return out

    out = both(run)
    assert sum(len(m) for m in out if isinstance(m, list)) > 0


# -- the port oracle against the port engine -----------------------------------


ENGINE_CFG = EngineConfig(max_runs=64, slab_entries=128, slab_preds=16, dewey_depth=16,
                          max_walk=16)


@pytest.mark.parametrize("name,T", [("strict3", 64), ("kleene", 64), ("skip_next", 64),
                                    ("skip_any", 20), ("stock", 40)])
def test_port_oracle_equals_port_engine(name, T):
    """Event by event, the port's oracle and its engine on the CPU emit the
    same matches (content and order) on a seeded random trace, with every
    engine counter at 0 (``MatcherSession``, one lane)."""
    builder, kind = ts.SCENARIOS[name]
    vals = lane_trace(kind, np.random.default_rng(29), T)
    oracle = OracleNFA.from_pattern(builder(ts.TQuery))
    session = MatcherSession(TPUMatcher(builder(ts.TQuery), ENGINE_CFG, device="cpu"))
    n = 0
    for t, v in enumerate(vals):
        o = oracle.match(None, v, 1000 + t)
        e = session.match(None, v, 1000 + t)
        assert [ts.canon(s) for s in o] == [ts.canon(s) for s in e], f"event {t}"
        n += len(o)
    assert n > 0
    assert not any(session.counters().values()), session.counters()


def test_port_oracle_equals_port_engine_stock_demo():
    """The stock demo's trace: the four README matches from both."""
    oracle = OracleNFA.from_pattern(ts.stock(ts.TQuery))
    session = MatcherSession(TPUMatcher(ts.stock(ts.TQuery), ENGINE_CFG, device="cpu"))
    o = [ts.canon(s) for i, v in enumerate(ts.STOCKS) for s in oracle.match(None, v, 1000 + i)]
    e = [ts.canon(s) for i, v in enumerate(ts.STOCKS)
         for s in session.match(None, v, 1000 + i)]
    assert o == e and len(o) == 4
