"""The plain reference (``portbench/reference/``, a frozen copy of the
port's oracle) reproduces the reference evaluator's NFATest scenarios and
the stock demo's four README lines."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import query
from portbench.reference.oracle import OracleNFA
from portbench.reference.query import Query

A, B, C, D = 0, 1, 2, 3
CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def is_(code):
    return lambda k, v, ts, st: v == code


def strict3():
    return (Query().select("first").where(is_(A)).then().select("second").where(is_(B))
            .then().select("latest").where(is_(C)).build())


def kleene():
    return (Query().select("firstStage").where(is_(A)).then().select("secondStage").where(is_(B))
            .then().select("thirdStage").one_or_more().where(is_(C))
            .then().select("latestState").where(is_(D)).build())


def skip_next():
    return (Query().select("first").where(is_(A))
            .then().select("second").skip_till_next_match().where(is_(C))
            .then().select("latest").skip_till_next_match().where(is_(D)).build())


def skip_any():
    return (Query().select("first").where(is_(A))
            .then().select("second").skip_till_any_match().where(is_(C))
            .then().select("latest").skip_till_any_match().where(is_(D)).build())


def run(pattern, values):
    nfa = OracleNFA.from_pattern(pattern)
    out = []
    for i, v in enumerate(values):
        out += nfa.match(None, v, 1_000_000 + i, offset=i)
    return [{s: [e.offset for e in evs] for s, evs in m.as_map().items()} for m in out]


@pytest.mark.parametrize("build,trace,want", [
    # NFATest.java:42-67, 69-101, 104-132, 134-172.
    (strict3, "ABC", [{"latest": [2], "second": [1], "first": [0]}]),
    (kleene, "ABCCD", [{"latestState": [4], "thirdStage": [3, 2], "secondStage": [1],
                        "firstStage": [0]}]),
    (skip_next, "ABCCD", [{"latest": [4], "second": [2], "first": [0]}]),
    (skip_any, "ABCCD", [{"latest": [4], "second": [2], "first": [0]},
                         {"latest": [4], "second": [3], "first": [0]}]),
])
def test_nfatest_scenarios(build, trace, want):
    got = run(build(), ["ABCD".index(c) for c in trace])
    assert sorted(map(json.dumps, got)) == sorted(map(json.dumps, want))


STOCK = [(100, 1010), (120, 990), (120, 1005), (121, 999), (120, 999), (125, 750), (120, 950),
         (120, 700)]
README = [
    '{"0":["e1"],"1":["e2","e3","e4","e5"],"2":["e6"]}',
    '{"0":["e3"],"1":["e4"],"2":["e6"]}',
    '{"0":["e1"],"1":["e2","e3","e4","e5","e6","e7"],"2":["e8"]}',
    '{"0":["e3"],"1":["e4","e6"],"2":["e8"]}',
]


@pytest.mark.parametrize("config", ["stock", "stock-lazy"])
def test_stock_demo_readme_lines(config):
    """The configuration's own query (its file, built by ``query.build``)
    gives the demo's four lines (README.md:93-96) on its 8-event trace."""
    spec = json.loads((CONFIGS / f"{config}.json").read_text())["query"]
    nfa = OracleNFA.from_pattern(query.build(spec, Query))
    lines = []
    for i, (price, volume) in enumerate(STOCK):
        for m in nfa.match("stocks", {"price": price, "volume": volume}, 1000 + i, offset=i):
            obj = {s: [f"e{e.offset + 1}" for e in reversed(evs)]
                   for s, evs in reversed(list(m.as_map().items()))}
            lines.append(json.dumps(obj, separators=(",", ":")))
    assert lines == README


def test_reference_stops_where_the_evaluator_fails():
    """Where a pruned run's removal has deleted an entry that a sibling
    still points at, the reference evaluator fails, and the reference cuts
    the key there: on this key's stream round 48's match removes entry 40,
    and round 49's walk meets it."""
    from portbench import check, harness
    from portbench.traffic import generator

    cell = harness.load_cell("stock.ticks")
    tr = generator.Traffic(cell.mix, 1024, 3000000777)
    pos = int(np.flatnonzero(tr.key_ids == 1000031)[0])
    ref, cut = check.reference(cell.config, tr, [pos], 52, "ticks")
    rounds = [[[(t - generator.T0_MS) // tr.tick_ms for t, _ in evs] for _, evs in m]
              for _, _, m in ref]
    assert rounds[-1] == [[48], [45, 40, 37], [34]]
    assert cut == {1000031: int(tr.round_ts(49))}
