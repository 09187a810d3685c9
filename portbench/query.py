"""A configuration's query, kept as data, built with a given ``Query`` DSL.

The configuration file states the query stage by stage: its name,
cardinality, selection strategy, predicate, folds and window, the
predicate and fold bodies as Python expressions over ``k, v, ts, st`` and
``k, v, curr``.  :func:`build` turns them into a pattern with whichever
``Query`` class it is handed: the program's, for the run, and the
reference's own copy (``reference/query.py``), for the check, so both sides
get the same query from the same file.
"""

from __future__ import annotations

from typing import Any, Dict

_NO_BUILTINS = {"__builtins__": {}}


def _fn(args: str, expr: str):
    return eval(f"lambda {args}: ({expr})", dict(_NO_BUILTINS))  # noqa: S307 - the config's own text


def build(spec: Dict[str, Any], Query):
    """The pattern of ``spec["stages"]`` in ``Query``'s DSL."""
    q, pb = Query(), None
    for st in spec["stages"]:
        sel = q.select(st.get("name"))
        card = st.get("cardinality", "one")
        if card != "one":
            sel = getattr(sel, card)()
        if "strategy" in st:
            sel = getattr(sel, st["strategy"])()
        pb = sel.where(_fn("k, v, ts, st", st["where"]))
        for fold in st.get("folds", []):
            pb = pb.fold(fold["state"], _fn("k, v, curr", fold["expr"]), fold.get("init", 0))
        if "within" in st:
            pb = pb.within(*st["within"])
        q = pb.then()
    return pb.build()
