"""Readings that set the check's limits: the program's sound runs and the
control's, on the card at the cell's own size, many seeds in one process.

    python3 portbench/control.py --workload stock.ticks --seeds 1,2,3 --seconds 8 [--control]

Each seed is one run of ``harness.run_cell`` (set-up, window, check) with a
fresh processor; ``--control`` runs the control instead: the program with
its window pruning off (``enforce_windows=False``), its own path that
breaks the configuration's window guarantee, checked against the same
reference.  ``--engine`` and ``--processor`` override the program's
settings for other readings (the reference keeps the configuration's).
A workload that ``BENCHMARK.json`` does not list, ``<config>.<traffic>``,
is built here from its two files, on one chip (the lazy path's repro,
``stock-lazy.ticks``).  One JSON line a seed.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: The control's engine fields: window pruning off.
CONTROL = {"enforce_windows": False}


def cell_of(name: str):
    """The listed cell ``name``, or one built from ``configs/<config>.json``
    and ``traffic/<traffic>.json`` with the benchmark's end-to-end metrics."""
    from portbench import harness
    from portbench.traffic import generator

    bench = json.loads(harness.BENCHMARK.read_text())
    if name in {w["name"] for w in bench["workloads"]}:
        return harness.load_cell(name)
    config, _, traffic = name.rpartition(".")
    return harness.Cell(
        name=name,
        config=json.loads((harness.HERE / "configs" / f"{config}.json").read_text()),
        mix=generator.load(traffic), traffic=traffic, chips=1,
        end_to_end=bench["end_to_end"], per_layer=[])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--engine", default="{}", help="engine fields to override (JSON)")
    ap.add_argument("--processor", default="{}", help="processor settings to override (JSON)")
    args = ap.parse_args(argv)

    from portbench import harness

    cell = cell_of(args.workload)
    engine = dict(json.loads(args.engine), **(CONTROL if args.control else {}))
    processor = json.loads(args.processor)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(cell, seed, args.seconds, engine=engine, processor=processor)
        print(json.dumps({
            "workload": cell.name, "seed": seed, "control": args.control,
            "engine": engine, "processor": processor,
            "correct": res["correct"], "checks": res["checks"],
            "matches_checked": res["matches_checked"], "attempted": res["attempted"],
            "metrics": res["metrics"],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
