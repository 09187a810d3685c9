"""Find a configuration's capacity on the card, once, when a cell is defined.

    python3 portbench/calibrate.py --config stock --traffic ticks --seed <n> --rounds <T> [--hold-depth]

Runs the port's ``engine/sizing.py`` on the cell's own seeded traffic: the
first ``T`` rounds of every key as one ``[K, T]`` sample, probed at the
configuration's sweep cadence (``gc_interval`` batches), or under lazy
extraction at its drain cadence (``drain_interval`` batches).  By default
``autosize`` from ``--start`` (its own default, R=16 and E=64, does not fit
the card's memory at 131,072 keys) with the configuration's other fields.
``--hold-depth`` is for a stream on which no ``dewey_depth`` stops
``ver_overflows`` (``check.py``), where ``autosize`` would double the depth
until it gives up: it probes the configuration's own capacity, with its
depth held, and prints ``suggest`` from that probe, which is what the file
holds once its other counters read 0.  Prints the config reached and the
probe report; the capacity fields go into the configuration file by hand,
with the output in ``PERF.md``.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CAPACITY = ("max_runs", "slab_entries", "slab_hot_entries", "slab_preds", "dewey_depth",
            "max_walk", "handle_ring")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, required=True)
    ap.add_argument("--keys", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--processor", default="{}", help="processor settings to override (JSON)")
    ap.add_argument("--hold-depth", action="store_true",
                    help="probe the configuration's own capacity and print suggest from it, "
                         "dewey_depth held")
    ap.add_argument("--start", default="8,32,8,32,16",
                    help="autosize's start: max_runs,slab_entries,slab_preds,dewey_depth,max_walk")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    import numpy as np
    import torch

    from kafkastreams_cep_tpu_torch.compiler.tables import lower
    from kafkastreams_cep_tpu_torch.engine.matcher import EngineConfig, EventBatch
    from kafkastreams_cep_tpu_torch.engine.sizing import autosize, probe, suggest
    from kafkastreams_cep_tpu_torch.pattern.query import Query
    from portbench import harness, query
    from portbench.traffic import generator

    config = json.loads((harness.ROOT / "portbench" / "configs" / f"{args.config}.json").read_text())
    K = args.keys or int(config["keys"])
    tr = generator.Traffic(generator.load(args.traffic), K, args.seed)
    T = args.rounds
    price, volume = tr.values(0, T)
    i32 = torch.int32
    ev = EventBatch(
        key=torch.as_tensor(tr.key_ids.astype(np.int32))[:, None].expand(K, T).contiguous(),
        value={"price": torch.as_tensor(price.T.astype(np.int32).copy()),
               "volume": torch.as_tensor(volume.T.astype(np.int32).copy())},
        ts=(torch.arange(T, dtype=i32) * tr.tick_ms)[None].expand(K, T).contiguous(),
        off=torch.arange(T, dtype=i32)[None].expand(K, T).contiguous(),
        valid=torch.ones((K, T), dtype=torch.bool),
    )
    eng = config["engine"]
    R, E, MP, D, W = (int(x) for x in args.start.split(","))
    base = EngineConfig(max_runs=R, slab_entries=E, slab_preds=MP, dewey_depth=D, max_walk=W)
    start = dataclasses.replace(
        base, **{k: v for k, v in eng.items() if k not in CAPACITY},
        slab_hot_entries=eng.get("slab_hot_entries", 0))
    pc = {**config["processor"], **json.loads(args.processor)}
    batches = pc["drain_interval"] if eng.get("lazy_extraction") else pc["gc_interval"]
    every = tr.tpb * int(batches)
    pattern = query.build(config["query"], Query)
    t0 = time.perf_counter()
    if args.hold_depth:
        own = dataclasses.replace(start, **{k: v for k, v in eng.items() if k in CAPACITY})
        held = probe(pattern, ev, own, every, args.device)
        found = dataclasses.replace(suggest(lower(pattern), held), dewey_depth=own.dewey_depth)
    else:
        found = autosize(pattern, ev, start=start, sweep_every=every, device=args.device)
    took = time.perf_counter() - t0
    # The configuration's hot tier (0: one tier), kept strictly below the slab.
    EH = int(eng.get("slab_hot_entries", 0))
    found = dataclasses.replace(found, slab_hot_entries=EH,
                                slab_entries=max(found.slab_entries, EH + 8 if EH else 0))
    rep = probe(pattern, ev, found, every, args.device)
    out = {
        "config": args.config, "keys": K, "rounds": T, "seed": args.seed,
        "sweep_every": every, "autosize_s": round(took, 3),
        "found": {k: getattr(found, k) for k in CAPACITY},
        "probe": {"counters": rep.counters, "max_alive_runs": rep.max_alive_runs,
                  "max_live_entries": rep.max_live_entries, "max_npreds": rep.max_npreds,
                  "max_vlen": rep.max_vlen, "max_match_len": rep.max_match_len,
                  "max_matches_chunk": rep.max_matches_chunk},
        "device": torch.cuda.get_device_name() if args.device.startswith("cuda") else "cpu",
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
