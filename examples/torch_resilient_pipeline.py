"""Operational demo: a supervised multi-query CEP pipeline with durable
crash recovery.

The port's copy of ``examples/resilient_pipeline.py``: everything the
reference delegates to Kafka Streams, end to end in one script on the card
(``python examples/torch_resilient_pipeline.py``; ``CEP_PLATFORM=cpu`` for
the CPU):

1. two queries over one stock stream (the NFA-bank shape — one processor
   per query, like wiring two ``CEPProcessor`` instances onto one topic);
2. each wrapped in a :class:`Supervisor` with periodic checkpoints and a
   durable CRC-framed record journal (C++ write path when available);
3. a simulated hard process crash mid-stream, recovered with
   ``Supervisor.resume`` — state restored from snapshot + journal replay,
   then the stream continues with no lost or duplicated matches.
"""

import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from kafkastreams_cep_tpu_torch import Query
from kafkastreams_cep_tpu_torch.engine import EngineConfig
from kafkastreams_cep_tpu_torch.runtime import Record
from kafkastreams_cep_tpu_torch.runtime.supervisor import Supervisor

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_stock_demo import default_device  # noqa: E402


def spike_query():
    return (
        Query()
        .select("spike").where(lambda k, v, ts, st: v["volume"] > 1000)
        .then()
        .select("drop").skip_till_next_match()
        .where(lambda k, v, ts, st: v["price"] < 100)
        .build()
    )


def rally_query():
    return (
        Query()
        .select("low").where(lambda k, v, ts, st: v["price"] < 95)
        .then()
        .select("high").skip_till_next_match()
        .where(lambda k, v, ts, st: v["price"] > 115)
        .build()
    )


QUERIES = {"spike-then-drop": spike_query, "rally": rally_query}
CFG = EngineConfig(max_runs=16, slab_entries=32, slab_preds=4, dewey_depth=8,
                   max_walk=8)


def make_supervisors(workdir, resume=False, device=None):
    sups = {}
    device = device or default_device()
    for name, q in QUERIES.items():
        paths = dict(
            checkpoint_path=os.path.join(workdir, f"{name}.ckpt"),
            journal_path=os.path.join(workdir, f"{name}.jnl"),
        )
        if resume:
            sups[name] = Supervisor.resume(
                q(), num_lanes=4, config=CFG, checkpoint_every=4, device=device,
                **paths
            )
        else:
            sups[name] = Supervisor(
                q(), num_lanes=4, config=CFG, checkpoint_every=4, device=device,
                **paths
            )
    return sups


def batches(rng, n_batches, start=0):
    keys = ["AAPL", "MSFT", "GOOG", "AMZN"]
    for b in range(n_batches):
        yield [
            Record(
                keys[int(rng.integers(0, len(keys)))],
                {
                    "price": int(rng.integers(85, 125)),
                    "volume": int(rng.integers(800, 1200)),
                },
                1_000 + (start + b) * 10 + i,
            )
            for i in range(8)
        ]


def main(device=None):
    workdir = tempfile.mkdtemp(prefix="cep_pipeline_")
    rng = np.random.default_rng(7)
    sups = make_supervisors(workdir, device=device)

    emitted = []
    for i, batch in enumerate(batches(rng, 10)):
        for name, sup in sups.items():
            for key, seq in sup.process(batch):
                emitted.append((name, key, sorted(seq.as_map().items())))
    print(f"phase 1: {len(emitted)} matches from 10 batches")
    for name, sup in sups.items():
        h = sup.health()
        print(f"  {name}: healthy={h.healthy} "
              f"metrics={sup.metrics_snapshot()['matches_out']} matches")

    # --- simulated hard crash: all in-process state is dropped -------------
    del sups
    print("crash! resuming from checkpoints + journals ...")
    sups = make_supervisors(workdir, resume=True, device=device)

    more = []
    for batch in batches(rng, 5, start=10):
        for name, sup in sups.items():
            for key, seq in sup.process(batch):
                more.append((name, key, sorted(seq.as_map().items())))
    print(f"phase 2 (post-recovery): {len(more)} further matches")
    for name, sup in sups.items():
        print(f"  {name}: recoveries={sup.recoveries}, "
              f"checkpoints={sup.checkpoints}")
    print("OK")


if __name__ == "__main__":
    main()
