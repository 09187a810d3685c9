"""High-rate ingestion demo: derived capacity + columnar feed + pipelining.

The port's copy of ``examples/highrate_pipeline.py``: the throughput
surface, end to end in one script on the card (``python
examples/torch_highrate_pipeline.py``; ``CEP_PLATFORM=cpu`` for the CPU):

1. **Capacity is derived, not guessed** — ``engine.autosize`` probes a
   sample of the real traffic and returns an :class:`EngineConfig` whose
   capacity counters are zero on it (the reference needs no sizing — its
   stores are heap-backed; this is the array-engine analog).
2. **Columns in, not records** — ``process_columns`` ingests ``[N]``
   arrays with vectorized validation; Event objects materialize lazily,
   only when a match (or the GC) touches them, so match-sparse streams
   never pay per-record Python.
3. **The device never waits for the host** — ``pipeline=True`` returns
   batch N-1's matches from call N, overlapping the scan with packing and
   decode; the decode itself pulls a globally compacted match buffer
   (``ops/decode.py``) instead of the raw ``[K, T, R, W]`` grid.

The pattern is the SASE stock query; the stream is spike-calibrated so
~1% of events complete a match (realistic CEP density).
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from kafkastreams_cep_tpu_torch import Query
from kafkastreams_cep_tpu_torch.engine import EventBatch, autosize
from kafkastreams_cep_tpu_torch.runtime import CEPProcessor

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_stock_demo import default_device  # noqa: E402


def stock_pattern():
    return (
        Query()
        .select("spike").where(lambda k, v, ts, st: v["volume"] > 1000)
        .fold("avg", lambda k, v, curr: v["price"])
        .then()
        .select("rise").zero_or_more().skip_till_next_match()
        .where(lambda k, v, ts, st: v["price"] > st.get("avg"))
        .fold("avg", lambda k, v, curr: (curr + v["price"]) // 2)
        .fold("volume", lambda k, v, curr: v["volume"])
        .then()
        .select("dip").skip_till_next_match()
        .where(lambda k, v, ts, st: v["volume"] < 0.8 * st.get_or_else("volume", 0))
        .build()
    )


def make_columns(rng, n, keys):
    return (
        rng.integers(0, keys, size=n),
        {
            "price": rng.integers(90, 131, size=n),
            "volume": np.where(
                rng.random(n) < 0.005, 1100, rng.integers(700, 1000, size=n)
            ),
        },
    )


def main(device=None):
    device = device or default_device()
    K = int(os.environ.get("HIGHRATE_LANES", "128"))
    BATCH = int(os.environ.get("HIGHRATE_BATCH", "2048"))
    N_BATCHES = int(os.environ.get("HIGHRATE_BATCHES", "4"))
    rng = np.random.default_rng(7)

    # 1. Derive the capacity config from a probe of sample traffic.
    skeys, svals = make_columns(rng, 4 * BATCH, K)
    T_s = 4 * BATCH // K
    steps = torch.arange(T_s, dtype=torch.int32)[None].expand(K, T_s).contiguous()
    sample = EventBatch(
        key=torch.as_tensor(skeys.reshape(T_s, K).T.astype(np.int32)),
        value={
            n: torch.as_tensor(v.reshape(T_s, K).T.astype(np.int32))
            for n, v in svals.items()
        },
        ts=steps,
        off=steps.clone(),
        valid=torch.ones((K, T_s), dtype=torch.bool),
    )
    cfg = autosize(stock_pattern(), sample, sweep_every=64, device=device)
    print(f"derived config: {cfg}")

    # 2 + 3. Pipelined processor fed columns.
    proc = CEPProcessor(stock_pattern(), K, cfg, epoch=0, pipeline=True, device=device)
    total = 0
    matches = 0
    for b in range(N_BATCHES):
        keys, vals = make_columns(rng, BATCH, K)
        ts = np.int64(b) * BATCH + np.arange(BATCH, dtype=np.int64)
        out = proc.process_columns(keys, vals, ts)
        matches += len(out)
        total += BATCH
    matches += len(proc.flush())

    snap = proc.metrics_snapshot()
    print(
        f"{total} events through {N_BATCHES} pipelined batches: "
        f"{matches} matches, counters zero="
        f"{all(snap[c] == 0 for c in ('run_drops', 'slab_full_drops', 'slab_pred_drops', 'slab_trunc'))}, "
        f"decode_fallbacks={snap['decode_fallbacks']}"
    )
    for key, seq in (out or [])[:3]:
        print(f"  e.g. key {key}: {seq.as_map()}")
    assert matches > 0, "the spike trace must produce matches"
    print("highrate pipeline: OK")


if __name__ == "__main__":
    main()
