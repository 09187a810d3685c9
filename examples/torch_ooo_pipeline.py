"""Graceful-ingestion demo: out-of-order absorption + dead-lettering.

The port's copy of ``examples/ooo_pipeline.py``.  Real streams are
disordered in event time and occasionally poisoned per record; the
reference absorbs both at the Kafka layer.  This script runs the runtime's
front-door analog end to end on the card (``python
examples/torch_ooo_pipeline.py``; ``CEP_PLATFORM=cpu`` for the CPU):

1. a stock stream whose arrival order is shuffled with bounded timestamp
   skew, fed through the watermark reorder buffer
   (:class:`IngestPolicy` — records held until ``max_seen - grace_ms``
   passes them, released in timestamp order);
2. poisoned records mixed in (wrong schema, impossible timestamps, a
   too-late straggler) — each diverted to the dead-letter queue with a
   typed reason while the rest of its batch proceeds;
3. the loss-counter contract printed at the end: the in-order and
   shuffled runs emit identical matches, and ``late_dropped`` /
   ``quarantined`` / ``reorder_evictions`` tell you exactly what (if
   anything) the guard had to shed.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from kafkastreams_cep_tpu_torch.engine import EngineConfig
from kafkastreams_cep_tpu_torch.runtime import CEPProcessor, IngestPolicy, Record

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_stock_demo import default_device, stock_pattern  # noqa: E402

GRACE_MS = 40
CONFIG = EngineConfig(
    max_runs=24, slab_entries=48, slab_preds=8, dewey_depth=12, max_walk=12
)


def make_stream(n=400, seed=11):
    """A 4-symbol stock stream with distinct event times."""
    rng = np.random.default_rng(seed)
    symbols = ("AAPL", "GOOG", "MSFT", "AMZN")
    recs = []
    for i in range(n):
        recs.append(
            Record(
                symbols[int(rng.integers(len(symbols)))],
                {
                    "price": int(rng.integers(90, 131)),
                    "volume": int(
                        1100 if rng.random() < 0.02
                        else rng.integers(600, 1000)
                    ),
                },
                2 * i,  # event time, ms
            )
        )
    return recs


def bounded_shuffle(records, skew_ms, seed=3):
    """Shuffle arrival so timestamp inversions stay <= skew_ms."""
    rng = np.random.default_rng(seed)
    key = [r.timestamp + rng.uniform(0, skew_ms) for r in records]
    return [records[i] for i in np.argsort(key, kind="stable")]


def poison(records):
    """Sprinkle in records a real deployment would see."""
    out = list(records)
    out.insert(50, Record("AAPL", {"price": 100}, 101))       # schema
    out.insert(90, Record("AAPL", out[0].value, 10**15))      # time range
    out.insert(130, Record("GOOG", out[0].value, 0))          # too late
    return out


def run(records, label, device=None):
    proc = CEPProcessor(
        stock_pattern(), 4, CONFIG, epoch=0, gc_interval=0,
        ingest=IngestPolicy(grace_ms=GRACE_MS), device=device or default_device(),
    )
    matches = []
    for i in range(0, len(records), 40):
        matches += proc.process(records[i:i + 40])
    matches += proc.drain_ingest()  # end of stream: release the buffer
    matches += proc.flush()
    guard = proc._guard
    print(f"\n== {label} ==")
    print(f"matches emitted : {len(matches)}")
    print(f"loss counters   : {guard.loss_counters()}  (all-zero => loss-free)")
    print(f"held at drain   : 0 (drained), watermark {guard.watermark} ms")
    for d in guard.dead_letters:
        print(
            f"dead letter     : reason={d.reason!r} corr={d.corr} "
            f"key={d.record.key!r} ts={d.record.timestamp}"
        )
    return matches


def main(device=None, n=400):
    stream = make_stream(n)

    clean = run(stream, "in-order, clean", device)
    shuffled = run(
        bounded_shuffle(stream, GRACE_MS), f"shuffled (skew <= {GRACE_MS} ms)", device
    )

    def canon(matches):
        # Key + per-stage (offset, timestamp) lists: everything about a
        # match except the lane number, which — like a Kafka partition
        # assignment — follows key *arrival* order and is the one thing a
        # shuffle may legitimately permute.
        return [
            (k, {
                st: [(e.offset, e.timestamp) for e in ev]
                for st, ev in s.as_map().items()
            })
            for k, s in matches
        ]

    assert canon(clean) == canon(shuffled), (
        "bounded-skew shuffle must be bit-identical to the in-order run"
    )
    print(
        f"\nbounded-skew shuffle absorbed: {len(shuffled)} matches "
        "bit-identical to the in-order run"
    )

    run(poison(bounded_shuffle(stream, GRACE_MS)), "shuffled + poisoned", device)
    print(
        "\npoisoned records were quarantined per record with typed "
        "reasons; the batches they rode in still processed"
    )


if __name__ == "__main__":
    main()
