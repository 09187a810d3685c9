"""The SASE stock demo, end to end through the PyTorch/CUDA port.

The port's copy of ``examples/stock_demo.py``: the paper's stock query
(``demo/CEPStockKStreamsDemo.java:25-103``) over the reference README's
8-event trace, printing the same 4 JSON match lines byte for byte.

Run: ``python examples/torch_stock_demo.py`` on a machine with a GPU (the
engine runs on ``cuda``); ``CEP_PLATFORM=cpu`` (the JAX examples' switch)
runs the plain PyTorch path on the CPU instead.  ``--stdin`` reads the
README's JSON lines from standard input.
"""

import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kafkastreams_cep_tpu_torch import Query
from kafkastreams_cep_tpu_torch.engine import EngineConfig
from kafkastreams_cep_tpu_torch.runtime import CEPProcessor, Record


def default_device() -> str:
    """Where the examples run: the card, unless ``CEP_PLATFORM=cpu`` asks
    for the CPU."""
    return "cpu" if os.environ.get("CEP_PLATFORM", "").lower() == "cpu" else "cuda"

STOCK_EVENTS = [
    {"name": "e1", "price": 100, "volume": 1010},
    {"name": "e2", "price": 120, "volume": 990},
    {"name": "e3", "price": 120, "volume": 1005},
    {"name": "e4", "price": 121, "volume": 999},
    {"name": "e5", "price": 120, "volume": 999},
    {"name": "e6", "price": 125, "volume": 750},
    {"name": "e7", "price": 120, "volume": 950},
    {"name": "e8", "price": 120, "volume": 700},
]


def stock_pattern():
    """The demo query (``CEPStockKStreamsDemo.java:37-53``)."""
    return (
        Query()
        .select()
        .where(lambda k, v, ts, st: v["volume"] > 1000)
        .fold("avg", lambda k, v, curr: v["price"])
        .then()
        .select()
        .zero_or_more()
        .skip_till_next_match()
        .where(lambda k, v, ts, st: v["price"] > st.get("avg"))
        .fold("avg", lambda k, v, curr: (curr + v["price"]) // 2)
        .fold("volume", lambda k, v, curr: v["volume"])
        .then()
        .select()
        .skip_till_next_match()
        .where(lambda k, v, ts, st: v["volume"] < 0.8 * st.get_or_else("volume", 0))
        .within(1, "h")
        .build()
    )


def format_match(seq, name_of) -> str:
    """One match -> the demo's JSON line: stages first->last, events in
    arrival order (the demo reverses the backward-walk order,
    ``CEPStockKStreamsDemo.java:60-69``)."""
    obj = {}
    for stage, events in reversed(list(seq.as_map().items())):
        obj[stage] = [name_of[e.offset] for e in reversed(events)]
    return json.dumps(obj, separators=(",", ":"))


def make_processor(device=None) -> CEPProcessor:
    """The demo's processor: 1 lane, capacity sized for the 8-event trace."""
    return CEPProcessor(
        stock_pattern(),
        num_lanes=1,
        config=EngineConfig(
            max_runs=32, slab_entries=64, slab_preds=8, dewey_depth=16,
            max_walk=16,
        ),
        topic="StockEvents",
        device=device or default_device(),
    )


def run(processor=None, device=None):
    """Feed the trace; return the JSON lines (shared with the tests)."""
    proc = processor or make_processor(device)
    name_of = {i: ev["name"] for i, ev in enumerate(STOCK_EVENTS)}
    records = [
        Record("stocks", {"price": ev["price"], "volume": ev["volume"]}, 1000 + i)
        for i, ev in enumerate(STOCK_EVENTS)
    ]
    lines = []
    for key, seq in proc.process(records):
        lines.append(format_match(seq, name_of))
    counters = proc.counters()
    assert all(v == 0 for v in counters.values()), counters
    return lines


EXPECTED = [
    '{"0":["e1"],"1":["e2","e3","e4","e5"],"2":["e6"]}',
    '{"0":["e3"],"1":["e4"],"2":["e6"]}',
    '{"0":["e1"],"1":["e2","e3","e4","e5","e6","e7"],"2":["e8"]}',
    '{"0":["e3"],"1":["e4","e6"],"2":["e8"]}',
]


def run_stdin(device=None):
    """Console-producer mode: JSON lines ``{"name","price","volume"}`` on
    stdin (the README's input format, README.md:72-81), match JSON lines on
    stdout — the full Kafka topic->topic demo loop without a broker.

    Parsing goes through the native C++ fast path
    (``native.parse_json_lines``) in micro-batches, with the full JSON
    serde as the per-line fallback — the production ingest shape.
    """
    from kafkastreams_cep_tpu_torch import native
    from kafkastreams_cep_tpu_torch.utils.serde import json_serde

    serde = json_serde()
    proc = make_processor(device)
    name_of = {}
    i = 0
    chunk: list = []

    def flush_chunk():
        nonlocal i
        if not chunk:
            return
        text = "\n".join(chunk).encode()
        values, keys, ok = native.parse_json_lines(
            text, ["price", "volume"], key_field="name"
        )
        records = []
        for j, raw in enumerate(chunk):
            if ok[j]:
                name, price, volume = keys[j], values[j, 0], values[j, 1]
            else:  # fast path rejected the line — full JSON fallback
                ev = serde.deserialize(raw.encode())
                name, price, volume = ev["name"], ev["price"], ev["volume"]
            name_of[i] = name
            # Preserve the JSON number type: integral -> int (the demo's
            # schema), fractional -> float.
            price = int(price) if float(price).is_integer() else float(price)
            volume = (
                int(volume) if float(volume).is_integer() else float(volume)
            )
            records.append(
                Record("stocks", {"price": price, "volume": volume}, 1000 + i)
            )
            i += 1
        for _, seq in proc.process(records):
            print(format_match(seq, name_of), flush=True)
        chunk.clear()

    # Interactive console producers need per-line matches; piped input
    # micro-batches for throughput.
    batch_size = 1 if sys.stdin.isatty() else 64
    for raw in sys.stdin:
        raw = raw.strip()
        if not raw:
            continue
        chunk.append(raw)
        if len(chunk) >= batch_size:
            flush_chunk()
    flush_chunk()


def main(device=None) -> bool:
    """Print the demo's match lines; True when they are the README's."""
    lines = run(device=device)
    for line in lines:
        print(line)
    ok = lines == EXPECTED
    print("README parity:", "OK" if ok else "MISMATCH", file=sys.stderr)
    return ok


if __name__ == "__main__":
    if "--stdin" in sys.argv:
        run_stdin()
        sys.exit(0)
    sys.exit(0 if main() else 1)
