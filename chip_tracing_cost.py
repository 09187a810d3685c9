"""The processor's tracing cost on one cell and seed: the end-to-end numbers
and the host phases and child spans a batch over the measured window, with
no trace sink, with an ``InMemoryTraceSink``, and in a traced run (whose
per-layer metrics read the untraced batches); and the card clock
(``device_seconds`` a batch) beside the traced busy time and wall.

    python3 chip_tracing_cost.py --seed 3000000904 --seconds 51 \\
        --modes none,sink,trace > cost.jsonl

One JSON line a mode.  Runs on the card; ``--device cpu --keys 32``
rehearses it on the CPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from portbench import harness, run
from kafkastreams_cep_tpu_torch.utils.telemetry import InMemoryTraceSink


def phase_state(proc) -> dict:
    """The processor's phase seconds, card seconds, batches and child
    spans' seconds and counts."""
    out = {p: float(getattr(proc.metrics, p)) for p in harness.PHASES}
    out["device_seconds"] = float(proc.metrics.device_seconds)
    out["batches"] = int(proc.metrics.batches)
    for name, h in proc.metrics.layers()["spans"].items():
        out[f"span {name}"] = h["sum"]
        out[f"n {name}"] = h["count"]
    return out


def measure(cell, mode: str, seed: int, seconds: float, device: str, keys) -> dict:
    pc = cell.config["processor"]
    warm = 1 + max(int(cell.mix["warmup_batches"]), int(pc.get("drain_interval", 1)),
                   int(pc.get("gc_interval", 16)), int(pc.get("gc_events_interval", 8)))
    held = {}

    def hook(proc):
        # The window starts at the harness's first call after its warm-up.
        held["proc"] = proc
        orig, calls = proc.process_columns, [0]

        def counted(*args):
            if calls[0] == warm:
                held["t0"] = phase_state(proc)
            calls[0] += 1
            return orig(*args)

        proc.process_columns = counted

    processor = {"trace_sink": InMemoryTraceSink()} if mode == "sink" else None
    res = harness.run_cell(cell, seed, seconds, trace=(mode == "trace"), device=device,
                           keys=keys, processor=processor, hook=hook)
    proc = held["proc"]
    t1 = phase_state(proc)
    d = {k: t1[k] - held["t0"][k] for k in t1}
    n = d["batches"]
    out = {
        "mode": mode, "seed": seed, "correct": res["correct"], "window_batches": n,
        "metrics": {k: v["value"] for k, v in res["metrics"].items()},
        "window_ms_a_batch": {k: v / n * 1e3 for k, v in d.items()
                              if k != "batches" and not k.startswith("n ")},
        "window_span_counts": {k[2:]: v for k, v in d.items() if k.startswith("n ")},
        "counters": proc.metrics.layers()["counters"],
        "device_seconds_a_batch": t1["device_seconds"] / t1["batches"],
        "device": res["device"],
    }
    if mode == "trace":
        batches = int(cell.mix["trace_batches"])
        out["busy_a_traced_batch"] = res["device"]["busy_s"] / batches
        out["wall_a_traced_batch"] = res["device"]["window_s"] / batches
        out["line"] = run.result_line(res)
    if mode == "sink":
        out["sink_events"] = len(processor["trace_sink"].events)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="stock.ticks")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--modes", default="none,sink,trace")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--keys", type=int, default=None)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for mode in args.modes.split(","):
        if mode not in ("none", "sink", "trace"):
            ap.error(f"unknown mode {mode!r}")
        print(json.dumps(measure(cell, mode, args.seed, args.seconds, args.device,
                                 args.keys)), flush=True)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
