"""One run of one cell: set-up, the measured window, the traced batches, the
check, and the result line's numbers.

The window drives the system under test as a client would: the port's
``CEPProcessor.process_columns`` with ``pipeline=True`` (the card works on
batch N while the host decodes batch N-1), closed loop (the next batch goes
in when the call returns), ending in ``flush()`` and a synchronize.  Every
match the calls hand back is read by the client: its completing event says
which batch it belongs to, and the client keeps those of a seeded draw of
keys (``kept_keys``), among which the check draws its keys once the window
has closed.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration file (``configs/``) and traffic mix (``traffic/``),
and each per-layer metric is read by ``metrics/<name>.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from portbench import check, query
from portbench.traffic import generator

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    mix: Dict[str, Any]
    traffic: str
    chips: int
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_cell(name: str, bench_path: Path = BENCHMARK) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its files read."""
    bench = json.loads(Path(bench_path).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {Path(bench_path).name} (has {sorted(cells)})")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(
        name=name,
        config=json.loads((ROOT / conf["file"]).read_text()),
        mix=generator.load(w["traffic"]),
        traffic=w["traffic"],
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)],
    )


def build_processor(config: Dict, keys: int, device: str, engine: Optional[Dict] = None,
                    processor: Optional[Dict] = None):
    """The configuration's processor on ``device``: its query, its
    ``EngineConfig`` and its processor settings (``engine`` and
    ``processor`` override fields, for the control and other readings)."""
    from kafkastreams_cep_tpu_torch.engine.matcher import EngineConfig
    from kafkastreams_cep_tpu_torch.pattern.query import Query
    from kafkastreams_cep_tpu_torch.runtime.processor import CEPProcessor

    pattern = query.build(config["query"], Query)
    cfg = EngineConfig(**{**config["engine"], **(engine or {})})
    return CEPProcessor(pattern, keys, cfg, device=device,
                        **{**config["processor"], **(processor or {})})


class Client:
    """The closed-loop client: hands batches in, reads what comes back."""

    def __init__(self, proc, traffic, kept_keys, rf):
        self.proc = proc
        self.traffic = traffic
        self.kept_keys = set(int(k) for k in kept_keys)
        self.rf = rf  # record_function, or a null context
        # One entry a call: (start, return, the batches whose matches came back).
        self.calls: List[tuple] = []
        self.kept: List[tuple] = []  # (key, match) of the kept keys, as handed back
        self.matches = 0

    def _read(self, matches, t0: float) -> None:
        t1 = time.perf_counter()
        with self.rf("client.read"):
            batch_of, keep = self.traffic.batch_of_ts, self.kept_keys
            covered = set()
            for key, seq in matches:
                # The completing event: the final stage's newest, listed first.
                covered.add(batch_of(next(iter(seq.as_map().values()))[0].timestamp))
                if key in keep:
                    self.kept.append((key, seq))
            self.matches += len(matches)
        self.calls.append((t0, t1, covered))

    def call(self, b: int) -> None:
        keys, values, ts = self.traffic.batch(b)
        t0 = time.perf_counter()
        with self.rf("client.process_columns"):
            out = self.proc.process_columns(keys, values, ts)
        self._read(out, t0)

    def flush(self) -> None:
        t0 = time.perf_counter()
        with self.rf("client.flush"):
            out = self.proc.flush()
        self._read(out, t0)

    def matches_of(self, keys) -> List[tuple]:
        """``(key, match)`` of ``keys`` (kept keys), in the order they were
        handed back."""
        keep = set(int(k) for k in keys)
        return [(int(k), check.canon(seq)) for k, seq in self.kept if int(k) in keep]


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value with at
    least 95 % of all values at or below it."""
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def batch_latencies(calls: List[tuple], first: int, n: int) -> List[float]:
    """Seconds from the start of batch ``b``'s call to the return of the
    last call that handed back a match of it, for the ``n`` batches from
    ``first`` (whose calls are ``calls[b - first]``); a batch nothing came
    back for ends at its own call's return."""
    ends: Dict[int, float] = {}
    for _, t1, covered in calls:
        for bb in covered:
            if t1 > ends.get(bb, 0.0):
                ends[bb] = t1
    return [ends.get(first + i, calls[i][1]) - calls[i][0] for i in range(n)]


@dataclasses.dataclass
class RunView:
    """What a per-layer reader may read of one traced run."""

    config: Dict[str, Any]
    keys: int
    kind: str  # the card's name
    host_batches: int  # window batches outside the traced ones
    host_phase_s: Dict[str, float]  # the processor's phase seconds over them
    trace: Any = None  # trace.TraceSummary of the traced batches
    trace_batches: int = 0
    trace_window_s: float = 0.0
    trace_hops: int = 0  # walk + extract + drain hops in the traced batches
    snapshot: Dict[str, Any] = dataclasses.field(default_factory=dict)  # the
    #   processor's ``metrics_snapshot(per_lane=False)`` once the window closed


PHASES = ("pack_seconds", "dispatch_seconds", "decode_seconds", "drain_seconds",
          "gc_seconds")


def _phase_s(proc) -> Dict[str, float]:
    return {p: float(getattr(proc.metrics, p)) for p in PHASES}


def _hops(proc) -> int:
    c = proc.walk_counters()
    return int(c["walk_hops"] + c["extract_hops"] + c["drain_hops"])


def _traced_phases(proc, torch) -> None:
    """A ``record_function`` range around each processor phase, so that idle
    gaps on the card can be named by the host phase they fall in (a traced
    run only; nothing if the processor has no phase hook)."""
    orig = getattr(proc, "_phase", None)
    if orig is None:
        return

    @contextlib.contextmanager
    def phase(name):
        with torch.profiler.record_function(f"phase.{name}"), orig(name):
            yield

    proc._phase = phase


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool = False,
             device: str = "cuda", keys: Optional[int] = None,
             engine: Optional[Dict] = None, processor: Optional[Dict] = None,
             hook: Optional[Callable] = None,
             t_start: Optional[float] = None) -> Dict[str, Any]:
    """One run; returns the result line's fields and ``checks``.

    ``keys`` cuts the configuration's key count (tests, on the CPU);
    ``engine`` and ``processor`` override the program's settings (the
    control; the reference keeps the configuration's); ``hook(proc)`` is
    called on the built processor (tests break the timed path with it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from portbench import trace as trace_mod

    cuda = device.startswith("cuda")
    K = int(keys or cell.config["keys"])
    mix = cell.mix
    traffic = generator.Traffic(mix, K, seed)
    proc = build_processor(cell.config, K, device, engine, processor)
    if hook is not None:
        hook(proc)
    if trace:
        _traced_phases(proc, torch)
    rf = torch.profiler.record_function if trace else (lambda name: contextlib.nullcontext())

    def sync():
        if cuda:
            torch.cuda.synchronize()

    kept = check.sample_positions(seed, K, mix["kept_keys"])
    client = Client(proc, traffic, traffic.key_ids[kept], rf)
    pc = {**cell.config["processor"], **(processor or {})}
    warm = 1 + max(int(mix["warmup_batches"]), int(pc.get("drain_interval", 1)),
                   int(pc.get("gc_interval", 16)), int(pc.get("gc_events_interval", 8)))
    for b in range(warm):
        client.call(b)
    sync()
    warm_calls = len(client.calls)

    # The measured window.
    n_trace = int(mix["trace_batches"]) if trace else 0
    trace_from = warm + 2  # two untraced batches first
    view = RunView(cell.config, K, torch.cuda.get_device_name() if cuda else "cpu", 0, {})
    ph_traced = {p: 0.0 for p in PHASES}
    prof = None
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    ph0 = _phase_s(proc)
    b = warm
    while time.perf_counter() - t0 < seconds or (trace and b < trace_from + n_trace):
        if trace and b == trace_from:
            sync()
            hops0, pht0 = _hops(proc), _phase_s(proc)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            tt0 = time.perf_counter()
        client.call(b)
        b += 1
        if trace and b == trace_from + n_trace:
            sync()
            view.trace_window_s = time.perf_counter() - tt0
            prof.stop()
            pht1 = _phase_s(proc)
            ph_traced = {p: pht1[p] - pht0[p] for p in PHASES}
            view.trace_hops = _hops(proc) - hops0
    client.flush()
    sync()
    t1 = time.perf_counter()
    n = b - warm
    window_s = t1 - t0
    ph1 = _phase_s(proc)
    view.host_batches = n - n_trace
    view.host_phase_s = {p: ph1[p] - ph0[p] - ph_traced[p] for p in PHASES}
    if trace:
        view.snapshot = proc.metrics_snapshot(per_lane=False)

    lat = batch_latencies(client.calls[warm_calls:], warm, n)
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    counters = proc.counters()
    log(f"window: {n} batches of {traffic.events_per_batch} events in {window_s:.3f} s; "
        f"{client.matches} matches; set-up {setup_s:.3f} s; counters {counters}")
    rounds = traffic.tpb * b
    topic = proc.topic

    result: Dict[str, Any] = {}
    if trace:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        view.trace = trace_mod.reduce(raw)
        view.trace_batches = n_trace
        del raw, prof
        metrics = {}
        for m in cell.per_layer:
            reader = importlib.import_module(f"portbench.metrics.{m['name']}")
            v = reader.read(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        result["breakdown"] = {"device_ops": [list(x) for x in view.trace.top_ops],
                               "idle_gaps": [list(x) for x in view.trace.idle_gaps]}
    else:
        values = {
            "events_per_s": n * traffic.events_per_batch / window_s,
            "batch_latency_p95_ms": p95(lat) * 1e3,
            "setup_s": setup_s,
        }
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end if m["name"] in values}

    # The check, once the window has closed and the program's state is freed:
    # seeded draws of the kept keys, of those whose engine cut version digits
    # and of those that met a missing entry (``check.py``).
    per_lane = proc.metrics_snapshot(per_lane=True)["per_lane"]
    lanes = np.fromiter((proc.lane(int(k)) for k in traffic.key_ids), np.int64, K)
    overflowing = np.flatnonzero(np.asarray(per_lane["ver_overflows"])[lanes] > 0)
    missing = np.flatnonzero(np.asarray(per_lane["slab_missing"])[lanes] > 0)
    positions = np.union1d(
        check.draw(seed, 10, kept, mix["sample_keys"]),
        np.union1d(check.draw(seed, 8, np.intersect1d(kept, overflowing),
                              mix["sample_overflow_keys"]),
                   check.draw(seed, 9, np.intersect1d(kept, missing),
                              mix["sample_missing_keys"])))
    sampled = client.matches_of(traffic.key_ids[positions])
    missed = traffic.key_ids[np.intersect1d(positions, missing)]
    del client, proc, per_lane
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    tr = time.perf_counter()
    ref, cut = check.reference(cell.config, traffic, positions, rounds, topic)
    sampled = check.within(sampled, cut)
    numbers = check.compare(sampled, ref, counters, missed, cut)
    if numbers["match_diff"]:
        bad = check.differing_keys(sampled, ref)
        log(f"keys whose matches differ ({len(bad)}): {bad[:20]}")
    sample = {"kept": len(kept), "keys": len(positions), "overflowing": len(overflowing),
              "missing": len(missing), "cut": len(cut)}
    log(f"reference: {rounds} rounds, {len(ref)} matches, keys {sample} (kept; compared; "
        f"of all {K}, with ver_overflows and with slab_missing above 0; compared only up to "
        f"where the reference fails), {time.perf_counter() - tr:.1f} s")
    result.update(
        correct=all(numbers[k] <= check.LIMITS[k] for k in check.LIMITS),
        attempted=n * traffic.events_per_batch,
        failed=0,
        device={"platform": "gpu" if cuda else "cpu", "kind": view.kind,
                "count": cell.chips, "memory_peak_bytes": memory_peak},
        checks={k: {"value": numbers[k], "limit": check.LIMITS[k]} for k in check.LIMITS},
        matches_checked=len(ref),
        sample=sample,
        window_s=window_s,
    )
    if trace:
        result["device"]["busy_s"] = view.trace.busy_s
        result["device"]["window_s"] = view.trace_window_s
    return result
