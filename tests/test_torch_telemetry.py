"""The port's telemetry (``utils/telemetry.py``, ``utils/metrics.py``,
``runtime/flight.py``) against the JAX package's, after
``tests/test_telemetry.py`` and ``tests/test_observability.py``: histogram
buckets and percentiles, the same snapshot rendering the same Prometheus
text in both packages, span order in an ``InMemoryTraceSink`` for the
same processor run, the processor's ``phases``, and flight-recorder dumps
(the same records, counters and occupancies from both packages).  Then the
port's own ``layers``: the child spans inside the phases, their profiler
ranges on the sink's clock, their work counts and their rendering."""

import io
import json
import math
import os
import statistics
import sys

import numpy as np
import pytest
import torch

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.runtime import CEPProcessor as JProcessor
from kafkastreams_cep_tpu.runtime import Record as JRecord
from kafkastreams_cep_tpu.runtime.flight import FlightRecorder as JFlight
from kafkastreams_cep_tpu.utils import telemetry as jtel
from kafkastreams_cep_tpu_torch import EngineConfig, Record
from kafkastreams_cep_tpu_torch.runtime import CEPBank, CEPProcessor, FlightRecorder, read_dump
from kafkastreams_cep_tpu_torch.utils import metrics as tmetrics
from kafkastreams_cep_tpu_torch.utils import telemetry as tel

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import stock_demo  # noqa: E402

CFG = dict(max_runs=32, slab_entries=64, slab_preds=8, dewey_depth=16, max_walk=16)


def stock_records(R, n, keys=4, seed=0, t0=0):
    rng = np.random.default_rng(seed)
    return [R(f"k{i % keys}", {"price": int(rng.integers(50, 150)),
                               "volume": int(rng.integers(500, 1500))}, 1000 + t0 + i)
            for i in range(n)]


@pytest.mark.parametrize("lo, hi, per_decade", [(1e-6, 100.0, 4), (1e-3, 10.0, 10), (1.0, 1e6, 2)])
def test_bucket_edges_and_histograms_equal_the_jax_ones(lo, hi, per_decade):
    edges = tel.log_bucket_edges(lo, hi, per_decade)
    assert edges == jtel.log_bucket_edges(lo, hi, per_decade)
    rng = np.random.default_rng(per_decade)
    xs = np.exp(rng.uniform(math.log(lo), math.log(hi), size=257)).tolist()
    h, jh = tel.Histogram(edges), jtel.Histogram(edges)
    for x in xs:
        h.observe(x)
        jh.observe(x)
    assert h.snapshot() == jh.snapshot()
    for q in (0.5, 0.9, 0.99):
        assert h.percentile(q) == jh.percentile(q)
    assert tel.LATENCY_EDGES_S == jtel.LATENCY_EDGES_S


def _registries():
    out = []
    for mod in (tel, jtel):
        reg = mod.MetricsRegistry()
        reg.counter("records_in").value = 12
        reg.gauge("lag ms").set(7)
        reg.histogram("lat", (0.1, 1.0)).observe(0.05)
        reg.histogram("lat", (0.1, 1.0)).observe(5.0)
        out.append(reg)
    return out


def test_registry_snapshot_merge_and_prometheus_equal_the_jax_ones():
    reg, jreg = _registries()
    assert reg.snapshot() == jreg.snapshot()
    assert tel.render_prometheus(reg.snapshot(), prefix="cep") == jtel.render_prometheus(
        jreg.snapshot(), prefix="cep")
    other, jother = _registries()
    reg.merge(other)
    jreg.merge(jother)
    assert reg.snapshot() == jreg.snapshot()
    a, b = {"x": 3, "y": 1, "z": 0}, {"x": 1, "y": 1}
    assert tel.positive_delta(a, b) == jtel.positive_delta(a, b)
    assert tel.merge_counter_dicts([a, b]) == jtel.merge_counter_dicts([a, b])
    assert tmetrics.merge_counter_dicts([a, b]) == tel.merge_counter_dicts([a, b])


def test_processor_snapshot_renders_the_same_prometheus_text():
    """A port processor's snapshot (phases with real timings included)
    renders the same text through either package's renderer, but for the
    port's own ``layers`` entry, which only the port's renderer draws (the
    JAX one finds no number in it)."""
    proc = CEPProcessor(ts.stock(ts.TQuery), 4, EngineConfig(**CFG), device="cpu")
    for b in range(3):
        proc.process(stock_records(Record, 16, seed=b, t0=b * 100))
    snap = proc.metrics_snapshot()
    assert {"pack", "dispatch", "device", "decode"} <= set(snap["phases"])
    assert snap["phases"]["dispatch"]["count"] == 3
    txt = tel.render_prometheus(snap)
    shared = {k: v for k, v in snap.items() if k != "layers"}
    assert tel.render_prometheus(shared) == jtel.render_prometheus(snap)
    assert jtel.render_prometheus(snap) == jtel.render_prometheus(shared)
    lines = txt.splitlines()
    assert any("cep_layer_" in line for line in lines)
    assert [line for line in lines if "cep_layer_" not in line] == (
        tel.render_prometheus(shared).splitlines())
    assert 'cep_phase_seconds_count{phase="dispatch"} 3' in txt


def _spans(Proc, R, Q, Config, sink, **kw):
    proc = Proc(ts.stock(Q), 4, Config(**CFG), trace_sink=sink, **kw)
    for b in range(2):
        proc.process(stock_records(R, 12, seed=b, t0=b * 100))
    return [(e["type"], e["name"], e.get("path"), e.get("records"), e.get("matches"))
            for e in sink.events]


def test_span_order_equals_the_jax_processors():
    """The batch and phase spans, in order, are the JAX processor's; the
    port's child spans (``pack.copy``, ``decode.wait``, ...) come between
    them."""
    sink = tel.InMemoryTraceSink()
    got = _spans(CEPProcessor, Record, ts.TQuery, EngineConfig, sink, device="cpu")
    want = _spans(JProcessor, JRecord, ts.JQuery, JConfig, jtel.InMemoryTraceSink())
    children = {e["name"] for e in sink.events} - {"batch"} - {
        e["name"] for e in sink.events if e["name"].startswith("phase.")}
    assert children and children <= set(tmetrics.LAYER_SPANS)
    got = [g for g in got if g[1] not in children]
    assert got == want
    assert [n for _, n, *_ in got[:5]] == ["phase.pack", "phase.dispatch", "phase.device",
                                          "phase.decode", "batch"]


def test_span_nesting_and_jsonl_sink():
    sink = tel.InMemoryTraceSink()
    with sink.span("outer", tag="a") as sp:
        with sink.span("inner"):
            sink.event("ping", k=1)
        sp["late"] = True
    inner, outer = sink.spans("inner")[0], sink.spans("outer")[0]
    assert inner["parent_id"] == outer["span_id"] and outer["parent_id"] is None
    assert outer["late"] is True and outer["tag"] == "a"
    buf = io.StringIO()
    with tel.JsonlTraceSink(buf).span("s", n=1):
        pass
    evt = json.loads(buf.getvalue().strip())
    assert evt["type"] == "span" and evt["name"] == "s" and evt["n"] == 1
    with tel.maybe_span(None, "nothing") as sp:
        sp["x"] = 1  # a no-op span without a sink


def test_flight_dumps_equal_the_jax_recorders(tmp_path):
    """Both processors over the same batches: the dumped records carry the
    same sequence numbers, correlation ids, record and match deltas,
    counters and occupancies (phase timings aside)."""
    docs = []
    for name, Proc, R, Q, Config, Flight, kw in (
            ("torch", CEPProcessor, Record, ts.TQuery, EngineConfig, FlightRecorder,
             dict(device="cpu")),
            ("jax", JProcessor, JRecord, ts.JQuery, JConfig, JFlight, {})):
        fr = Flight(capacity=3, path=str(tmp_path / f"fl-{name}"))
        proc = Proc(ts.stock(Q), 4, Config(**CFG), epoch=0, flight=fr, **kw)
        for b in range(5):
            proc.process(stock_records(R, 16, seed=b, t0=b * 100))
        docs.append(read_dump(fr.dump("demand", corr="manual-1")))
    strip = [{k: v for k, v in r.items() if k not in ("ts_ms", "phase_seconds")}
             for r in docs[0]["records"]]
    jstrip = [{k: v for k, v in r.items() if k not in ("ts_ms", "phase_seconds")}
              for r in docs[1]["records"]]
    assert strip == jstrip
    h = docs[0]["header"]
    assert (h["reason"], h["corr"], h["records"], h["dropped"]) == ("demand", "manual-1", 3, 2)
    assert [r["seq"] for r in docs[0]["records"]] == [3, 4, 5]
    assert all(r["records_in"] == 16 and "slab_live" in r for r in docs[0]["records"])


def test_flight_without_path_and_profile_annotate(tmp_path):
    fr = FlightRecorder(capacity=8)
    proc = CEPProcessor(ts.stock(ts.TQuery), 2, EngineConfig(**CFG), epoch=0, flight=fr,
                        device="cpu")
    with tmetrics.profile(str(tmp_path / "prof")) as prof:
        with tmetrics.annotate("two batches"):
            proc.process(stock_records(Record, 8, keys=2))
    out = fr.dump("demand")
    assert out[0]["type"] == "flight_dump" and out[1]["type"] == "flight_record"
    assert any(e.key == "two batches" for e in prof.key_averages())
    assert os.listdir(tmp_path / "prof")


# -- the port's child spans and work counts (``layers``) ------------------------

LAYER_KEYS = 256
#: Ticks a key gets in each batch of :func:`layer_batches`: T 2, 4, 4, 1.
LAYER_TICKS = (2, 3, 4, 1)


def layer_batches(n=4, seed=5):
    """``n`` column batches of the stock values over ``LAYER_KEYS`` keys,
    batch ``b`` giving every key ``LAYER_TICKS[b]`` ticks."""
    rng = np.random.default_rng(seed)
    out, t = [], 1000
    for b in range(n):
        keys = np.tile(np.arange(LAYER_KEYS), LAYER_TICKS[b % len(LAYER_TICKS)])
        m = keys.size
        values = {"price": rng.integers(50, 150, m).astype(np.int32),
                  "volume": rng.integers(500, 1500, m).astype(np.int32)}
        out.append((keys, values, t + np.arange(m, dtype=np.int64)))
        t += m
    return out


def layered(sink=None, pipeline=True):
    """A processor whose event GC and sweep run every second batch."""
    return CEPProcessor(ts.stock(ts.TQuery), LAYER_KEYS, EngineConfig(**CFG), epoch=0,
                        device="cpu", trace_sink=sink, pipeline=pipeline,
                        gc_interval=2, gc_events_interval=2)


def run_layered(proc, n=4):
    for cols in layer_batches(n):
        proc.process_columns(*cols)
    return proc


@pytest.fixture(scope="module")
def pipelined_run():
    """A pipelined processor over :func:`layer_batches`, and its spans."""
    sink = tel.InMemoryTraceSink()
    return run_layered(layered(sink)), sink


@pytest.mark.parametrize("pipeline", [True, False])
def test_child_spans_nest_inside_their_phases(pipeline, pipelined_run):
    """Each child span lies under the phase its name begins with, the
    ``gc.*`` spans only in the batches that ran the event GC, and a phase's
    children take no more than the phase."""
    if pipeline:
        sink = pipelined_run[1]
    else:
        sink = tel.InMemoryTraceSink()
        run_layered(layered(sink, pipeline))
    spans = sink.spans()
    by_id = {s["span_id"]: s for s in spans}
    # No CUDA synchronize on the CPU, so no device.wait.
    assert {s["name"] for s in spans} & set(tmetrics.LAYER_SPANS) == (
        set(tmetrics.LAYER_SPANS) - {"device.wait"})

    def batch_of(s):
        while s["name"] != "batch":
            s = by_id[s["parent_id"]]
        return s["batch"]

    for s in spans:
        if s["name"] in tmetrics.LAYER_SPANS:
            assert by_id[s["parent_id"]]["name"] == "phase." + s["name"].split(".")[0], s
    for name in ("gc.read", "gc.sweep", "dispatch.sweep"):
        assert sorted(batch_of(s) for s in spans if s["name"] == name) == [2, 4], name
    for parent in spans:
        kids = [s["duration_ms"] for s in spans if s["parent_id"] == parent["span_id"]
                and s["name"] in tmetrics.LAYER_SPANS]
        assert sum(kids) <= parent["duration_ms"], parent


def test_ranges_come_from_the_program_on_the_sinks_clock(tmp_path):
    """Under a profiler (the CPU activity, no wrapper around the
    processor) the exported trace holds a range for the batch, each phase
    and each child span, and the JSONL spans are on the trace's clock
    (``baseTimeNanoseconds + ts``): each lies inside its range to within a
    millisecond, and they start a median of under a millisecond after
    their ranges (the range opens first; a preemption between the two
    stamps delays a span, which is no disagreement of the clocks)."""
    buf = io.StringIO()
    proc = layered(tel.JsonlTraceSink(buf))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run_layered(proc)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_ms = trace["baseTimeNanoseconds"] / 1e6
    ranges = {}
    for ev in trace["traceEvents"]:
        if ev.get("cat") == "user_annotation" and ev.get("ph") == "X":
            start = base_ms + ev["ts"] / 1e3
            ranges.setdefault(ev["name"], []).append((start, start + ev["dur"] / 1e3))
    spans = [json.loads(line) for line in buf.getvalue().splitlines()]
    names = {s["name"] for s in spans}
    assert {"batch", "phase.pack", "phase.decode", "phase.gc", "pack.lanes", "pack.copy",
            "decode.wait", "decode.build", "gc.read", "gc.sweep"} <= names
    lags = []
    for name in names:
        got = sorted((s["ts_ms"], s["duration_ms"]) for s in spans if s["name"] == name)
        want = sorted(ranges.get(name, []))
        assert len(got) == len(want), name
        for (ts, dur), (r0, r1) in zip(got, want):
            assert r0 - 1.0 <= ts and ts + dur <= r1 + 1.0, (name, ts, dur, r0, r1)
            lags.append(ts - r0)
    assert abs(statistics.median(lags)) < 1.0


def test_no_profiler_opens_no_range(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    proc = run_layered(layered(tel.InMemoryTraceSink()), 2)
    assert calls == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        proc.process_columns(*layer_batches(3)[2])
    assert {"batch", "phase.pack", "pack.lanes", "pack.columns", "pack.copy",
            "phase.decode"} <= set(calls)


def test_layer_counters_agree_with_the_host_mirror(pipelined_run):
    """``steps`` is the batches' T summed; after a GC batch ``host_events``
    is the host mirror's size, which only the decode and the GC fill and
    only the GC empties."""
    proc = pipelined_run[0]
    c = proc.metrics_snapshot(per_lane=False)["layers"]["counters"]
    assert c["steps"] == 2 + 4 + 4 + 1
    held = sum(len(store) for store in proc._events)
    assert c["host_events"] == held > 0
    assert c["decode_events_materialized"] > 0 and c["gc_events_materialized"] > 0
    assert c["gc_events_dropped"] > 0
    assert held == (c["decode_events_materialized"] + c["gc_events_materialized"]
                    - c["gc_events_dropped"])


def test_prometheus_renders_the_layers(pipelined_run):
    snap = pipelined_run[0].metrics_snapshot(per_lane=False)
    txt = tel.render_prometheus(snap)
    lay = snap["layers"]
    assert set(lay["spans"]) == set(tmetrics.LAYER_SPANS)
    for name, h in lay["spans"].items():
        assert f'cep_layer_span_seconds_count{{span="{name}"}} {h["count"]}' in txt
    assert lay["spans"]["decode.wait"]["count"] > 0
    assert f"cep_layer_steps_total {lay['counters']['steps']}" in txt
    assert f"cep_layer_host_events {lay['counters']['host_events']}" in txt
    assert "# TYPE cep_layer_host_events gauge" in txt
    assert "# TYPE cep_layer_steps_total counter" in txt
    assert "# TYPE cep_layer_span_seconds histogram" in txt


def test_bank_merges_the_layers():
    bank = CEPBank({"a": ts.stock(ts.TQuery), "b": ts.strict3(ts.TQuery)}, num_lanes=4,
                   config=EngineConfig(**CFG), device="cpu")
    for b in range(3):
        bank.process(stock_records(Record, 16, seed=b, t0=b * 100))
    merged = bank.metrics_snapshot()["layers"]
    members = [p.metrics.layers() for p in bank.processors.values()]
    assert merged["counters"] == {k: sum(m["counters"][k] for m in members)
                                  for k in merged["counters"]}
    assert merged["counters"]["steps"] > 0
    for name, h in merged["spans"].items():
        assert h["count"] == sum(m["spans"][name]["count"] for m in members), name


class _Event:
    """A CUDA timing event's stand-in: its time (ms) and completion."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_card_time_is_read_once_a_wait_has_covered_it():
    """``device_seconds`` adds each batch's card time, start to end event,
    once the end event has completed, oldest first, and observes it once
    a batch in ``phases["device"]``."""
    proc = CEPProcessor(ts.stock(ts.TQuery), 2, EngineConfig(**CFG), device="cpu")
    first, second = (_Event(0.0), _Event(250.0)), (_Event(300.0), _Event(420.0, False))
    proc._card_times += [first, second]
    proc._read_card_times()
    assert proc.metrics.device_seconds == pytest.approx(0.25)
    assert proc._card_times == [second]
    second[1].done = True
    proc._read_card_times()
    assert proc.metrics.device_seconds == pytest.approx(0.37) and proc._card_times == []
    assert proc.metrics.phases()["device"]["count"] == 2
