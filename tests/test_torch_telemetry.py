"""The port's telemetry (``utils/telemetry.py``, ``utils/metrics.py``,
``runtime/flight.py``) against the JAX package's, after
``tests/test_telemetry.py`` and ``tests/test_observability.py``: histogram
buckets and percentiles, the same snapshot rendering the same Prometheus
text in both packages, span order in an ``InMemoryTraceSink`` for the
same processor run, the processor's ``phases``, and flight-recorder dumps
(the same records, counters and occupancies from both packages)."""

import io
import json
import math
import os
import sys

import numpy as np
import pytest

import torch_scenarios as ts
from kafkastreams_cep_tpu.engine import EngineConfig as JConfig
from kafkastreams_cep_tpu.runtime import CEPProcessor as JProcessor
from kafkastreams_cep_tpu.runtime import Record as JRecord
from kafkastreams_cep_tpu.runtime.flight import FlightRecorder as JFlight
from kafkastreams_cep_tpu.utils import telemetry as jtel
from kafkastreams_cep_tpu_torch import EngineConfig, Record
from kafkastreams_cep_tpu_torch.runtime import CEPProcessor, FlightRecorder, read_dump
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
    renders the same text through either package's renderer."""
    proc = CEPProcessor(ts.stock(ts.TQuery), 4, EngineConfig(**CFG), device="cpu")
    for b in range(3):
        proc.process(stock_records(Record, 16, seed=b, t0=b * 100))
    snap = proc.metrics_snapshot()
    assert {"pack", "dispatch", "device", "decode"} <= set(snap["phases"])
    assert snap["phases"]["dispatch"]["count"] == 3
    txt = tel.render_prometheus(snap)
    assert txt == jtel.render_prometheus(snap)
    assert 'cep_phase_seconds_count{phase="dispatch"} 3' in txt


def _spans(Proc, R, Q, Config, sink, **kw):
    proc = Proc(ts.stock(Q), 4, Config(**CFG), trace_sink=sink, **kw)
    for b in range(2):
        proc.process(stock_records(R, 12, seed=b, t0=b * 100))
    return [(e["type"], e["name"], e.get("path"), e.get("records"), e.get("matches"))
            for e in sink.events]


def test_span_order_equals_the_jax_processors():
    got = _spans(CEPProcessor, Record, ts.TQuery, EngineConfig, tel.InMemoryTraceSink(),
                 device="cpu")
    want = _spans(JProcessor, JRecord, ts.JQuery, JConfig, jtel.InMemoryTraceSink())
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
