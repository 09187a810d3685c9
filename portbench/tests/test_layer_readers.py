"""The readers of the processor's own spans and counts (``decode_ms``,
``gc_ms``, ``decode_wait_pct``, ``launches_per_step``): on a traced CPU
run, and each one's arithmetic on a made-up ``RunView``."""

import pytest

from portbench import harness, trace
from portbench.metrics import decode_ms, decode_wait_pct, gc_ms, launches_per_step


@pytest.fixture(scope="module")
def traced_metrics():
    res = harness.run_cell(harness.load_cell("stock.ticks"), 2**31 + 17, 0.5, trace=True,
                           device="cpu", keys=16)
    return res["metrics"]


def test_host_readers_read_a_cpu_run(traced_metrics):
    for name in ("decode_ms", "gc_ms", "decode_wait_pct"):
        v = traced_metrics[name]["value"]
        assert isinstance(v, float) and v >= 0.0, name
    assert 0.0 < traced_metrics["decode_wait_pct"]["value"] <= 100.0
    # No kernels in a CPU trace.
    assert "launches_per_step" not in traced_metrics


def view(**kw):
    base = dict(config={}, keys=16, kind="cpu", host_batches=4,
                host_phase_s={p: 0.0 for p in harness.PHASES})
    return harness.RunView(**{**base, **kw})


def test_decode_and_gc_ms_are_seconds_a_batch_over_the_untraced_batches():
    v = view(host_batches=8, host_phase_s={**view().host_phase_s, "decode_seconds": 2.0,
                                           "gc_seconds": 0.5})
    assert decode_ms.read(v) == pytest.approx(250.0)
    assert gc_ms.read(v) == pytest.approx(62.5)
    assert decode_ms.read(view(host_batches=0)) is None
    assert gc_ms.read(view(host_batches=0)) is None


def test_decode_wait_pct_is_the_span_over_the_phase():
    snap = {"phases": {"decode": {"count": 10, "sum": 4.0}},
            "layers": {"spans": {"decode.wait": {"count": 9, "sum": 1.5}}, "counters": {}}}
    assert decode_wait_pct.read(view(snapshot=snap)) == pytest.approx(37.5)
    # A program without the span (the parent's), or no decode time: nothing.
    assert decode_wait_pct.read(view(snapshot={"phases": snap["phases"]})) is None
    assert decode_wait_pct.read(view()) is None
    empty = {**snap, "phases": {"decode": {"count": 0, "sum": 0.0}}}
    assert decode_wait_pct.read(view(snapshot=empty)) is None


def _trace(n_kernels):
    ops = [trace.DeviceOp(f"k{i}", "kernel", float(i), 1.0) for i in range(n_kernels)]
    ops.append(trace.DeviceOp("Memcpy HtoD", "gpu_memcpy", 0.0, 5.0))
    return trace.TraceSummary(ops, 1e-6 * n_kernels, [], [])


def test_launches_per_step_counts_kernels_over_the_traced_steps():
    # 10 batches of 4 steps; 2 traced batches with 960 kernels (the copy not
    # counted): 960 / (2 x 4) = 120 a step.
    snap = {"batches": 10, "layers": {"spans": {}, "counters": {"steps": 40}}}
    assert launches_per_step.read(view(trace=_trace(960), trace_batches=2,
                                       snapshot=snap)) == pytest.approx(120.0)
    assert launches_per_step.read(view(trace=_trace(0), trace_batches=2, snapshot=snap)) is None
    assert launches_per_step.read(view(trace_batches=2, snapshot=snap)) is None
    assert launches_per_step.read(view(trace=_trace(960), trace_batches=2,
                                       snapshot={"batches": 10})) is None
