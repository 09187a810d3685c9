"""The end-to-end numbers: the percentile is over all batches, a batch ends
where its last match comes back, and the rate is over the whole window."""

import pytest

from portbench import harness


def test_p95_is_nearest_rank_over_all_values():
    vals = list(range(1, 101))  # 1..100
    assert harness.p95(vals) == 95
    assert harness.p95(vals[::-1]) == 95
    assert harness.p95([7.0]) == 7.0
    # 20 values: rank ceil(19) = 19th smallest; one slow batch in 20 is not the p95.
    assert harness.p95([1.0] * 18 + [5.0, 50.0]) == 5.0
    assert harness.p95([1.0] * 21 + [50.0] * 2) == 50.0


def test_batch_latency_ends_at_the_call_that_returns_its_matches():
    # Pipelined: call i hands in batch 10 + i; batch 10's matches come back
    # with the next call, batch 11's with the one after, batch 12's with the
    # flush; nothing comes back for batch 13.
    calls = [
        (0.0, 1.0, {9}),
        (1.0, 2.5, {10}),
        (2.5, 3.0, {11}),
        (3.0, 4.0, set()),
        (4.0, 4.2, {12}),  # the flush
    ]
    lat = harness.batch_latencies(calls, 10, 4)
    assert lat == pytest.approx([2.5 - 0.0, 3.0 - 1.0, 4.2 - 2.5, 4.0 - 3.0])
    # A batch's latency ends at the *last* call that returned any of it.
    calls = [(0.0, 1.0, {0}), (1.0, 2.0, {0, 1}), (2.0, 3.0, {1})]
    assert harness.batch_latencies(calls, 0, 2) == pytest.approx([2.0, 2.0])


def test_rate_is_over_the_whole_window():
    """A CPU run: events handed in over the window's wall time, flush
    included, every batch of the window counted."""
    cell = harness.load_cell("stock.ticks")
    res = harness.run_cell(cell, 21, 1.0, device="cpu", keys=16)
    m = res["metrics"]
    assert m["events_per_s"]["value"] == pytest.approx(res["attempted"] / res["window_s"])
    assert res["attempted"] % (4 * 16) == 0 and res["attempted"] > 0
    assert m["batch_latency_p95_ms"]["value"] > 0 and m["setup_s"]["value"] > 0
