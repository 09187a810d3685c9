"""The keys the check compares: a seeded draw of all keys, and seeded draws
of the keys whose own ``ver_overflows`` and ``slab_missing`` counters are
above 0 once the window has closed."""

import numpy as np

from portbench import check, harness


def test_draw_is_seeded_and_takes_only_candidates():
    cand = np.array([3, 17, 40, 41, 99, 120])
    a = check.draw(2**31 + 7, 8, cand, 4)
    assert np.array_equal(a, check.draw(2**31 + 7, 8, cand, 4))
    assert len(a) == 4 and set(a) <= set(cand) and np.all(np.diff(a) > 0)
    assert np.array_equal(check.draw(5, 8, cand, 10), cand)
    assert len(check.draw(5, 8, np.array([], dtype=np.int64), 10)) == 0


def test_overflowing_and_missing_keys_join_the_sample():
    """Kept keys whose lanes the program reports above 0 join the
    comparison, beside the draw of kept keys; a missing entry the program
    reports where the reference meets none fails the check."""
    cell = harness.load_cell("stock.ticks")
    cell.mix = dict(cell.mix, kept_keys=32, sample_keys=4, sample_overflow_keys=3,
                    sample_missing_keys=2)
    marked = {"ver_overflows": range(0, 5), "slab_missing": range(5, 9)}

    def report(proc):
        snapshot = proc.metrics_snapshot

        def marked_snapshot(per_lane=True):
            snap = snapshot(per_lane=per_lane)
            for name, lanes in marked.items():
                snap["per_lane"][name] = [int(i in lanes) for i in range(len(snap["per_lane"][name]))]
            return snap

        proc.metrics_snapshot = marked_snapshot

    res = harness.run_cell(cell, 2**31 + 41, 0.5, device="cpu", keys=32, hook=report)
    s = res["sample"]
    assert (s["kept"], s["overflowing"], s["missing"]) == (32, 5, 4)
    assert 5 <= s["keys"] <= 4 + 3 + 2 and s["cut"] == 0
    assert res["checks"]["miss_unmet"]["value"] >= 2 and not res["correct"]


def test_only_kept_keys_are_compared():
    """With fewer kept keys than keys, the compared keys are kept ones."""
    cell = harness.load_cell("stock.ticks")
    cell.mix = dict(cell.mix, kept_keys=6, sample_keys=512)
    res = harness.run_cell(cell, 2**31 + 43, 0.5, device="cpu", keys=32)
    assert res["sample"]["kept"] == res["sample"]["keys"] == 6 and res["correct"]
