"""The walk pass's bytes, counted from shapes: against a count by hand,
and against the tensors the program hands its walk pass (on the CPU)."""

import pytest
import torch

from portbench import roofline


def test_slab_bytes_by_hand():
    # K=2, E=3, MP=2, D=4: 4 [K,E] + 3 [K,E,MP] + [K,E,MP,D] + 6 [K] int32.
    n = 4 * 6 + 3 * 12 + 48 + 12
    assert roofline.slab_bytes(2, 3, 2, 4, False, 0, False) == 4 * n
    # Two-tier adds 4 [K], drain 1 [K], attribution [K, S].
    assert roofline.slab_bytes(2, 3, 2, 4, True, 5, True) == 4 * (n + 8 + 2 + 10)


def test_step_and_drain_bytes_by_hand():
    eng = dict(max_runs=2, slab_entries=3, slab_preds=2, dewey_depth=4, max_walk=5,
               handle_ring=8)
    K, H = 2, 2
    slab = roofline.slab_bytes(K, 3, 2, 4, False, 0, False)
    NW, P = 2 * 2 + 4, 4
    walkers = K * NW * (3 + 4 * 3 + 4 * 4)
    puts = K * P * (2 + 4 * 4 + 4 * 4)
    outs = K * 2 * (2 * 5 + 1) * 4
    assert roofline.walk_step_bytes(K, eng, H, 4) == 2 * slab + walkers + puts + 4 * K + outs
    dslab = roofline.slab_bytes(K, 3, 2, 4, False, 0, True)
    ring = K * 8 * (3 + 12 + 16)
    assert roofline.walk_drain_bytes(K, eng, 4) == 2 * dslab + ring + K * 8 * 11 * 4


def test_least_seconds_takes_the_larger_bound():
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.least_seconds(3.35e12, 0, kind) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12 * 2, kind) == pytest.approx(2.0)
    assert roofline.least_seconds(1, 1, "some other card") is None


def _nbytes(xs):
    return sum(x.numel() * x.element_size() for x in xs)


@pytest.mark.parametrize("config", ["stock", "stock-lazy"])
def test_bytes_equal_the_programs_tensors(config, monkeypatch):
    """The count from shapes equals the bytes of the tensors the program's
    step and drain hand its walk pass (the rule of ``chip_smoke.py:
    bound``), on a CPU run of the configuration at 8 keys."""
    from kafkastreams_cep_tpu_torch.ops import walk_kernel
    from portbench import harness

    seen = []
    real = walk_kernel.walk_pass_plain

    def spy(slab, *args, **kw):
        out = real(slab, *args, **kw)
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if kw.get("put_ops") is not None:
            tensors += list(kw["put_ops"]) + [kw["ev_off"]]
        fields = walk_kernel.mode_fields(kw.get("hot_entries", 0), slab.stage_hops.shape[1],
                                         kw.get("drain", False))
        moved = (_nbytes(getattr(slab, f) for f in fields) + _nbytes(getattr(out[0], f) for f in fields)
                 + _nbytes(tensors) + _nbytes(out[1:]))
        seen.append((kw.get("drain", False), moved))
        return out

    monkeypatch.setattr(walk_kernel, "walk_pass_plain", spy)
    from portbench import control

    cell = control.cell_of(f"{config}.ticks")
    cfg = cell.config
    cell.config["processor"] = dict(cfg["processor"], drain_interval=1)
    proc = harness.build_processor(cfg, 8, "cpu")
    from portbench.traffic import generator

    tr = generator.Traffic(cell.mix, 8, 3)
    for b in range(3):
        proc.process_columns(*tr.batch(b))
    proc.flush()
    eng, work = cfg["engine"], cfg["work"]
    want_step = roofline.walk_step_bytes(8, eng, work["chain_frames"], work["stages"])
    assert {m for d, m in seen if not d} == {want_step}
    if eng.get("lazy_extraction"):
        assert {m for d, m in seen if d} == {roofline.walk_drain_bytes(8, eng, work["stages"])}
