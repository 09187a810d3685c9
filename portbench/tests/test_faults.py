"""The check on the CPU: a sound run is correct; the control (the program
with its window pruning off, breaking the configuration's window
guarantee) and each fault that a cell can have, planted under the timed
path, come out not correct.  (The chip's readings of the control are in
``PERF.md``; ``portbench/control.py`` makes them.)"""

import pytest

from portbench import harness

KEYS, SECONDS = 48, 1.5


def result(cell, hook=None, engine=None, seed=31):
    return harness.run_cell(harness.load_cell(cell), seed, SECONDS, device="cpu", keys=KEYS,
                            hook=hook, engine=engine)


def over(res):
    return {k: c["value"] for k, c in res["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("cell", ["stock.ticks"])
def test_sound_run_is_correct(cell):
    res = result(cell)
    assert res["correct"], res["checks"]
    assert res["matches_checked"] > 20


@pytest.mark.parametrize("cell", ["stock.ticks"])
def test_control_windows_off_is_not_correct(cell):
    res = result(cell, engine={"enforce_windows": False})
    assert not res["correct"] and "match_diff" in over(res)


def state_unchanged(proc):
    """Each batch's steps compute their outputs but hand back the state
    they were given."""
    scan = proc.batch.scan

    def frozen(state, events):
        _, out = scan(state, events)
        return state, out

    proc.batch.scan = frozen


def half_batch(proc):
    """Half of every batch left out."""
    pc = proc.process_columns

    def half(keys, values, ts):
        n = len(keys) // 2
        return pc(keys[:n], {k: v[:n] for k, v in values.items()}, ts[:n])

    proc.process_columns = half


def answer_altered(proc):
    """The first match of every batch loses its completing event where the
    decode builds it."""
    build = proc._build_matches

    def altered(*args):
        out = build(*args)
        if out:
            key, seq = out[0]
            items = [(s, e) for s, evs in seq.as_map().items() for e in evs]
            out[0] = (key, type(seq)(items[1:]))
        return out

    proc._build_matches = altered


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, answer_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ["stock.ticks"])
def test_fault_is_not_correct(cell, fault):
    res = result(cell, hook=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("keys,seed,key,rounds", [
    (1024, 3000000777, 1000031, 52), (1024, 3000000777, 1000120, 124),
    (1024, 3000000777, 1000153, 188), (2048, 3000000902, 1000712, 148)])
def test_program_agrees_up_to_a_missing_entry(keys, seed, key, rounds):
    """Keys whose stream meets a missing entry: one key's stream through a
    one-lane processor gives the reference's matches up to the event where
    the reference fails, and the engine counts its missing entries only on
    such keys."""
    import numpy as np

    from portbench import check
    from portbench.traffic import generator

    cell = harness.load_cell("stock.ticks")
    tr = generator.Traffic(cell.mix, keys, seed)
    pos = int(np.flatnonzero(tr.key_ids == key)[0])
    proc = harness.build_processor(cell.config, 1, "cpu")
    events, got = tr.key_events(pos, rounds), []
    for b in range(0, rounds, tr.tpb):
        ts, values = zip(*events[b:b + tr.tpb])
        cols = {n: np.array([v[n] for v in values]) for n in values[0]}
        got += proc.process_columns(np.full(len(ts), key), cols, np.array(ts))
    got += proc.flush()
    ref, cut = check.reference(cell.config, tr, [pos], rounds, proc.topic)
    missed = [key] if proc.counters()["slab_missing"] else []
    program = check.within([(int(k), check.canon(s)) for k, s in got], cut)
    assert list(cut) == [key]
    assert check.compare(program, ref, proc.counters(), missed, cut) == {
        "match_diff": 0, "order_diff": 0, "loss": 0, "miss_unmet": 0}


def test_missing_entry_the_reference_lacks_is_counted():
    from portbench import check

    assert check.compare([], [], {}, missed=[5, 6], cut={6: 100})["miss_unmet"] == 1
