"""The load generator: the same seed gives the same columns, every seed
the same sizes and arrivals."""

import numpy as np
import pytest

from portbench.traffic import generator

MIX = generator.load("ticks")


def columns(seed, keys=64, b=3):
    tr = generator.Traffic(MIX, keys, seed)
    k, v, ts = tr.batch(b)
    return tr, k.copy(), {n: x.copy() for n, x in v.items()}, ts.copy()


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 11, 2**40 + 3])
def test_same_seed_same_columns(seed):
    _, k1, v1, t1 = columns(seed)
    _, k2, v2, t2 = columns(seed)
    assert np.array_equal(k1, k2) and np.array_equal(t1, t2)
    assert all(np.array_equal(v1[n], v2[n]) for n in v1)


def test_other_seed_other_values_same_sizes():
    tr1, k1, v1, t1 = columns(1)
    tr2, k2, v2, t2 = columns(2)
    assert not np.array_equal(v1["price"], v2["price"])
    assert k1.shape == k2.shape and np.array_equal(t1, t2)
    assert tr1.events_per_batch == tr2.events_per_batch == 4 * 64


def test_rounds_keys_and_time():
    tr, keys, values, ts = columns(9, keys=32, b=5)
    K, tpb = 32, MIX["ticks_per_batch"]
    # Every key once a round, in one arrival order kept for the run.
    assert len(set(tr.key_ids.tolist())) == K
    for j in range(tpb):
        assert np.array_equal(keys[j * K:(j + 1) * K], tr.key_ids)
        assert (ts[j * K:(j + 1) * K] == generator.T0_MS + (tpb * 5 + j) * MIX["tick_ms"]).all()
    assert tr.batch_of_ts(int(ts[-1])) == 5
    assert values["price"].min() >= MIX["price"]["low"]
    assert values["price"].max() <= MIX["price"]["high"]


def test_spike_share_and_pool_replay():
    tr = generator.Traffic(MIX, 2048, 3)
    share = float((tr.volume == MIX["volume"]["spike_value"]).mean())
    assert abs(share - MIX["volume"]["spike_share"]) < 0.002
    base = tr.volume[tr.volume != MIX["volume"]["spike_value"]]
    assert base.min() >= MIX["volume"]["low"] and base.max() <= MIX["volume"]["high"]
    # The pool is gone through again with event time still advancing, each
    # key reading another column: no key's stream repeats itself.
    P = MIX["pool_rounds"]
    _, v0, t0 = tr.batch(0)
    _, v1, t1 = tr.batch(P // MIX["ticks_per_batch"])
    cols = tr.columns(1)
    assert np.array_equal(v1["price"][:2048], tr.price[0][cols])
    assert not np.array_equal(v0["price"], v1["price"])
    assert sorted(cols.tolist()) == list(range(2048)) and (cols != np.arange(2048)).mean() > 0.99
    assert (t1 - t0 == P * MIX["tick_ms"]).all()


@pytest.mark.parametrize("b", [2, 25, 50])
def test_key_events_match_the_columns(b):
    """A key's events as the reference reads them are the columns' own, in
    the first pool cycle and in later ones."""
    tr = generator.Traffic(MIX, 16, 4)
    tpb = MIX["ticks_per_batch"]
    ev = tr.key_events(5, (b + 1) * tpb)
    keys, values, ts = tr.batch(b)
    rows = np.nonzero(keys == tr.key_ids[5])[0]
    got = [(int(ts[i]), {"price": int(values["price"][i]), "volume": int(values["volume"][i])})
           for i in rows]
    assert ev[b * tpb:] == got
