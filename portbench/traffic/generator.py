"""The one load generator: a traffic mix's data file in, seeded columns out.

A mix (``traffic/<name>.json``) gives a round's shape: every key sends one
event a round, in one arrival order drawn from the seed and kept for the
run (bars published for every instrument at each interval's close), and
``ticks_per_batch`` rounds make a batch.  Prices and volumes come from a
pool of ``pool_rounds`` rounds of ``keys`` columns, drawn once from the
seed during set-up.  The run goes through the pool cycle after cycle with
event time that keeps advancing by ``tick_ms`` a round, and in each cycle
after the first every key reads another column, by a permutation drawn
from the seed for that cycle: so no key's stream repeats itself, and each
key sees independent draws all through the run.  (A key that read its own
column every cycle would repeat one pattern; a spike at the pool's top
price then begins a run that no later price can advance, once a cycle, and
the state grows without end.)

The value draw is ``bench.py: bench_processor``'s calibrated stream
(bench.py:1679-1690): prices uniform on ``[price.low, price.high]``,
volumes uniform on ``[volume.low, volume.high]`` with a ``spike_share`` of
events at ``spike_value`` (the spikes begin runs).  The same seed gives the
same columns; every seed gives the same sizes and arrivals.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent

#: Event time of round 0 (epoch ms, 2023-11-14): any fixed start will do.
T0_MS = 1_700_000_000_000


def load(name: str) -> Dict:
    """The mix ``traffic/<name>.json``."""
    return json.loads((HERE / f"{name}.json").read_text())


class Traffic:
    """Seeded columns of one mix over ``keys`` keys."""

    def __init__(self, mix: Dict, keys: int, seed: int):
        self.mix = mix
        self.keys = int(keys)
        self.tpb = int(mix["ticks_per_batch"])
        self.tick_ms = int(mix["tick_ms"])
        rounds = int(mix["pool_rounds"])
        if rounds % self.tpb:
            raise ValueError(f"pool_rounds={rounds} is no multiple of "
                             f"ticks_per_batch={self.tpb}")
        rng = np.random.default_rng(int(seed) % (1 << 64))
        K = self.keys
        # Key ids in arrival order: distinct, int32, one order for the run.
        self.key_ids = int(mix["key_base"]) + rng.permutation(K).astype(np.int64)
        pr, vo = mix["price"], mix["volume"]
        self.price = rng.integers(pr["low"], pr["high"] + 1, size=(rounds, K),
                                  dtype=np.int64)
        base = rng.integers(vo["low"], vo["high"] + 1, size=(rounds, K), dtype=np.int64)
        spike = rng.random((rounds, K)) < float(vo["spike_share"])
        self.volume = np.where(spike, np.int64(vo["spike_value"]), base)
        self.pool_rounds = rounds
        self.seed = int(seed) % (1 << 64)
        self._perms: Dict[int, np.ndarray] = {}
        self._keys_col = np.tile(self.key_ids, self.tpb)
        self._ts_col = np.repeat(np.arange(self.tpb, dtype=np.int64) * self.tick_ms, K)

    def columns(self, cycle: int) -> np.ndarray:
        """The pool column each key (by arrival place) reads in ``cycle``:
        its own in the first, then a permutation drawn from the seed."""
        if cycle not in self._perms:
            self._perms[cycle] = (np.arange(self.keys) if cycle == 0 else
                                  np.random.default_rng([self.seed, 11, cycle]).permutation(self.keys))
        return self._perms[cycle]

    def values(self, first: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Prices and volumes of rounds ``[first, first + n)``, ``[n, keys]``
        each, keys in arrival order."""
        price, volume = [], []
        r = first
        while r < first + n:
            cycle, row = divmod(r, self.pool_rounds)
            m = min(self.pool_rounds - row, first + n - r)
            cols = self.columns(cycle)
            price.append(self.price[row:row + m][:, cols])
            volume.append(self.volume[row:row + m][:, cols])
            r += m
        return np.concatenate(price), np.concatenate(volume)

    @property
    def events_per_batch(self) -> int:
        return self.tpb * self.keys

    def round_ts(self, r) -> np.ndarray:
        """Event time of round ``r`` (ms)."""
        return T0_MS + np.asarray(r, dtype=np.int64) * self.tick_ms

    def batch(self, b: int) -> Tuple[np.ndarray, Dict[str, np.ndarray], np.ndarray]:
        """Batch ``b``: rounds ``[tpb*b, tpb*b + tpb)`` as ``(keys, values,
        timestamps)`` columns, round-major, keys in arrival order."""
        price, volume = self.values(self.tpb * b, self.tpb)
        values = {"price": price.reshape(-1), "volume": volume.reshape(-1)}
        ts = self._ts_col + (T0_MS + self.tpb * b * self.tick_ms)
        return self._keys_col, values, ts

    def batch_of_ts(self, ts: int) -> int:
        """The batch that sent the event at time ``ts``."""
        return (ts - T0_MS) // (self.tick_ms * self.tpb)

    def key_events(self, pos: int, rounds: int) -> List[Tuple[int, Dict[str, int]]]:
        """The key at arrival place ``pos``: its first ``rounds`` events as
        ``(timestamp, value)``, the value as the columns carry it."""
        r = np.arange(rounds)
        cycle, row = np.divmod(r, self.pool_rounds)
        col = np.array([self.columns(c)[pos] for c in range(-(-rounds // self.pool_rounds))],
                       dtype=np.int64)[cycle]
        p = self.price[row, col].tolist()
        v = self.volume[row, col].tolist()
        return [(t, {"price": a, "volume": b})
                for t, a, b in zip(self.round_ts(r).tolist(), p, v)]
