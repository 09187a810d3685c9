"""The comparison that decides ``correct``: the window's emitted matches
against the plain reference.

Keys are independent NFAs (``CEPProcessor.java:117-134``: one run queue,
buffer and fold state a key), so the reference replays the whole stream of
a sample of keys, drawn from the seed, through its own oracle
(``reference/oracle.py``, with the configuration's window rule), and the
numbers compared are:

``match_diff``    matches of the sampled keys that one side emitted and the
                  other did not, every stage and event compared (a changed
                  event counts twice: one missing, one extra);
``order_diff``    places where the program's emission order of those
                  matches breaks the reference's: by the round that
                  completed the match, the key's arrival place in that
                  round, then the reference's own order among one event's
                  matches;
``loss``          the engine's capacity-loss counters summed over every key
                  (the guarantee of no capacity loss);
``miss_unmet``    sampled keys on which the engine counted a missing entry
                  (its own ``slab_missing`` above 0) where the reference
                  met none: an entry the program lost by itself.

Each is an exact comparison with the limit 0.

The client keeps the matches of ``kept_keys`` keys drawn from the seed,
and the sample is three seeded draws among them: ``sample_keys`` keys, and
up to ``sample_overflow_keys`` and ``sample_missing_keys`` of those whose
own ``ver_overflows`` and ``slab_missing`` counters are above 0 once the
window has closed, so that every run compares keys on which the engine cut
version digits and keys on which it met a missing entry.

A missing entry.  With window pruning on, a pruned run's removal can
delete buffer entries that a sibling run still points at; the next put or
walk that reaches one finds nothing.  The reference evaluator fails there
(``KVSharedVersionedBuffer.java:86-89`` throws, ``:102-108`` and
``:147-171`` dereference null) and gives no answer for the key from that
event on.  The port documents one rule for it (a put dropped, a walk
stopped: ``ops/slab.py``, ``nfa/buffer.py``), but its engine and its oracle
do not keep to one rule past that point (``PERF.md``, Open questions), so
a key's matches are compared up to the event at which its reference fails,
the keys cut so are counted (``sample["cut"]``), and ``miss_unmet`` holds
the engine to missing entries where the reference has them.

``ver_overflows`` is not a loss here.  A BEGIN-typed run is exempt from the
window (``NFA.java:347-349``) and the reference lengthens its version by a
digit an event without end (437 digits after 480 events on this traffic),
so no ``dewey_depth`` holds it on an unbounded stream and the
configuration states no such guarantee; what the cut digits could change,
the overflowing keys' matches show.
"""

from __future__ import annotations

from collections import Counter, defaultdict, deque
from typing import Dict, Iterable, List, Tuple

import numpy as np

#: The engine counters that count lost capacity (``engine/sizing.py:
#: _COUNTER_KNOB`` but ``ver_overflows``, see above): runs, slab entries,
#: pointers, walk length and handles dropped.
LOSS_COUNTERS = ("run_drops", "slab_full_drops", "slab_pred_drops", "slab_trunc",
                 "handle_overflows")

LIMITS = {"match_diff": 0, "order_diff": 0, "loss": 0, "miss_unmet": 0}


def _plain(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _plain(x)) for k, x in v.items()))
    return v


def canon(seq) -> Tuple:
    """A match as plain data, stage order and event order kept (the
    buffer walk's: final stage first)."""
    return tuple((stage, tuple((e.timestamp, _plain(e.value)) for e in evs))
                 for stage, evs in seq.as_map().items())


def draw(seed: int, stream: int, candidates, n: int) -> np.ndarray:
    """Up to ``n`` of the arrival places ``candidates``, drawn from the seed
    (``stream`` keeps one draw apart from another)."""
    rng = np.random.default_rng([int(seed) % (1 << 64), int(stream)])
    c = np.asarray(candidates, dtype=np.int64)
    return np.sort(rng.choice(c, size=min(int(n), len(c)), replace=False))


def sample_positions(seed: int, keys: int, n: int) -> np.ndarray:
    """Arrival places of ``n`` keys of all, drawn from the seed."""
    return draw(seed, 7, np.arange(keys), n)


def _buffer_class():
    from portbench.reference.buffer import SharedVersionedBuffer

    class Buffer(SharedVersionedBuffer):
        """The reference's buffer, noting where the reference evaluator
        would fail: a put, branch or walk that finds no entry.  The copy
        goes on as the port's oracle does (the put dropped, the walk
        stopped); ``failed`` says that it has left the reference's
        semantics."""

        failed = False

        def put(self, curr_stage, curr_event, prev_stage, prev_event, version):
            try:
                super().put(curr_stage, curr_event, prev_stage, prev_event, version)
            except RuntimeError:  # "cannot find predecessor event": nothing written
                self.failed = True

        def branch(self, stage, event, version):
            self._note(stage, event, version)
            super().branch(stage, event, version)

        def _peek(self, stage, event, version, remove):
            self._note(stage, event, version)
            return super()._peek(stage, event, version, remove)

        def _note(self, stage, event, version):
            """Whether the walk ``branch`` or ``_peek`` is about to make
            meets a missing entry (the same first-compatible pointer rule,
            read only)."""
            key = (stage.name, stage.type.value, event.topic, event.partition, event.offset)
            while key is not None:
                entry = self.store.get(key)
                if entry is None:
                    self.failed = True
                    return
                nxt = entry.pointer_by_version(version)
                if nxt is None:
                    return
                key, version = nxt.key, nxt.version

    return Buffer


def reference(config: Dict, traffic, positions: Iterable[int], rounds: int,
              topic: str) -> Tuple[List[Tuple[Tuple, int, Tuple]], Dict[int, int]]:
    """The reference's matches of the keys at ``positions`` over the first
    ``rounds`` rounds, in emission order, ``[(order, key, match)]``, and
    for each key whose stream reaches a state the reference evaluator
    fails on, the timestamp of that event: the key's matches are compared
    up to it (the reference gives no answer from there on)."""
    from portbench import query
    from portbench.reference.oracle import OracleNFA
    from portbench.reference.query import Query
    from portbench.reference.stages import compile_pattern

    buffer_class = _buffer_class()
    pattern = query.build(config["query"], Query)
    enforce = bool(config["engine"].get("enforce_windows", False))
    out, cut = [], {}
    for pos in positions:
        pos = int(pos)
        key = int(traffic.key_ids[pos])
        buf = buffer_class()
        nfa = OracleNFA(compile_pattern(pattern), buffer=buf, enforce_windows=enforce)
        for r, (ts, value) in enumerate(traffic.key_events(pos, rounds)):
            got = nfa.match(key, value, ts, topic, 0, r)
            if buf.failed:
                cut[key] = ts
                break
            for i, seq in enumerate(got):
                out.append(((r, pos, i), key, canon(seq)))
    out.sort(key=lambda m: m[0])
    return out, cut


def completed_ts(match: Tuple) -> int:
    """The timestamp of the event that completed a match (``canon`` form:
    the final stage's newest event comes first)."""
    return match[0][1][0][0]


def within(program: List[Tuple[int, Tuple]], cut: Dict[int, int]) -> List[Tuple[int, Tuple]]:
    """The program's matches the reference can judge: each key's up to the
    event its reference fails on."""
    return [(k, m) for k, m in program
            if k not in cut or (m and completed_ts(m) < cut[k])]


def compare(program: List[Tuple[int, Tuple]], ref: List[Tuple[Tuple, int, Tuple]],
            counters: Dict[str, int], missed: Iterable[int] = (),
            cut: Dict[int, int] = None) -> Dict[str, int]:
    """The numbers compared: ``program`` is the sampled keys' matches as
    emitted, ``[(key, match)]``; ``ref`` the reference's, in order;
    ``missed`` the sampled keys on which the engine counted a missing
    entry, ``cut`` those on which the reference met one."""
    got = Counter(program)
    want = Counter((k, m) for _, k, m in ref)
    match_diff = sum((got - want).values()) + sum((want - got).values())
    ranks: Dict[Tuple, deque] = defaultdict(deque)
    for rank, (_, k, m) in enumerate(ref):
        ranks[(k, m)].append(rank)
    seen = [ranks[x].popleft() for x in program if ranks.get(x)]
    order_diff = sum(1 for a, b in zip(seen, seen[1:]) if b < a)
    loss = sum(int(counters.get(c, 0)) for c in LOSS_COUNTERS)
    miss_unmet = sum(1 for k in set(int(k) for k in missed) if k not in (cut or {}))
    return {"match_diff": match_diff, "order_diff": order_diff, "loss": loss,
            "miss_unmet": miss_unmet}


def differing_keys(program, ref) -> List[int]:
    """The sampled keys whose matches differ between the two sides."""
    got = Counter(program)
    want = Counter((k, m) for _, k, m in ref)
    return sorted({k for k, _ in (got - want) + (want - got)})
