"""The key axis sharded over a mesh of device placements.

The counterpart of ``kafkastreams_cep_tpu/parallel/sharding.py``.  Lanes
never exchange data while matching, exactly like the reference's
partitions (``CEPProcessor.java:160``): the JAX package's
``ShardedMatcher`` runs one ``shard_map`` program over the lane blocks and
its only collective is a ``psum`` of integer counters.  Here one process
drives every shard: lane ``k`` lives on shard ``k // (K/n)``, and each
shard is an ordinary :class:`~kafkastreams_cep_tpu_torch.parallel.batch.
BatchMatcher` of ``K/n`` lanes on ``mesh.devices[s]``, so it launches the
same kernels (the walk pass per step, the whole scan under
``CEP_SCAN_KERNEL=1``) on its own lane block and shares its built programs
with every matcher of its device (``utils/tracecache.py``).  The ``psum``
becomes an exact integer sum of the per-shard reductions on the host.

A mesh's devices may repeat: ``key_mesh(["cpu"] * 8)`` is the CPU
counterpart of the JAX test suite's eight virtual devices, and
``key_mesh(["cuda:0"] * 4)`` puts four shards on one card.  A GPU kernel
takes any lane count, so a shard runs the whole-scan kernel whatever
``K/n`` is (the JAX package demotes a shard whose lane count is not a
multiple of its 128-lane block; the outputs are the same either way).

A meshed state is a :class:`ShardedState`: one engine state a shard, on its
device.  :meth:`ShardedMatcher.gather` and :meth:`ShardedMatcher.place_arrays`
are the one pair through which the rest of the runtime reads and writes it
as a whole: a host tree in logical lane order, and back onto the shards.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kafkastreams_cep_tpu_torch.compiler.tables import TransitionTables, lower
from kafkastreams_cep_tpu_torch.engine.matcher import (
    COUNTER_NAMES,
    HOT_COUNTER_NAMES,
    TIER_COUNTER_NAMES,
    WALK_COUNTER_NAMES,
    EngineConfig,
    EngineState,
    EventBatch,
    counter_values,
    hot_counter_values,
    per_lane_counter_arrays,
    resolve_device,
    stage_counter_arrays,
    stage_report,
    walk_counter_values,
)
from kafkastreams_cep_tpu_torch.parallel.batch import BatchMatcher


class ShardLost(RuntimeError):
    """A mesh shard (device) is dead or unreachable.

    Raised by deployment probes or injected at the ``shard.dispatch``
    failpoint; the supervisor's evacuation catches it, shrinks the mesh to
    the survivors (:func:`surviving_mesh`) and restores and replays onto
    the sub-mesh (``runtime/supervisor.py``).  ``shard`` is the dead
    shard's index along the mesh's lane axis."""

    def __init__(self, msg: str = "shard lost", shard: int = 0):
        super().__init__(msg)
        self.shard = int(shard)


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices the lane blocks live on, in shard order."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("keys",)

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def key_mesh(devices: Optional[Sequence] = None, axis: str = "keys") -> Mesh:
    """A 1-D mesh over ``devices`` sharding the key axis.  The default is
    every visible CUDA device (it raises without a GPU); a device may
    repeat (several shards on one card, or on the CPU)."""
    if devices is None:
        _device("cuda")  # raises without a GPU
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = tuple(_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs, (axis,))


def surviving_mesh(mesh: Mesh, dead, num_lanes: int) -> Mesh:
    """The degraded mesh after losing the shards in ``dead``: the largest
    prefix of the survivors whose count divides ``num_lanes`` (lane blocks
    stay equal; one device always qualifies).  Raises when every shard is
    dead."""
    dead = {int(d) for d in dead}
    survivors = [d for i, d in enumerate(mesh.devices) if i not in dead]
    if not survivors:
        raise ValueError("no surviving devices: every mesh shard is dead")
    m = len(survivors)
    while num_lanes % m:
        m -= 1
    return Mesh(tuple(survivors[:m]), mesh.axis_names)


class ShardedState:
    """A meshed engine state: ``shards[s]`` is the :class:`EngineState` of
    lane block ``s``, on ``mesh.devices[s]``."""

    __slots__ = ("shards",)

    def __init__(self, shards):
        self.shards = tuple(shards)


def _tree_map(fn, tree):
    """``fn`` over every tensor or array leaf of NamedTuples, tuples,
    lists and dicts, keeping the structure."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def _tree_cat(trees, cat):
    """Equal-structured trees -> one tree whose leaves are ``cat`` of the
    trees' leaves (lane-wise concatenation)."""
    first = trees[0]
    if hasattr(first, "_fields"):
        return type(first)(*(_tree_cat([t[i] for t in trees], cat)
                             for i in range(len(first))))
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_cat([t[i] for t in trees], cat) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _tree_cat([t[k] for t in trees], cat) for k in first}
    return cat(trees)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ShardedMatcher:
    """``K`` key lanes in ``n`` contiguous blocks over ``mesh``, each block
    a :class:`BatchMatcher` of ``K/n`` lanes on its device.

    ``K`` must be divisible by the mesh size.  ``step``, ``scan``,
    ``sweep`` and ``drain`` run every shard on its block and return the
    state as a :class:`ShardedState` and the outputs gathered in logical
    lane order on the first shard's device (what the JAX package's decode
    pulls from its sharded outputs); ``stats`` and the counter methods are
    exact integer sums over the shards."""

    def __init__(self, pattern, num_lanes: int, mesh: Mesh,
                 config: Optional[EngineConfig] = None):
        tables = pattern if isinstance(pattern, TransitionTables) else lower(pattern)
        n = mesh.size
        if num_lanes % n:
            raise ValueError(f"num_lanes={num_lanes} not divisible by mesh size {n}")
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.num_lanes = int(num_lanes)
        self.per_shard = self.num_lanes // n
        self.shards: List[BatchMatcher] = [
            BatchMatcher(tables, self.per_shard, config, device=d) for d in mesh.devices
        ]
        self.matcher = self.shards[0].matcher
        self.device = self.shards[0].device

    @property
    def names(self):
        return self.matcher.names

    @property
    def uses_scan_kernel(self) -> bool:
        """Whether scans run the whole-scan kernel on every shard
        (``CEP_SCAN_KERNEL``; False once the pattern fell back to the
        per-step path)."""
        return all(b.uses_scan_kernel for b in self.shards)

    def _blocks(self):
        return [(s * self.per_shard, (s + 1) * self.per_shard)
                for s in range(len(self.shards))]

    def init_state(self) -> ShardedState:
        return ShardedState(b.init_state() for b in self.shards)

    def shard_events(self, events: EventBatch) -> List[EventBatch]:
        """A ``[K, ...]`` event batch as one lane block a shard, each on
        its shard's device."""
        return [_tree_map(lambda x, a=a, b=b, d=m.device: x[a:b].to(d), events)
                for (a, b), m in zip(self._blocks(), self.shards)]

    def _parts(self, events):
        return events if isinstance(events, list) else self.shard_events(events)

    def _gathered(self, outs):
        """Per-shard outputs -> one output tree in lane order on the first
        shard's device."""
        return _tree_cat([_tree_map(lambda x: x.to(self.device), o) for o in outs],
                         torch.cat)

    def _each(self, fn, state, events=None):
        """``fn(matcher, shard_state[, shard_events])`` over the shards;
        returns the new ShardedState and the outputs gathered."""
        parts = self._parts(events) if events is not None else [None] * len(self.shards)
        states, outs = [], []
        for b, st, ev in zip(self.shards, state.shards, parts):
            st, out = fn(b, st) if ev is None else fn(b, st, ev)
            states.append(st)
            outs.append(out)
        return ShardedState(states), self._gathered(outs)

    def step(self, state: ShardedState, events):
        """One event a lane (``[K]`` leaves, or :meth:`shard_events` of
        them); returns ``(state, StepOutput [K, ...])``."""
        return self._each(lambda b, st, ev: b.step(st, ev), state, events)

    def scan(self, state: ShardedState, events):
        """A ``[K, T]`` batch (or its :meth:`shard_events`); returns
        ``(state, StepOutput [K, T, ...])``.  A pattern the whole-scan code
        generator cannot express demotes every shard to the per-step path
        at once."""
        def one(b, st, ev):
            if not self.shards[0].uses_scan_kernel:
                b.uses_scan_kernel = False
            return b.scan(st, ev)

        return self._each(one, state, events)

    def sweep(self, state: ShardedState) -> ShardedState:
        """Slab mark-sweep and version renormalization on every shard."""
        return ShardedState(b.sweep(st) for b, st in zip(self.shards, state.shards))

    def drain(self, state: ShardedState):
        """Walk every shard's pending lazy-extraction handles; returns
        ``(state, DrainOutput [K, HB, ...])``."""
        return self._each(lambda b, st: b.drain(st), state)

    # -- the reductions (the JAX package's psum) ---------------------------

    def _summed(self, names, values_of, state) -> Dict[str, int]:
        total = np.zeros(len(names), dtype=np.int64)
        for st in state.shards:
            vals = values_of(st)
            total += torch.stack([v.reshape(-1).sum(dtype=torch.int64) for v in vals]).cpu().numpy()
        return {n: int(v) for n, v in zip(names, total)}

    def stats(self, state: ShardedState) -> Dict[str, int]:
        """Mesh-global totals: the loss counters, ``alive_runs``, the
        hot-tier and the walk counters, summed over every shard."""
        names = COUNTER_NAMES + ("alive_runs",) + HOT_COUNTER_NAMES + WALK_COUNTER_NAMES
        return self._summed(names, lambda st: (counter_values(st) + (st.alive,)
                                               + hot_counter_values(st)
                                               + walk_counter_values(st)), state)

    def counters(self, state: ShardedState) -> Dict[str, int]:
        """Overflow/drop counters summed over all lanes."""
        return self._summed(COUNTER_NAMES, counter_values, state)

    def hot_counters(self, state: ShardedState) -> Dict[str, int]:
        """Two-tier residency counters summed over all lanes."""
        return self._summed(HOT_COUNTER_NAMES, hot_counter_values, state)

    def walk_counters(self, state: ShardedState) -> Dict[str, int]:
        """Walk-cost counters summed over all lanes."""
        return self._summed(WALK_COUNTER_NAMES, walk_counter_values, state)

    def stage_counters(self, state: ShardedState) -> Dict[str, Dict[str, Any]]:
        """Per-stage attribution totals over every shard (the four tallies
        and the stage hops, ``[5, S]`` merged by integer addition); empty
        when attribution is off.  Like the JAX package's sharded matcher,
        it carries no per-conjunct rows."""
        parts = [stage_counter_arrays(st) for st in state.shards]
        if not parts[0]:
            return {}
        merged = {n: np.concatenate([p[n] for p in parts]) for n in parts[0]}
        return stage_report(merged, self.names)

    def per_lane_counters(self, state: ShardedState) -> Dict[str, list]:
        """Per-lane loss, hot-tier and walk counters ``{name: [K ints]}``
        in logical lane order (lane ``k`` on shard ``k // (K/n)``)."""
        parts = [per_lane_counter_arrays(st) for st in state.shards]
        return {n: np.concatenate([p[n].reshape(-1) for p in parts]).tolist()
                for n in parts[0]}

    def metrics_snapshot(self, state: ShardedState, watermark=None, clock=None,
                         ledgers=None) -> Dict[str, Any]:
        """Mesh-global engine telemetry in one dict: ``stats``, the tier
        counters as structural zeros (a mesh refuses tiering), ``per_lane``,
        ``per_stage`` under attribution; ``watermark`` (absolute ms) adds
        the watermark and event-time-lag gauges on ``clock`` (default
        ``time.time``), and ``ledgers`` (latency ledgers) fold into one
        ``latency`` entry through ``LatencyLedger.merge``."""
        out: Dict[str, Any] = dict(self.stats(state))
        out.update({n: 0 for n in TIER_COUNTER_NAMES})
        out["per_lane"] = self.per_lane_counters(state)
        per_stage = self.stage_counters(state)
        if per_stage:
            out["per_stage"] = per_stage
        if watermark is not None:
            now = clock if clock is not None else time.time
            out["watermark"] = int(watermark)
            out["event_time_lag_ms"] = int(now() * 1000) - int(watermark)
        if ledgers:
            merged = None
            for led in ledgers:
                merged = led if merged is None else merged.merge(led)
            out["latency"] = merged.snapshot()
        return out

    # -- the state as a whole -------------------------------------------------

    def gather(self, state: ShardedState) -> EngineState:
        """The state as one host tree (numpy leaves) in logical lane order."""
        return _tree_cat([_tree_map(_host, st) for st in state.shards], np.concatenate)

    def gather_leaves(self, state: ShardedState, pick) -> Tuple[np.ndarray, ...]:
        """``pick(shard_state)``'s tensors, each as one host array in
        logical lane order (a few leaves without gathering the rest)."""
        parts = [[_host(x) for x in pick(st)] for st in state.shards]
        return tuple(np.concatenate(cols) for cols in zip(*parts))

    def place_arrays(self, arrays: Dict[str, np.ndarray],
                     like: Optional[ShardedState] = None) -> ShardedState:
        """``state_arrays`` of a whole ``[K, ...]`` state (a checkpoint's
        arrays) onto the shards, every leaf checked against the shard
        engine's shape and dtype (``like``'s, or a fresh state's)."""
        from kafkastreams_cep_tpu_torch.convert import state_from_arrays

        lead = {k: np.asarray(v) for k, v in arrays.items()}
        for k, v in lead.items():
            if v.ndim == 0 or v.shape[0] != self.num_lanes:
                raise ValueError(f"state array {k!r} of shape {v.shape} has no "
                                 f"leading [{self.num_lanes}] lane axis")
        shards = []
        for s, ((a, b), m) in enumerate(zip(self._blocks(), self.shards)):
            template = like.shards[s] if like is not None else m.init_state()
            shards.append(state_from_arrays({k: v[a:b] for k, v in lead.items()}, template))
        return ShardedState(shards)
