"""Programmatic profiler CLI: ``python -m kafkastreams_cep_tpu_torch.profile``.

The counterpart of ``kafkastreams_cep_tpu/profile/__init__.py`` over this
package: each subcommand prints exactly one JSON object on stdout and its
diagnostics on stderr, so reports and gates read the profiler's output
instead of scraping logs.

Subcommands
-----------

``step``         K-scaling of the headline scan (``bench.py:347-349``'s
                 config over the stock trace): ms a scan and a step,
                 events/s, the walk-pass (B1) launches of the scans.
``phases``       B1 alone on real inputs, in each mode the headline and
                 lazy steps launch (the headline step, the lazy path's
                 two-tier + attribution step and its drain): ms beside the
                 bound ``chip_smoke.py: bound`` computes (the bytes each
                 call must move over the memory rate against its hops'
                 operations over the 32-bit rate), plus the tiered
                 matcher's chunk-gate dispatch fraction.
``ablate``       the in-context ablation, each variant in its own process
                 (started together, run in turns): the chain alone
                 (no slab phase), the chain with B1's copies only (every
                 walker off, no puts), the chain with B1's copies and puts
                 (every walker off), the full step.
``selectivity``  per-stage selectivity and cost (``stage_attribution``),
                 per-key heavy hitters, the tiering tag with the lazy-chain
                 order derived from the run, and the attribution on/off A/B.
``latency``      a ledgered ``CEPProcessor`` over synthetic stock batches:
                 per-segment percentiles, SLO burn, exemplars, and each
                 kernel's device time in the timed batches from
                 ``torch.profiler`` beside its bound; ``--trace-dir`` writes
                 the profiler's chrome trace.

Every subcommand takes the size options ``--k/--t/--reps`` and ``--seed``
(``latency`` also ``--batches``, ``--grace-ms``, ``--slo-ms``,
``--drain-interval``) with the JAX package's names and defaults, and
``--device`` (``cuda`` by default; ``cpu`` runs the plain versions, which
is how the tests drive tiny shapes), and ``--wait-go`` (turns, below).  Times on the card are device times
where one kernel is timed and host wall time around a synchronize where a
path is; on the CPU they are host wall times of the plain versions.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

#: The card's memory rate and its 32-bit rate outside the tensor cores
#: (H100 SXM data sheet), the rates ``chip_smoke.py`` bounds kernels with.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12

#: ``bench.py:347-349``: the headline config.
HEADLINE = dict(max_runs=24, slab_entries=48, slab_preds=8, dewey_depth=12, max_walk=12)
#: ``bench.py:612-630``'s lazy A/B config with stage attribution
#: (``chip_smoke.py: LAZY_PATH``).
LAZY_PATH = dict(HEADLINE, slab_entries=96, slab_hot_entries=16, lazy_extraction=True,
                 handle_ring=512, stage_attribution=True)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _device(name: str):
    from kafkastreams_cep_tpu_torch.engine.matcher import resolve_device

    return resolve_device(name)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stock_pattern():
    """The stock demo's query (``CEPStockKStreamsDemo.java:37-53``), the
    port's own copy of ``examples/stock_demo.py: stock_pattern``."""
    from kafkastreams_cep_tpu_torch import Query

    return (
        Query()
        .select()
        .where(lambda k, v, ts, st: v["volume"] > 1000)
        .fold("avg", lambda k, v, curr: v["price"])
        .then()
        .select()
        .zero_or_more()
        .skip_till_next_match()
        .where(lambda k, v, ts, st: v["price"] > st.get("avg"))
        .fold("avg", lambda k, v, curr: (curr + v["price"]) // 2)
        .fold("volume", lambda k, v, curr: v["volume"])
        .then()
        .select()
        .skip_till_next_match()
        .where(lambda k, v, ts, st: v["volume"] < 0.8 * st.get_or_else("volume", 0))
        .within(1, "h")
        .build()
    )


def stock_events(K: int, T: int, device, seed: int = 42):
    """``bench.py: make_batch``'s trace: random prices and volumes, ``[K, T]``."""
    import torch

    from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch

    rng = np.random.default_rng(seed)
    prices = rng.integers(90, 131, size=(K, T)).astype(np.int32)
    volumes = rng.integers(600, 1101, size=(K, T)).astype(np.int32)
    i32 = torch.int32
    return EventBatch(
        key=torch.arange(K, dtype=i32, device=device)[:, None].expand(K, T),
        value={"price": torch.as_tensor(prices, device=device),
               "volume": torch.as_tensor(volumes, device=device)},
        ts=(torch.arange(T, dtype=i32, device=device) * 2)[None, :].expand(K, T),
        off=torch.arange(T, dtype=i32, device=device)[None, :].expand(K, T),
        valid=torch.ones((K, T), dtype=torch.bool, device=device),
    )


def _window(events, t0: int, t1: int):
    """Steps ``[t0, t1)`` of a ``[K, T]`` batch."""
    value = events.value
    return type(events)(
        events.key[:, t0:t1],
        {k: v[:, t0:t1] for k, v in value.items()} if isinstance(value, dict)
        else value[:, t0:t1],
        events.ts[:, t0:t1], events.off[:, t0:t1], events.valid[:, t0:t1])


def _timed_scan(batch, state0, events, reps: int):
    """``(best s, first s, state, out)`` of ``batch.scan`` on ``events`` from
    ``state0``: host wall time around each scan, ended by a host read of
    the output counts (so the device work is inside it)."""
    t0 = time.perf_counter()
    state, out = batch.scan(state0, events)
    int(out.count.sum())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(max(reps, 1)):
        del state, out  # one scan's outputs on the device at a time
        t0 = time.perf_counter()
        state, out = batch.scan(state0, events)
        int(out.count.sum())
        best = min(best, time.perf_counter() - t0)
    return best, first, state, out


def _walk_launches() -> int:
    from kafkastreams_cep_tpu_torch.ops.walk_kernel import walk_pass_kernel

    return walk_pass_kernel.launches


def _nbytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def _bound(moved: int, hops: int, E: int, MP: int, D: int):
    """``(bound_ms, bound_by)``: ``moved`` bytes over the memory rate against
    ``hops`` compares and version checks over the 32-bit rate
    (``chip_smoke.py: bound``)."""
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = hops * (2 * E + MP * 3 * D) / INT_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def walk_call_cost(args, kw, out):
    """``(bytes moved, hops)`` of one walk-pass call: the mode's slab leaves
    read and written, its other inputs read, its outputs written once."""
    from kafkastreams_cep_tpu_torch.ops import walk_kernel

    slab_in, slab_out = args[0], out[0]
    leaves = walk_kernel.mode_fields(kw.get("hot_entries", 0), slab_in.stage_hops.shape[1],
                                     kw.get("drain", False))
    puts = kw.get("put_ops")
    other = list(args[1:8]) + (list(puts) + [kw["ev_off"]] if puts is not None else [])
    moved = (_nbytes(getattr(slab_in, f) for f in leaves)
             + _nbytes(getattr(slab_out, f) for f in leaves) + _nbytes(other)
             + _nbytes(out[1:]))
    hops = sum((getattr(slab_out, c) - getattr(slab_in, c)).sum()
               for c in ("walk_hops", "extract_hops", "drain_hops"))
    return moved, hops


def scan_call_cost(config, state_in, events, state_out, out):
    """``(bytes moved, hops)`` of one whole scan: each state leaf its
    instance writes, in and out, the events in and the output frames out
    (``chip_smoke.py: scan_bound``)."""
    from kafkastreams_cep_tpu_torch.ops import scan_codegen, scan_kernel

    def leaf(st, f):
        return getattr(st.slab, f) if f in st.slab._fields else getattr(st, f)

    written = scan_kernel.mode_fields(config)
    ev = [events.key, events.ts, events.off, events.valid,
          *scan_codegen.value_leaves(events.value)]
    moved = (_nbytes(leaf(state_in, f) for f in written)
             + _nbytes(leaf(state_out, f) for f in written) + _nbytes(ev) + _nbytes(out))
    hops = sum((getattr(state_out.slab, c) - getattr(state_in.slab, c)).sum()
               for c in ("walk_hops", "extract_hops"))
    return moved, hops


class _Capture:
    """Stands in for a walk-pass callable: records each call's arguments
    and forwards it."""

    def __init__(self, target):
        self.target = target
        self.calls: list = []

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return self.target(*args, **kw)


@contextlib.contextmanager
def _captured_walks(device):
    """The walk-pass calls the enclosed block makes (the kernel's on CUDA
    tensors, the plain version's on the CPU), recorded."""
    from kafkastreams_cep_tpu_torch.ops import walk_kernel

    name = "walk_pass_kernel" if device.type == "cuda" else "walk_pass_plain"
    real = getattr(walk_kernel, name)
    cap = _Capture(real)
    setattr(walk_kernel, name, cap)
    try:
        yield cap
    finally:
        setattr(walk_kernel, name, real)


def _walk_ms(fn, device, reps: int) -> float:
    """ms a call of ``fn``: on the card, device time of ``reps`` calls
    queued behind a spin (``chip_smoke.py: kernel_ms``: the events time the
    launches, not the wrapper's host work); on the CPU, the best wall time."""
    import torch

    fn()
    _sync(device)
    if device.type != "cuda":
        best = float("inf")
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6) * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# step: K-scaling
# ---------------------------------------------------------------------------


def run_step(args) -> Dict[str, Any]:
    from kafkastreams_cep_tpu_torch import EngineConfig
    from kafkastreams_cep_tpu_torch.parallel.batch import BatchMatcher

    device = _device(args.device)
    cfg = EngineConfig(**HEADLINE)
    pattern = stock_pattern()
    T = args.t
    points: List[Dict[str, Any]] = []
    for K in [int(x) for x in str(args.k).split(",")]:
        batch = BatchMatcher(pattern, K, cfg, device=device)
        events = stock_events(K, T, device, args.seed)
        before = _walk_launches()
        best, first, _, _ = _timed_scan(batch, batch.init_state(), events, args.reps)
        launches = _walk_launches() - before
        pt = {
            "k": K, "t": T,
            "scan_ms": round(best * 1e3, 3),
            "ms_per_step": round(best / T * 1e3, 4),
            "evps": round(K * T / best, 1),
            "first_scan_s": round(first, 3),
            "scans": max(args.reps, 1) + 1,
            "walk_pass_launches": launches,
        }
        points.append(pt)
        _log(f"K={K:6d} T={T}: scan {pt['scan_ms']:9.2f} ms ({pt['ms_per_step']:7.3f} "
             f"ms/step, {pt['evps'] / 1e3:9.1f}K ev/s) [first scan {first:.2f} s]")
    return {"profile": "step", "device": str(device), "points": points}


# ---------------------------------------------------------------------------
# phases: B1 alone on real inputs
# ---------------------------------------------------------------------------


def _walk_row(mode_on: str, call, device, reps: int) -> Dict[str, Any]:
    from kafkastreams_cep_tpu_torch.ops import walk_kernel

    (a, kw), target = call
    out = target(*a, **kw)
    moved, hops = walk_call_cost(a, kw, out)
    hops = int(hops)
    E, MP, D = a[0].pver.shape[1:]
    bound_ms, bound_by = _bound(moved, hops, E, MP, D)
    mode = walk_kernel.mode_name(kw.get("hot_entries", 0), a[0].stage_hops.shape[1],
                                 kw.get("drain", False), walk_kernel.is_wide(MP, D))
    ms = _walk_ms(lambda: target(*a, **kw), device, reps)
    row = {"kernel": "B1", "name": f"walk_pass[{mode}]" if mode != "default" else "walk_pass",
           "mode": mode, "on": mode_on, "ms": round(ms, 4), "bound_ms": round(bound_ms, 5),
           "bound_by": bound_by, "mb": round(moved / 1e6, 3), "hops": hops,
           "timed": "device" if device.type == "cuda" else "host (plain version)"}
    _log(f"{row['name']:34s} on {mode_on}: {ms:8.4f} ms, bound {bound_ms:.4f} ms "
         f"({bound_by}, {moved / 1e6:.1f} MB, {hops} hops)")
    return row


def run_phases(args) -> Dict[str, Any]:
    from kafkastreams_cep_tpu_torch import EngineConfig
    from kafkastreams_cep_tpu_torch.engine.matcher import step_events
    from kafkastreams_cep_tpu_torch.parallel.batch import BatchMatcher

    device = _device(args.device)
    K, T = int(args.k), max(int(args.t), 8)
    half = T // 2
    pattern = stock_pattern()
    events = stock_events(K, T, device, args.seed)
    rows = []

    def captured(step):
        """The walk-pass call of ``step()``.  The warm-up scans run before,
        uncaptured, their outputs dropped: a capture keeps its calls'
        tensors alive."""
        with _captured_walks(device) as cap:
            step()
        return cap.calls[-1], cap.target

    # The headline step at T/2 (chip_smoke.py's step 128 at T=256).
    bm = BatchMatcher(pattern, K, EngineConfig(**HEADLINE), device=device)
    mid = bm.scan(bm.init_state(), _window(events, 0, half))[0]
    rows.append(_walk_row(f"the headline step {half}, K={K}",
                          captured(lambda: bm.step(mid, step_events(events, half))),
                          device, args.reps))
    # The lazy path: a drain a quarter in, its step at T/2 and the drain of
    # the ring it holds there.
    lbm = BatchMatcher(pattern, K, EngineConfig(**LAZY_PATH), device=device)
    st = lbm.scan(lbm.init_state(), _window(events, 0, half // 2))[0]
    st = lbm.drain(st)[0]
    st = lbm.scan(st, _window(events, half // 2, half))[0]
    rows.append(_walk_row(f"the lazy path's step {half}, E=96, K={K}",
                          captured(lambda: lbm.step(st, step_events(events, half))),
                          device, args.reps))
    rows.append(_walk_row(f"the lazy path's ring at step {half}, K={K}",
                          captured(lambda: lbm.drain(st)), device, args.reps))
    gate = _measure_dispatch_gate(K, T, args.reps, device)
    return {"profile": "phases", "device": str(device), "k": K, "t": T, "kernels": rows,
            "dispatch_gate": gate}


def _measure_dispatch_gate(K: int, T: int, reps: int, device) -> Dict[str, Any]:
    """The tiered matcher's chunk gate: NFA chunks dispatched over chunks
    offered on a hybrid plan (a strict prefix plus a Kleene stage) over a
    trace with a full match planted at the head of every other
    ``gate_chunk``-step segment, noise elsewhere: about 0.5 by
    construction when the gate elides the quiet chunks."""
    import torch

    from kafkastreams_cep_tpu_torch import EngineConfig, Query
    from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch
    from kafkastreams_cep_tpu_torch.parallel.tiered import TieredBatchMatcher

    def val(code):
        return lambda k, v, ts, st: v == code

    pattern = (Query().select("a").where(val(0)).then().select("b").where(val(1))
               .then().select("c").one_or_more().where(val(2))
               .then().select("d").where(val(3)).build())
    cfg = EngineConfig(**dict(HEADLINE, tiering=True))
    batch = TieredBatchMatcher(pattern, K, cfg, device=device)
    C = max(int(cfg.gate_chunk), 1)
    vals = np.full((K, T), 4, np.int32)
    for c0 in range(0, T, 2 * C):
        if c0 + 4 <= T:
            vals[:, c0:c0 + 4] = np.array([0, 1, 2, 3], np.int32)
    i32 = torch.int32
    events = EventBatch(
        key=torch.arange(K, dtype=i32, device=device)[:, None].expand(K, T),
        value=torch.as_tensor(vals, device=device),
        ts=(torch.arange(T, dtype=i32, device=device) * 2)[None, :].expand(K, T),
        off=torch.arange(T, dtype=i32, device=device)[None, :].expand(K, T),
        valid=torch.ones((K, T), dtype=torch.bool, device=device),
    )
    state = batch.init_state()
    for _ in range(max(reps, 1)):
        state, out = batch.scan(state, events)
    _sync(device)
    calls, chunks, dispatches = batch.scan_calls, batch.gate_chunks, batch.nfa_dispatches
    denom = chunks or calls
    row = {"tier": str(batch.plan.tier), "scan_calls": calls, "gate_chunks": chunks,
           "nfa_dispatches": dispatches,
           "nfa_dispatch_fraction": round(dispatches / denom, 4) if denom else None}
    _log(f"dispatch_gate: tier={row['tier']} chunks={chunks} nfa_dispatches={dispatches} "
         f"fraction={row['nfa_dispatch_fraction']}")
    return row


# ---------------------------------------------------------------------------
# ablate: the in-context ablation, a process a variant
# ---------------------------------------------------------------------------

#: ``A``: the chain alone (no slab phase); ``B``: B1 with its copies only
#: (every walker off, no puts); ``C``: copies and puts (every walker off);
#: ``D``: the full step.
ABLATE_VARIANTS = ("A", "B", "C", "D")


def _ablated_walk(which: str, real):
    """The walk pass of variant ``which`` over ``real``."""
    import torch

    def chain_only(slab, en, stage, off, ver, vlen, is_remove, want_out, max_walk,
                   out_base, out_rows, **kw):
        K = stage.shape[0]
        full = torch.full((K, out_rows, max_walk), -1, dtype=stage.dtype, device=stage.device)
        return slab, full, full.clone(), torch.zeros((K, out_rows), dtype=stage.dtype,
                                                     device=stage.device)

    def walkers_off(slab, en, *a, puts: bool, **kw):
        if not puts:
            kw["put_ops"] = None
        return real(slab, torch.zeros_like(en), *a, **kw)

    if which == "A":
        return chain_only
    if which in ("B", "C"):
        return lambda *a, **kw: walkers_off(*a, puts=which == "C", **kw)
    return real


def _run_ablate_variant(which: str, K: int, T: int, reps: int, device, seed: int) -> float:
    from kafkastreams_cep_tpu_torch import EngineConfig
    from kafkastreams_cep_tpu_torch.engine import matcher
    from kafkastreams_cep_tpu_torch.parallel.batch import BatchMatcher

    real = matcher.walk_pass
    # The step binds the walk pass when its matcher is built.
    matcher.walk_pass = _ablated_walk(which, real)
    try:
        batch = BatchMatcher(stock_pattern(), K, EngineConfig(**HEADLINE), device=device)
        best, first, _, _ = _timed_scan(batch, batch.init_state(),
                                        stock_events(K, T, device, seed), reps)
    finally:
        matcher.walk_pass = real
    _log(f"ablate[{which}]: best {best * 1e3:.1f} ms (first scan {first:.2f} s)")
    return best


# ---------------------------------------------------------------------------
# Turns: several profiler processes on one card, started together
# ---------------------------------------------------------------------------
#
# A process started with ``--wait-go PREFIX`` sets itself up (imports, the
# device's context, the walk-pass library), creates ``PREFIX.ready`` and
# waits until ``PREFIX.go`` exists before it measures anything.  A caller
# that starts several (``start_waiting``) pays their start-ups at once and
# runs them one at a time (``run_in_turn``), so no two measure together.


def _setup(device) -> None:
    """What a process does before its turn: the device's context and, on
    the card, the walk-pass library loaded."""
    import torch

    torch.zeros(1, device=device)
    if device.type == "cuda":
        from kafkastreams_cep_tpu_torch.ops.walk_kernel import walk_pass_kernel

        walk_pass_kernel.build()
    _sync(device)


def _wait_turn(prefix: str) -> None:
    """Create ``prefix.ready`` and wait for ``prefix.go``; exit if the
    process that started this one is gone (nobody would start the turn)."""
    parent = os.getppid()
    open(prefix + ".ready", "w").close()
    while not os.path.exists(prefix + ".go"):
        if os.getppid() != parent:
            sys.exit(1)
        time.sleep(0.02)


def start_waiting(cmds, workdir: str, envs=None, cwd=None) -> List[tuple]:
    """Start every command of ``cmds`` (argument lists of this CLI, without
    ``--wait-go``) at once, each with ``--wait-go`` under ``workdir`` (and
    ``envs[i]`` added to its environment): ``[(process, prefix)]``, returned
    at once while they set themselves up."""
    started = []
    for i, cmd in enumerate(cmds):
        prefix = os.path.join(workdir, f"turn{i}")
        env = dict(os.environ, **(envs[i] if envs else {}))
        proc = subprocess.Popen(
            [sys.executable, "-m", "kafkastreams_cep_tpu_torch.profile", *cmd,
             "--wait-go", prefix],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=cwd)
        started.append((proc, prefix))
    return started


def wait_ready(started) -> None:
    """Wait until every started process is set up (or has exited)."""
    for proc, prefix in started:
        while not os.path.exists(prefix + ".ready") and proc.poll() is None:
            time.sleep(0.02)


def run_in_turn(proc, prefix: str):
    """Let one started process measure, alone, once it is set up:
    ``(returncode, stdout, stderr)``."""
    wait_ready([(proc, prefix)])
    open(prefix + ".go", "w").close()
    out, err = proc.communicate()
    return proc.returncode, out, err


def run_ablate(args) -> Dict[str, Any]:
    import tempfile

    K, T = int(args.k), args.t
    if args.variant:
        best = _run_ablate_variant(args.variant, K, T, args.reps, _device(args.device),
                                   args.seed)
        return {"profile": "ablate-variant", "variant": args.variant, "best_s": best}
    _device(args.device)  # raises here, not four times, without the device
    results: Dict[str, float] = {}
    with tempfile.TemporaryDirectory(prefix="cep_ablate_") as work:
        started = start_waiting(
            [["ablate", "--variant", v, "--k", str(K), "--t", str(T), "--reps",
              str(args.reps), "--device", args.device, "--seed", str(args.seed)]
             for v in ABLATE_VARIANTS], work)
        if args.wait_go:  # this process's own turn, after its variants' set-up
            wait_ready(started)
            _wait_turn(args.wait_go)
        for v, (proc, prefix) in zip(ABLATE_VARIANTS, started):
            rc, out, err = run_in_turn(proc, prefix)
            for line in err.splitlines():
                _log(line)
            try:
                results[v] = float(json.loads(out.strip().splitlines()[-1])["best_s"])
            except (IndexError, KeyError, ValueError):
                _log(f"ablate[{v}]: no result (rc={rc})")
    if len(results) < len(ABLATE_VARIANTS):
        return {"profile": "ablate", "error": "incomplete", "raw": results}
    a, b, c, d = (results[v] for v in ABLATE_VARIANTS)

    def part(t):
        return {"ms_per_step": round(t / T * 1e3, 4), "share": round(t / d, 4)}

    breakdown = {"chain": part(a), "walk_pass_copies": part(b - a),
                 "walk_pass_puts": part(c - b), "walk_pass_walkers": part(d - c)}
    _log(f"ablation K={K} T={T}: {d / T * 1e3:.3f} ms/step in all; " + ", ".join(
        f"{n} {v['share']:.3f}" for n, v in breakdown.items()))
    return {"profile": "ablate", "device": args.device, "k": K, "t": T,
            "total_ms_per_step": round(d / T * 1e3, 4), "breakdown": breakdown,
            "best_s": results}


# ---------------------------------------------------------------------------
# selectivity: the continuous-profiling readout
# ---------------------------------------------------------------------------


def run_selectivity(args) -> Dict[str, Any]:
    from kafkastreams_cep_tpu_torch import EngineConfig
    from kafkastreams_cep_tpu_torch.compiler.tables import lower
    from kafkastreams_cep_tpu_torch.compiler.tiering import apply_lazy_order, plan_tiering
    from kafkastreams_cep_tpu_torch.engine.matcher import per_lane_counter_arrays
    from kafkastreams_cep_tpu_torch.parallel.batch import BatchMatcher

    device = _device(args.device)
    K, T = int(args.k), args.t
    pattern = stock_pattern()
    base = EngineConfig(max_runs=args.runs, slab_entries=args.slab, slab_preds=8,
                        dewey_depth=12, max_walk=12)
    events = stock_events(K, T, device, args.seed)
    off_b = BatchMatcher(pattern, K, base, device=device)
    best_off, first_off, _, _ = _timed_scan(off_b, off_b.init_state(), events, args.reps)
    on_b = BatchMatcher(pattern, K, dataclasses.replace(base, stage_attribution=True),
                        device=device)
    best_on, first_on, state, _ = _timed_scan(on_b, on_b.init_state(), events, args.reps)
    overhead = (best_on - best_off) / best_off * 100.0
    per_stage = on_b.stage_counters(state)
    tables = lower(pattern)
    _, lazy_report = apply_lazy_order(tables, per_stage)
    tier_tag = {"stock": {**plan_tiering(tables, base).describe(), "lazy_order": lazy_report}}
    arrays = per_lane_counter_arrays(state)
    hops = (arrays["walk_hops"] + arrays["extract_hops"] + arrays["drain_hops"]).reshape(-1)
    total = int(hops.sum())
    order = np.argsort(hops, kind="stable")[::-1][:8]
    per_key = {"total_hops": total, "top": [
        {"key": str(int(lane)), "lane": int(lane), "hops": int(hops[lane]),  # key == lane
         "share": round(float(hops[lane]) / total, 4) if total else 0.0}
        for lane in order if hops[lane] > 0]}
    _log(f"selectivity (K={K}, T={T}): attribution off {K * T / best_off / 1e3:.0f}K ev/s "
         f"vs on {K * T / best_on / 1e3:.0f}K ev/s: overhead {overhead:.2f}%")
    for stage, row in per_stage.items():
        _log(f"  stage {stage}: {row}")
    return {"profile": "selectivity", "device": str(device), "k": K, "t": T,
            "evps_attr_off": round(K * T / best_off, 1),
            "evps_attr_on": round(K * T / best_on, 1),
            "overhead_pct": round(overhead, 2), "per_stage": per_stage, "per_key": per_key,
            "tier": tier_tag,
            "first_scan_s": {"off": round(first_off, 3), "on": round(first_on, 3)}}


# ---------------------------------------------------------------------------
# latency: end-to-end latency attribution
# ---------------------------------------------------------------------------


class _Meter:
    """Stands in for a kernel wrapper while the timed batches run: forwards
    every call and attribute, and adds up each call's bytes moved (host
    metadata) and hops (a device sum, read once at the end)."""

    def __init__(self, target, cost):
        self._target, self._cost = target, cost
        self.calls, self.moved, self.hops, self.shape = 0, 0, 0, None

    def __getattr__(self, name):
        return getattr(self._target, name)

    def __call__(self, *args, **kw):
        out = self._target(*args, **kw)
        moved, hops, shape = self._cost(args, kw, out)
        self.calls += 1
        self.moved += moved
        self.hops = self.hops + hops
        self.shape = shape
        return out


def _walk_meter_cost(args, kw, out):
    moved, hops = walk_call_cost(args, kw, out)
    return moved, hops, tuple(args[0].pver.shape[1:])


def _scan_meter_cost(args, kw, out):
    source, config, state, events = args[:4]
    moved, hops = scan_call_cost(config, state, events, out[0], out[1])
    E, MP = state.slab.pstage.shape[1:]
    return moved, hops, (E, MP, state.ver.shape[2])


@contextlib.contextmanager
def _metered_kernels():
    from kafkastreams_cep_tpu_torch.ops import scan_kernel, walk_kernel

    meters = {"walk_pass": _Meter(walk_kernel.walk_pass_kernel, _walk_meter_cost),
              "scan_pass": _Meter(scan_kernel.scan_pass_kernel, _scan_meter_cost)}
    real = (walk_kernel.walk_pass_kernel, scan_kernel.scan_pass_kernel)
    walk_kernel.walk_pass_kernel, scan_kernel.scan_pass_kernel = (meters["walk_pass"],
                                                                  meters["scan_pass"])
    try:
        yield meters
    finally:
        walk_kernel.walk_pass_kernel, scan_kernel.scan_pass_kernel = real


def device_kernels(prof) -> Dict[str, Dict[str, Any]]:
    """The device kernels of a ``torch.profiler`` run by name: calls and
    summed device ms (empty when the trace holds no device time)."""
    rows: Dict[str, Dict[str, Any]] = {}
    for e in prof.events():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        span = e.time_range.end - e.time_range.start
        if span <= 0:
            continue
        row = rows.setdefault(e.name, {"calls": 0, "ms": 0.0})
        row["calls"] += 1
        row["ms"] += span / 1e3
    return rows


def _kernel_of(name: str) -> Optional[str]:
    """Which of this package's kernels a device kernel's (mangled) name is."""
    low = name.lower()
    if "walk_pass" in low or "walkpass" in low:
        return "walk_pass"
    if "scan_pass" in low or "scanpass" in low:
        return "scan_pass"
    return None


def _latency_records(K: int, T: int, rng, ts0: int):
    """One batch of ``K * T`` stock records (JAX's ``run_latency`` draws,
    in its order): keys round-robin over ``K``, timestamps 1-2 ms apart."""
    from kafkastreams_cep_tpu_torch.runtime.processor import Record

    records, ts = [], ts0
    for i in range(K * T):
        ts += int(rng.integers(1, 3))
        records.append(Record(key=int(i % K), value={
            "price": int(rng.integers(90, 131)), "volume": int(rng.integers(600, 1101))},
            timestamp=ts))
    return records, ts


def run_latency(args) -> Dict[str, Any]:
    import torch

    from kafkastreams_cep_tpu_torch import EngineConfig
    from kafkastreams_cep_tpu_torch.runtime.ingest import IngestPolicy
    from kafkastreams_cep_tpu_torch.runtime.processor import CEPProcessor
    from kafkastreams_cep_tpu_torch.utils import metrics as metrics_mod
    from kafkastreams_cep_tpu_torch.utils.latency import LatencyLedger, SLOTracker

    device = _device(args.device)
    K, T = int(args.k), args.t
    ingest = (IngestPolicy(grace_ms=args.grace_ms, reorder_depth=max(4 * K * T, 64))
              if args.grace_ms > 0 else None)
    ledger = LatencyLedger(slo=SLOTracker(threshold_s=args.slo_ms / 1e3))
    proc = CEPProcessor(stock_pattern(), K, EngineConfig(**HEADLINE), ingest=ingest,
                        latency=ledger, drain_interval=args.drain_interval, device=device)
    rng = np.random.default_rng(args.seed)
    batches, ts = [], 0
    for _ in range(args.batches):
        recs, ts = _latency_records(K, T, rng, ts)
        batches.append(recs)
    # The profiler reads the device's kernels; on the CPU there are none,
    # and it runs only to write a trace that was asked for.
    if args.trace_dir:
        capture = metrics_mod.profile(args.trace_dir)
    elif device.type == "cuda":
        from torch.profiler import ProfilerActivity

        capture = torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    else:
        capture = contextlib.nullcontext()
    matches = 0
    t0 = time.perf_counter()
    with _metered_kernels() as meters, capture as prof:
        for recs in batches:
            matches += len(proc.process(recs))
        matches += len(proc.flush())
        _sync(device)
    wall_s = time.perf_counter() - t0
    snap = proc.metrics_snapshot(per_lane=False)
    lat = snap.get("latency") or {}
    segments = {name: {k: seg[k] for k in ("count", "p50", "p95", "p99", "p999") if k in seg}
                for name, seg in (lat.get("segments") or {}).items()}
    by_name = device_kernels(prof) if prof is not None else {}
    device_cost: Dict[str, Any] = {"kernels": {}, "other_device_ms": 0.0,
                                   "wall_s": round(wall_s, 4)}
    for name, row in by_name.items():
        which = _kernel_of(name)
        if which is None:
            device_cost["other_device_ms"] += row["ms"]
            continue
        agg = device_cost["kernels"].setdefault(which, {"calls": 0, "ms": 0.0})
        agg["calls"] += row["calls"]
        agg["ms"] += row["ms"]
    device_cost["other_device_ms"] = round(device_cost["other_device_ms"], 4)
    for which, meter in meters.items():
        if not meter.calls:
            continue
        E, MP, D = meter.shape
        hops = int(meter.hops)
        bound_ms, bound_by = _bound(meter.moved, hops, E, MP, D)
        row = device_cost["kernels"].setdefault(which, {"calls": 0, "ms": None})
        row.update(kernel="B1" if which == "walk_pass" else "B2", launches=meter.calls,
                   bound_ms=round(bound_ms, 5), bound_by=bound_by,
                   mb=round(meter.moved / 1e6, 3), hops=hops)
        if row["ms"] is not None:
            row["ms"] = round(row["ms"], 4)
    for name, seg in segments.items():
        _log(f"latency[{name}]: n={seg.get('count', 0)} p50={seg.get('p50')} "
             f"p99={seg.get('p99')}")
    for which, row in device_cost["kernels"].items():
        _log(f"device[{which}]: {row}")
    return {"profile": "latency", "device": str(device), "k": K, "t": T,
            "batches": args.batches, "drain_interval": args.drain_interval,
            "grace_ms": args.grace_ms, "matches": matches, "segments": segments,
            "slo": lat.get("slo"), "exemplars": lat.get("exemplars"),
            "device_cost": device_cost, "trace_dir": args.trace_dir or None}


# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m kafkastreams_cep_tpu_torch.profile",
                                description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    default_device = "cpu" if os.environ.get("CEP_PLATFORM") == "cpu" else "cuda"

    def common(sp, k_default):
        sp.add_argument("--k", default=k_default, help="lane count (step: comma list)")
        sp.add_argument("--t", type=int, default=int(os.environ.get("PROF_T", "32")))
        sp.add_argument("--reps", type=int, default=2)
        sp.add_argument("--device", default=default_device,
                        help="cuda (the default) or cpu (the plain versions)")
        sp.add_argument("--seed", type=int, default=42)
        sp.add_argument("--wait-go", default=None, metavar="PREFIX",
                        help="set up, create PREFIX.ready, measure once PREFIX.go exists")

    common(sub.add_parser("step"), "512,4096,16384")
    common(sub.add_parser("phases"), "4096")
    sp = sub.add_parser("ablate")
    common(sp, "4096")
    sp.add_argument("--variant", choices=ABLATE_VARIANTS, default=None)
    sp = sub.add_parser("selectivity")
    common(sp, "256")
    sp.add_argument("--runs", type=int, default=16)
    sp.add_argument("--slab", type=int, default=32)
    sp = sub.add_parser("latency")
    common(sp, "64")
    sp.add_argument("--batches", type=int, default=4)
    sp.add_argument("--grace-ms", type=int, default=0,
                    help="reorder grace (0 = no ingest guard)")
    sp.add_argument("--drain-interval", type=int, default=1)
    sp.add_argument("--slo-ms", type=float, default=1000.0,
                    help="e2e SLO threshold for burn-rate tracking")
    sp.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler chrome trace into this directory")
    args = p.parse_args(argv)
    if args.cmd != "step":
        try:
            args.k = int(str(args.k).split(",")[0])
        except ValueError:
            p.error(f"--k must be an integer for {args.cmd}")
    if args.wait_go and not (args.cmd == "ablate" and not args.variant):
        _setup(_device(args.device))
        _wait_turn(args.wait_go)
    out = {"step": run_step, "phases": run_phases, "ablate": run_ablate,
           "selectivity": run_selectivity, "latency": run_latency}[args.cmd](args)
    print(json.dumps(out), flush=True)
    return 0
