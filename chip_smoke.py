"""Build the PyTorch port's CUDA kernels and drive its main paths on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. build    — compile every kernel of the main paths from the repo's sources
              with nvcc for sm_90a: the walk-pass kernel and one whole-scan
              library per pattern the script scans, all nvcc runs started
              together;
2. parity   — hold each kernel against its plain PyTorch version on the
              card, bit for bit, on random inputs made by numpy from a seed
              (K in {1, 37, 4096}, two slab configs, with and without puts);
              then every mode of the walk-pass kernel — two-tier (E_hot 8
              at E=16, 16 at E=48) x stage attribution x drain — on inputs
              whose hot tier is full, so that puts demote;
3. headline — ``BatchMatcher.scan`` at K=4096 lanes with the headline config
              (``bench.py``'s): the first 32 steps through the kernel and
              through the plain pass must agree bit for bit;
4. main path — each path with the launch counts set to 0 just before it and
              read just after: the stock demo through ``CEPProcessor`` on the
              card must print ``examples/stock_demo.py``'s four lines byte
              for byte with all counters 0; the K=4096 x T=256 headline scan
              is timed (CUDA events around a consumed reduction) after an
              untimed warm-up scan; the stock demo again with the two-tier
              slab and with stage attribution (each through its own kernel
              instance), and under lazy extraction (``drain_interval`` 1,
              and 3 plus ``flush``) through drain-mode launches, must print
              the same four lines;
5. lazy path — ``bench.py``'s lazy A/B configuration (the headline config at
              E=96, E_hot=16, handle ring 512) plus stage attribution, K=4096
              x T=256 in 64-step chunks with a drain after each: 32 steps
              and one drain through the kernel and through the plain pass
              agree bit for bit; the chunked run is timed; an eager run at
              the same E and E_hot is compared with it; every walk hop is
              attributed to one stage;
6. kernel timing — each mode of the walk-pass kernel and its plain version,
              timed on real mid-scan inputs, beside the kernel's bound;
7. whole scan — the whole-scan kernel (``CEP_SCAN_KERNEL=1``): (b) equal to
              its plain version, bit for bit, in seven cases at K 1/37/4096
              and T=32; (c) the K=4096 x T=256 headline scan equal to the
              per-step path of phase 4 and timed beside it; (d) the lazy
              path without the hot tier and attribution, in 64-step chunks
              with a drain after each, equal to the per-step path and timed
              beside it; (e) the stock demo through ``CEPProcessor``, eager
              and lazy, printing the same four lines through whole-scan
              launches; (f) a predicate that calls ``torch`` falls back to
              the per-step path; (g) each kernel instance timed beside its
              bound and its plain version.

The last two lines of standard output are the kernel report (one JSON
object) and the device line ``{"ok": true, "device": {...}}``; the card's
name and power limit (nvidia-smi) come on the line before the report.  The
script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor-core 32-bit rate (data sheet, fp32)

# The stock demo (examples/stock_demo.py), copied: this script imports
# nothing of the JAX package.
STOCK_EVENTS = [
    {"name": "e1", "price": 100, "volume": 1010},
    {"name": "e2", "price": 120, "volume": 990},
    {"name": "e3", "price": 120, "volume": 1005},
    {"name": "e4", "price": 121, "volume": 999},
    {"name": "e5", "price": 120, "volume": 999},
    {"name": "e6", "price": 125, "volume": 750},
    {"name": "e7", "price": 120, "volume": 950},
    {"name": "e8", "price": 120, "volume": 700},
]
EXPECTED = [
    '{"0":["e1"],"1":["e2","e3","e4","e5"],"2":["e6"]}',
    '{"0":["e3"],"1":["e4"],"2":["e6"]}',
    '{"0":["e1"],"1":["e2","e3","e4","e5","e6","e7"],"2":["e8"]}',
    '{"0":["e3"],"1":["e4","e6"],"2":["e8"]}',
]
HEADLINE = dict(max_runs=24, slab_entries=48, slab_preds=8, dewey_depth=12,
                max_walk=12)
DEMO = dict(max_runs=32, slab_entries=64, slab_preds=8, dewey_depth=16,
            max_walk=16)
# bench.py's lazy A/B block (bench.py:612-630): the headline config at twice
# its slab, a 16-row hot tier and a 512-handle ring, drained every 64 steps;
# plus stage attribution.
LAZY_PATH = dict(HEADLINE, slab_entries=96, slab_hot_entries=16,
                 lazy_extraction=True, handle_ring=512, stage_attribution=True)
LAZY_CHUNK = 64
LAZY_CMP_STEPS = 32
DEVICE = "cuda"
LANES = 4096  # K of the headline and lazy paths
STEPS = 256  # T
CMP_STEPS = 32  # headline steps held against the plain path
PARITY_LANES = (1, 37, 4096)
SOURCE = "kafkastreams_cep_tpu_torch/csrc/walk_pass.cu"
REPLACES = "kafkastreams_cep_tpu/ops/walk_kernel.py:734"
SCAN_SOURCE = "kafkastreams_cep_tpu_torch/csrc/scan_pass.cu"
SCAN_REPLACES = "kafkastreams_cep_tpu/ops/scan_kernel.py:88"
SCAN_STEPS = 32  # T of the whole-scan parity cases
PLAIN_SCAN_STEPS = 4  # depth at which the whole scan's plain version is timed
# The whole-scan cases' small config (tests/test_scan_kernel.py's).
SMALL = dict(max_runs=8, slab_entries=24, slab_preds=4, dewey_depth=8, max_walk=8)
# The lazy path without the hot tier and attribution: the whole-scan
# kernel's lazy instance is single tier.
LAZY_SINGLE = dict(HEADLINE, slab_entries=96, lazy_extraction=True, handle_ring=512)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def stock_pattern(Query):
    """The demo query (``CEPStockKStreamsDemo.java:37-53``)."""
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


# The queries of tests/test_scan_kernel.py, over {"x": int32} events.
def strict_pattern(Query):
    return (
        Query().select("a").where(lambda k, v, ts, st: v["x"] == 1)
        .then().select("b").where(lambda k, v, ts, st: v["x"] == 2)
        .then().select("c").where(lambda k, v, ts, st: v["x"] == 3)
        .build()
    )


def typed_float_pattern(Query):
    return (
        Query().select("a").where(lambda k, v, ts, st: v["x"] > 0)
        .fold("ema", lambda k, v, curr: 0.5 * curr + 0.25 * v["x"], init=0.0)
        .fold("n", lambda k, v, curr: curr + 1, init=0)
        .then().select("b").skip_till_next_match()
        .where(lambda k, v, ts, st: (st.get("ema") > 0.7) & (st.get("n") > 1))
        .build()
    )


def kleene_any_pattern(Query):
    return (
        Query().select("a").where(lambda k, v, ts, st: v["x"] == 0)
        .then().select("b").one_or_more().skip_till_any_match()
        .where(lambda k, v, ts, st: (0 < v["x"]) & (v["x"] < 8))
        .then().select("c").where(lambda k, v, ts, st: v["x"] >= 8)
        .build()
    )


def straddle_pattern(Query):
    return (
        Query().select("a").where(lambda k, v, ts, st: v["x"] == 0)
        .then().select("b").zero_or_more().skip_till_next_match()
        .where(lambda k, v, ts, st: (0 < v["x"]) & (v["x"] < 6))
        .then().select("c").skip_till_next_match()
        .where(lambda k, v, ts, st: v["x"] == 7)
        .build()
    )


def windowed_pattern(Query):
    return (
        Query().select("a").where(lambda k, v, ts, st: v["x"] == 1)
        .then().select("b").skip_till_next_match()
        .where(lambda k, v, ts, st: v["x"] == 2)
        .within(5, "ms")
        .build()
    )


def torch_call_pattern(Query):
    """A predicate the whole-scan code generator refuses (a torch call)."""
    import torch

    return (
        Query().select("a").where(lambda k, v, ts, st: torch.abs(v["x"] - 3) < 2)
        .then().select("b").skip_till_next_match()
        .where(lambda k, v, ts, st: v["x"] == 7)
        .build()
    )


def x_batch(torch, EventBatch, xs, device, ts_mult=1):
    """A ``[K, T]`` batch of ``{"x": xs}`` events: ts = t * ts_mult, off = t."""
    K, T = xs.shape
    i32 = torch.int32
    return EventBatch(
        key=torch.arange(K, dtype=i32, device=device)[:, None].expand(K, T),
        value={"x": torch.as_tensor(np.asarray(xs, np.int32), device=device)},
        ts=(torch.arange(T, dtype=i32, device=device) * ts_mult)[None, :].expand(K, T),
        off=torch.arange(T, dtype=i32, device=device)[None, :].expand(K, T),
        valid=torch.ones((K, T), dtype=torch.bool, device=device),
    )


def scan_cases(torch, EventBatch, Query, device):
    """The whole-scan parity cases (``tests/test_scan_kernel.py``'s, plus
    the stock query lazily): ``name -> (pattern, config, events(K), scans)``."""
    T = SCAN_STEPS

    def stock_holes(K):
        ev = make_batch(torch, EventBatch, K, T, 3, device)
        valid = torch.ones((K, T), dtype=torch.bool, device=device)
        valid[:, -2:] = False
        valid[::3, 5] = False  # per-lane padding holes
        return ev._replace(valid=valid)

    def xs(seed, choices=None, high=None):
        rng = np.random.default_rng(seed)
        return lambda K: (rng.choice(choices, size=(K, T)) if choices
                          else rng.integers(0, high, size=(K, T)))

    kleene = xs(7, choices=[0, 1, 2, 3, 9, 9])
    typed = xs(11, high=6)
    windows = xs(13, high=4)
    strict = xs(17, high=5)
    overflow = np.asarray(([0] + [6] * 10 + [1, 6, 7, 6, 6] + [6] * T)[:T])
    return {
        "stock (headline config, padding holes)": (
            stock_pattern(Query), HEADLINE, stock_holes, 1),
        "kleene skip-till-any (two scans)": (
            kleene_any_pattern(Query),
            dict(max_runs=16, slab_entries=32, slab_preds=6, dewey_depth=10, max_walk=12),
            lambda K: x_batch(torch, EventBatch, kleene(K), device), 2),
        "typed float folds": (
            typed_float_pattern(Query), SMALL,
            lambda K: x_batch(torch, EventBatch, typed(K), device), 1),
        "version overflow (renorm_versions=False)": (
            straddle_pattern(Query),
            dict(SMALL, dewey_depth=4, max_walk=12, renorm_versions=False),
            lambda K: x_batch(torch, EventBatch, np.tile(overflow, (K, 1)), device), 1),
        "enforce_windows": (
            windowed_pattern(Query), dict(SMALL, enforce_windows=True),
            lambda K: x_batch(torch, EventBatch, windows(K), device, ts_mult=3), 1),
        "strict contiguity": (
            strict_pattern(Query), SMALL,
            lambda K: x_batch(torch, EventBatch, strict(K), device), 1),
        "stock lazily (E=96, ring 512)": (
            stock_pattern(Query),
            dict(HEADLINE, slab_entries=96, lazy_extraction=True, handle_ring=512),
            lambda K: make_batch(torch, EventBatch, K, T, 5, device), 1),
    }


def advance(events):
    """The next batch of a stream: offsets and time move on."""
    T = events.ts.shape[1]
    return events._replace(off=events.off + T, ts=events.ts + 3 * T)


def format_match(seq, name_of) -> str:
    obj = {}
    for stage, events in reversed(list(seq.as_map().items())):
        obj[stage] = [name_of[e.offset] for e in reversed(events)]
    return json.dumps(obj, separators=(",", ":"))


def make_batch(torch, EventBatch, K: int, T: int, seed: int, device):
    """``bench.py: make_batch``'s trace: random stock prices and volumes."""
    rng = np.random.default_rng(seed)
    prices = rng.integers(90, 131, size=(K, T)).astype(np.int32)
    volumes = rng.integers(600, 1101, size=(K, T)).astype(np.int32)
    i32 = torch.int32
    return EventBatch(
        key=torch.arange(K, dtype=i32, device=device)[:, None].expand(K, T),
        value={
            "price": torch.as_tensor(prices, device=device),
            "volume": torch.as_tensor(volumes, device=device),
        },
        ts=(torch.arange(T, dtype=i32, device=device) * 2)[None, :].expand(K, T),
        off=torch.arange(T, dtype=i32, device=device)[None, :].expand(K, T),
        valid=torch.ones((K, T), dtype=torch.bool, device=device),
    )


def window(EventBatch, events, t0: int, t1: int):
    """Steps ``[t0, t1)`` of a ``[K, T]`` batch."""
    return EventBatch(
        events.key[:, t0:t1], {k: v[:, t0:t1] for k, v in events.value.items()},
        events.ts[:, t0:t1], events.off[:, t0:t1], events.valid[:, t0:t1],
    )


def max_abs_err(torch, got, want) -> int:
    """Max absolute difference over every tensor leaf of two nested tuples
    (0 = bit-identical; a shape or dtype mismatch is an error)."""
    if isinstance(got, tuple):
        return max((max_abs_err(torch, a, b) for a, b in zip(got, want)), default=0)
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"shape/dtype mismatch {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
    if not got.numel():
        return 0
    return int((got.long() - want.long()).abs().max())


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(xs) -> int:
    """Bytes of the tensors as the engine hands them over."""
    return sum(x.numel() * x.element_size() for x in xs)


def bound(slab_in, slab_out, leaves, other_in, other_out, E, MP, D):
    """``(bound_ms, bound_by, MB moved, hops)`` of one kernel call: the slab
    ``leaves`` it reads and writes and its other tensors, each crossing
    device memory once, over the memory rate, against its hops' compares
    over the 32-bit rate."""
    moved = (nbytes(getattr(slab_in, f) for f in leaves)
             + nbytes(getattr(slab_out, f) for f in leaves)
             + nbytes(other_in) + nbytes(other_out))
    hops = int(sum((getattr(slab_out, c) - getattr(slab_in, c)).sum()
                   for c in ("walk_hops", "extract_hops", "drain_hops")))
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = hops * (2 * E + MP * 3 * D) / INT_OPS_PER_S * 1e3  # compares + compat
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
            moved / 1e6, hops)


def mode_parity(torch, kern, walk_kernel, walk_inputs, dev, max_err):
    """Every mode of the walk-pass kernel against its plain version."""
    demoted = 0
    for name, (E, MP, D, W, R, H, EH) in {
        "test_walk_kernel": (16, 4, 6, 8, 4, 2, 8),
        "headline": (48, 8, 12, 12, 24, 3, 16),
    }.items():
        for hot in (0, EH):
            for S in (0, walk_inputs.NUM_STAGES):
                for drain in (False, True):
                    if not (hot or S or drain):
                        continue  # the default mode: phase 2's first cases
                    mode = walk_kernel.mode_name(hot, S, drain)
                    for K in PARITY_LANES:
                        arrs = walk_inputs.random_inputs(K, K, E, MP, D, R, H,
                                                         hot_entries=hot)
                        slab, wk, puts, ev_off = walk_inputs.as_tensors(
                            arrs, dev, stage_hops=S)
                        PW = wk[0].shape[1]
                        kw = dict(put_ops=puts, ev_off=ev_off, hot_entries=hot,
                                  drain=drain)
                        rows = (PW - R, R)
                        if drain:  # the handle ring: no puts, all rows emit
                            ones = torch.ones_like(wk[0])
                            wk = (*wk[:5], ones, ones)
                            kw.update(put_ops=None, ev_off=None)
                            rows = (0, PW)
                        got = kern(slab, *wk, W, *rows, **kw)
                        want = walk_kernel.walk_pass_plain(slab, *wk, W, *rows, **kw)
                        torch.cuda.synchronize()
                        err = max_abs_err(torch, got, want)
                        dem = int((got[0].demotions - slab.demotions).sum())
                        demoted += dem
                        max_err[mode] = max(max_err.get(mode, 0), err)
                        log(f"parity: {name} {mode} K={K}: max_abs_err {err}"
                            + (f", demotions {dem}" if hot else ""))
                        if err:
                            fail(f"walk_pass kernel != plain ({name}, {mode}, K={K})")
    if not demoted:
        fail("no two-tier parity case demoted an entry")
    log(f"parity: every mode bit for bit; two-tier cases demoted {demoted} entries")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    from kafkastreams_cep_tpu_torch import BatchMatcher, CEPProcessor, EngineConfig, Query, Record
    from kafkastreams_cep_tpu_torch.engine.matcher import (
        EventBatch, build_drain, make_step, step_events,
    )
    from kafkastreams_cep_tpu_torch.compiler.tables import lower
    from kafkastreams_cep_tpu_torch.parallel import batch as batch_mod
    from kafkastreams_cep_tpu_torch.ops import (
        scan_codegen, scan_kernel, walk_inputs, walk_kernel,
    )

    dev = torch.device(DEVICE)
    kern = walk_kernel.walk_pass_kernel
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    # 1. build: the walk-pass kernel and one whole-scan library per pattern,
    # every nvcc started together ---------------------------------------------
    skern = scan_kernel.scan_pass_kernel
    cases = scan_cases(torch, EventBatch, Query, dev)
    sources = {name: scan_codegen.generate(lower(pat), make_ev(1).value)
               for name, (pat, _, make_ev, _) in cases.items()}
    t0 = time.perf_counter()
    walk_errors = []

    def build_walk():
        try:
            kern.build()
        except Exception as e:  # reported below, after the scan builds
            walk_errors.append(e)

    walk_thread = threading.Thread(target=build_walk)
    walk_thread.start()
    scan_paths = skern.build(*sources.values())
    walk_thread.join()
    if walk_errors:
        fail(f"walk_pass build failed: {walk_errors[0]}")
    log(f"build: walk_pass -> {kern.build()} and {len(set(scan_paths))} whole-scan "
        f"libraries in {time.perf_counter() - t0:.2f} s (all nvcc runs together)")
    for line in kern.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"build: walk_pass ptxas {line.strip()}")
    for name, src in sources.items():
        lib = skern.library(src).name
        secs = skern.build_seconds.get(lib)
        log(f"build: scan_pass for {name!r} -> {lib}"
            + (f" in {secs:.2f} s" if secs is not None else " (shared)"))
        for line in skern.build_logs.get(lib, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: scan_pass ptxas {line.strip()}")

    # 2. parity on random inputs --------------------------------------------
    max_err = {"default": 0}
    for name, (E, MP, D, W, R, H) in {
        "test_walk_kernel": (16, 4, 6, 8, 4, 2),
        "headline": (48, 8, 12, 12, 24, 3),
    }.items():
        for K in PARITY_LANES:
            arrs = walk_inputs.random_inputs(K, K, E, MP, D, R, H)
            slab, wk, puts, ev_off = walk_inputs.as_tensors(arrs, dev)
            PW = wk[0].shape[1]
            for with_puts in (False, True):
                kw = dict(put_ops=puts, ev_off=ev_off) if with_puts else {}
                got = kern(slab, *wk, W, PW - R, R, **kw)
                want = walk_kernel.walk_pass_plain(slab, *wk, W, PW - R, R, **kw)
                torch.cuda.synchronize()
                err = max_abs_err(torch, got, want)
                max_err["default"] = max(max_err["default"], err)
                log(f"parity: {name} K={K} puts={with_puts}: max_abs_err {err}")
                if err:
                    fail(f"walk_pass kernel != plain ({name}, K={K}, puts={with_puts})")
    t0 = time.perf_counter()
    mode_parity(torch, kern, walk_kernel, walk_inputs, dev, max_err)
    log(f"parity: mode cases took {time.perf_counter() - t0:.1f} s")

    # 3. headline: kernel vs plain path, step by step -----------------------
    K, T, T_CMP = LANES, STEPS, CMP_STEPS
    cfg = EngineConfig(**HEADLINE)
    bm = BatchMatcher(stock_pattern(Query), K, cfg, device=dev)
    events = make_batch(torch, EventBatch, K, T, 42, dev)
    plain_step = make_step(bm.phases, walk_kernel.walk_pass_plain)
    s_k = s_p = bm.init_state()
    t0 = time.perf_counter()
    for t in range(T_CMP):
        ev = step_events(events, t)
        s_k, o_k = bm.step(s_k, ev)
        s_p, o_p = plain_step(s_p, ev)
        err = max(max_abs_err(torch, s_k, s_p), max_abs_err(torch, o_k, o_p))
        max_err["default"] = max(max_err["default"], err)
        if err:
            fail(f"headline step {t}: kernel path != plain path (max_abs_err {err})")
    torch.cuda.synchronize()
    log(f"headline: {T_CMP} steps kernel path == plain path, bit for bit "
        f"({time.perf_counter() - t0:.1f} s); counters {bm.counters(s_k)}")

    # 4. the main paths, with launch counts from 0 ---------------------------
    name_of = {i: ev["name"] for i, ev in enumerate(STOCK_EVENTS)}
    records = [
        Record("stocks", {"price": ev["price"], "volume": ev["volume"]}, 1000 + i)
        for i, ev in enumerate(STOCK_EVENTS)
    ]
    kern.reset_counts()
    proc = CEPProcessor(stock_pattern(Query), num_lanes=1,
                        config=EngineConfig(**DEMO), topic="StockEvents", device=dev)
    lines = [format_match(seq, name_of) for _, seq in proc.process(records)]
    for line in lines:
        log(f"demo: {line}")
    counters = proc.counters()
    if lines != EXPECTED:
        fail(f"demo output differs from examples/stock_demo.py EXPECTED: {lines}")
    if any(counters.values()):
        fail(f"demo counters not all zero: {counters}")
    demo_launches = kern.launches_by_mode.get("default", 0)
    if not demo_launches:
        fail("demo ran without launching the walk-pass kernel")
    log(f"demo: README parity OK, counters all 0, walk_pass launches {demo_launches}")

    state0 = bm.init_state()
    t0 = time.perf_counter()
    state, out = bm.scan(state0, events)
    total = int(out.count.sum())
    warm_s = time.perf_counter() - t0
    del state, out
    kern.reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    step_state, step_out = bm.scan(state0, events)  # kept for phase 7 (c)
    hits = (step_out.count > 0).sum()  # a reduction of the outputs, consumed below
    end.record()
    torch.cuda.synchronize()
    scan_ms = start.elapsed_time(end)
    n_hits = int(hits)
    headline_launches = kern.launches_by_mode.get("default", 0)
    if headline_launches != T or kern.launches != T:
        fail(f"walk_pass launches {kern.launches_by_mode} in the timed scan, want {T}")
    if int(step_out.count.sum()) != total or not n_hits:
        fail("timed headline scan disagrees with the warm-up scan or found no match")
    if int(step_out.count.min()) < 0 or int(step_out.count.max()) > cfg.max_walk:
        fail("headline match counts out of range")
    log(f"headline: K={K} T={T}: warm-up scan {warm_s:.2f} s; timed scan "
        f"{scan_ms:.1f} ms = {scan_ms / T:.3f} ms/step, "
        f"{K * T / (scan_ms / 1e3):.0f} events/s, {n_hits} run-slot matches, "
        f"counters {bm.counters(step_state)} [{smi}]")

    mode_demo = {}
    for mode, extra in (("two_tier", dict(slab_hot_entries=16)),
                        ("attribution", dict(stage_attribution=True))):
        kern.reset_counts()
        proc = CEPProcessor(stock_pattern(Query), num_lanes=1,
                            config=EngineConfig(**DEMO, **extra),
                            topic="StockEvents", device=dev)
        lines = [format_match(seq, name_of) for _, seq in proc.process(records)]
        counters = proc.counters()
        mode_demo[mode] = kern.launches_by_mode.get(mode, 0)
        log(f"demo ({mode}): {lines == EXPECTED and 'EXPECTED byte for byte' or lines}; "
            f"counters {counters}; launches {kern.launches_by_mode}")
        if lines != EXPECTED or any(counters.values()):
            fail(f"demo ({mode}) differs from EXPECTED or lost work: {lines} {counters}")
        if not mode_demo[mode]:
            fail(f"demo ({mode}) ran without {mode} launches")

    lazy_demo = {"default": 0, "drain": 0}
    for interval, chunks in ((1, [records]), (3, [records[i:i + 2] for i in range(0, 8, 2)])):
        kern.reset_counts()
        proc = CEPProcessor(
            stock_pattern(Query), num_lanes=1,
            config=EngineConfig(**DEMO, lazy_extraction=True), topic="StockEvents",
            drain_interval=interval, device=dev,
        )
        got = []
        for chunk in chunks:
            got += proc.process(chunk)
        got += proc.flush()
        lines = [format_match(seq, name_of) for _, seq in got]
        counters = proc.counters()
        runs = dict(kern.launches_by_mode)
        log(f"lazy demo (drain_interval={interval}, {len(chunks)} batches + flush): "
            f"{lines == EXPECTED and 'EXPECTED byte for byte' or lines}; "
            f"counters {counters}; launches {runs}")
        if lines != EXPECTED:
            fail(f"lazy demo (drain_interval={interval}) differs from EXPECTED: {lines}")
        if any(counters.values()):
            fail(f"lazy demo counters not all zero: {counters}")
        if not runs.get("drain") or not runs.get("default"):
            fail(f"lazy demo ran without step and drain-mode launches: {runs}")
        for m in lazy_demo:
            lazy_demo[m] += runs.get(m, 0)

    # 5. the full-width lazy path --------------------------------------------
    lcfg = EngineConfig(**LAZY_PATH)
    lbm = BatchMatcher(stock_pattern(Query), K, lcfg, device=dev)
    step_mode = walk_kernel.mode_name(lcfg.slab_hot_entries, 1, False)
    drain_mode = walk_kernel.mode_name(lcfg.slab_hot_entries, 1, True)
    for m in (step_mode, drain_mode):
        max_err.setdefault(m, 0)
    plain_lstep = make_step(lbm.phases, walk_kernel.walk_pass_plain)
    plain_drain = build_drain(lcfg, walk_kernel.walk_pass_plain)
    s_k = s_p = lbm.init_state()
    t0 = time.perf_counter()
    for t in range(LAZY_CMP_STEPS):
        ev = step_events(events, t)
        s_k, o_k = lbm.step(s_k, ev)
        s_p, o_p = plain_lstep(s_p, ev)
        err = max(max_abs_err(torch, s_k, s_p), max_abs_err(torch, o_k, o_p))
        max_err[step_mode] = max(max_err[step_mode], err)
        if err:
            fail(f"lazy path step {t}: kernel path != plain path (max_abs_err {err})")
    pending = int(s_k.hr_count.sum())
    s_k, d_k = lbm.drain(s_k)
    s_p, d_p = plain_drain(s_p)
    err = max(max_abs_err(torch, s_k, s_p), max_abs_err(torch, d_k, d_p))
    max_err[drain_mode] = max(max_err[drain_mode], err)
    if err:
        fail(f"lazy path drain: kernel != plain (max_abs_err {err})")
    log(f"lazy path: {LAZY_CMP_STEPS} steps and one drain ({pending} handles) kernel "
        f"path == plain path, bit for bit ({time.perf_counter() - t0:.1f} s)")

    def chunked(batch, lazy: bool):
        """``bench.py: _chunked_scan``'s cadence: a drain after each chunk
        when lazy; the match-slot count stays on the device."""
        state = batch.init_state()
        n = torch.zeros((), dtype=torch.int64, device=dev)
        drains = []
        for c0 in range(0, T, LAZY_CHUNK):
            state, out = batch.scan(state, window(EventBatch, events, c0, c0 + LAZY_CHUNK))
            if lazy:
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                state, dout = batch.drain(state)
                b.record()
                drains.append((a, b))
                n += (dout.count > 0).sum()
            else:
                n += (out.count > 0).sum()
        return state, n, drains

    t0 = time.perf_counter()
    chunked(lbm, True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    kern.reset_counts()
    start.record()
    l_state, l_slots, drains = chunked(lbm, True)  # l_slots: the reduction
    end.record()
    torch.cuda.synchronize()
    lazy_ms = start.elapsed_time(end)
    lazy_runs = dict(kern.launches_by_mode)
    l_slots = int(l_slots)
    drain_ms = sum(a.elapsed_time(b) for a, b in drains) / len(drains)
    if lazy_runs.get(step_mode) != T or lazy_runs.get(drain_mode) != T // LAZY_CHUNK:
        fail(f"lazy path launches {lazy_runs}, want {T} {step_mode} and "
             f"{T // LAZY_CHUNK} {drain_mode}")
    log(f"lazy path: K={K} T={T} (E=96, E_hot=16, ring 512, attribution, drain "
        f"every {LAZY_CHUNK}): warm-up {warm_s:.2f} s; timed run {lazy_ms:.1f} ms = "
        f"{lazy_ms / T:.3f} ms/step, {K * T / (lazy_ms / 1e3):.0f} events/s; drain "
        f"{drain_ms:.3f} ms per pass ({len(drains)} passes); launches {lazy_runs} [{smi}]")

    ecfg = EngineConfig(**dict(LAZY_PATH, lazy_extraction=False))
    ebm = BatchMatcher(stock_pattern(Query), K, ecfg, device=dev)
    e_state, e_slots, _ = chunked(ebm, False)
    e_slots = int(e_slots)
    cap = {}
    for label, b, s in (("eager", ebm, e_state), ("lazy", lbm, l_state)):
        c = b.counters(s)
        c.pop("slab_missing")
        cap[label] = c
        log(f"lazy path vs eager: {label}: match slots "
            f"{l_slots if label == 'lazy' else e_slots}; walk {b.walk_counters(s)}; "
            f"hot {b.hot_counters(s)}; capacity {c}")
    we, wl = ebm.walk_counters(e_state), lbm.walk_counters(l_state)
    if not any(cap["eager"].values()) and not any(cap["lazy"].values()):
        if e_slots != l_slots or wl["drain_hops"] != we["extract_hops"]:
            fail("loss-free lazy and eager runs disagree on match slots or hops")
        log("lazy path vs eager: loss-free; equal match slots, drain_hops == extract_hops")
    else:
        log(f"lazy path vs eager: capacity counters are not zero, so the two runs "
            f"shed different work (match slots {l_slots} lazy, {e_slots} eager; "
            f"drain_hops {wl['drain_hops']}, eager extract_hops {we['extract_hops']})")
    for label, b, s in (("eager", ebm, e_state), ("lazy", lbm, l_state)):
        if int(s.slab.stage_hops.sum()) != sum(b.walk_counters(s).values()):
            fail(f"{label}: sum(stage_hops) != walk + extract + drain hops")
    log("lazy path: sum(stage_hops) == walk_hops + extract_hops + drain_hops "
        "in both runs")
    del e_state, ebm

    # 6. kernel timing on real mid-scan inputs -------------------------------
    report = []

    def entry(mode, launches, ms, plain_ms, bnd, by_path, timed_on):
        bound_ms, bound_by, mb, hops = bnd
        log(f"walk_pass[{mode}]: {ms:.3f} ms/launch (plain {plain_ms:.1f} ms) on "
            f"{timed_on}: {mb:.1f} MB moved, {hops} hops -> bound {bound_ms:.4f} ms "
            f"({bound_by}); launches {by_path} [{smi}]")
        report.append({
            "name": "walk_pass" if mode == "default" else f"walk_pass[{mode}]",
            "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": max_err.get(mode, 0), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "timed_on": timed_on,
        })

    def timed(args, kw, mode, plain_reps=2):
        got = kern(*args, **kw)
        want = walk_kernel.walk_pass_plain(*args, **kw)
        err = max_abs_err(torch, got, want)
        max_err[mode] = max(max_err.get(mode, 0), err)
        if err:
            fail(f"{mode} on mid-scan inputs: kernel != plain (max_abs_err {err})")
        ms = cuda_ms(torch, lambda: kern(*args, **kw), 20)
        plain_ms = cuda_ms(torch, lambda: walk_kernel.walk_pass_plain(*args, **kw),
                           plain_reps)
        return got, ms, plain_ms

    # The default mode on the headline step.
    ph = bm.phases
    s_mid, _ = bm.scan(state0, window(EventBatch, events, 0, T // 2))
    ev = step_events(events, T // 2)
    rec = ph.eval_chain(s_mid, ev)
    ops = ph.build_puts(s_mid, rec)
    wk = ph.build_walkers(s_mid, rec, ev)
    args = (s_mid.slab, *wk, ph.max_walk, ph.out_base, ph.out_rows)
    got, ms, plain_ms = timed(args, dict(put_ops=ops, ev_off=ev.off), "default")
    E, MP, D = cfg.slab_entries, cfg.slab_preds, cfg.dewey_depth
    bnd = bound(s_mid.slab, got[0], walk_kernel.mode_fields(0, 0, False),
                list(wk) + list(ops) + [ev.off], got[1:], E, MP, D)
    entry("default", demo_launches + headline_launches + lazy_demo["default"], ms,
          plain_ms, bnd, {"demo": demo_launches, "headline": headline_launches,
                          "lazy_demo": lazy_demo["default"]},
          f"headline step {T // 2}, K={K}")
    # Where a headline step's time goes (CUDA events around each phase).
    parts = {"chain+puts+walkers": 0.0, "walk_pass kernel": 0.0, "finish": 0.0}
    s = s_mid
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for t in range(T // 2, T // 2 + 8):
        e = step_events(events, t)
        marks[0].record()
        r = ph.eval_chain(s, e)
        o = ph.build_puts(s, r)
        w = ph.build_walkers(s, r, e)
        marks[1].record()
        res = kern(s.slab, *w, ph.max_walk, ph.out_base, ph.out_rows,
                   put_ops=o, ev_off=e.off)
        marks[2].record()
        s, _ = ph.finish(s, e, r, *res)
        marks[3].record()
        torch.cuda.synchronize()
        for name, a, b in zip(parts, marks, marks[1:]):
            parts[name] += a.elapsed_time(b) / 8
    log("step breakdown (ms, mean of 8 headline steps): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))
    del s_mid, s

    # The lazy path's step and drain, mid-chunk: half way into the third
    # chunk, so the ring holds half a chunk of pending handles.
    lph = lbm.phases
    mid = 2 * LAZY_CHUNK + LAZY_CHUNK // 2
    s_mid, _ = lbm.scan(lbm.init_state(), window(EventBatch, events, 0, 2 * LAZY_CHUNK))
    s_mid, _ = lbm.drain(s_mid)
    s_mid, _ = lbm.scan(s_mid, window(EventBatch, events, 2 * LAZY_CHUNK, mid))
    ev = step_events(events, mid)
    rec = lph.eval_chain(s_mid, ev)
    ops = lph.build_puts(s_mid, rec)
    wk = lph.build_walkers(s_mid, rec, ev)
    EL, EH = lcfg.slab_entries, lcfg.slab_hot_entries
    no_sa = s_mid.slab._replace(stage_hops=s_mid.slab.stage_hops[:, :0])
    for mode, slab_s, hot in ((step_mode, s_mid.slab, EH), ("two_tier", no_sa, EH),
                              ("attribution", s_mid.slab, 0)):
        args = (slab_s, *wk, lph.max_walk, lph.out_base, lph.out_rows)
        kw = dict(put_ops=ops, ev_off=ev.off, hot_entries=hot)
        got, ms, plain_ms = timed(args, kw, mode)
        leaves = walk_kernel.mode_fields(hot, slab_s.stage_hops.shape[1], False)
        bnd = bound(slab_s, got[0], leaves, list(wk) + list(ops) + [ev.off],
                    got[1:], EL, MP, D)
        if mode == step_mode:
            launches, by_path = lazy_runs[mode], {"lazy_path": lazy_runs[mode]}
            on = f"lazy-path step {mid}, K={K}"
        else:
            launches, by_path = mode_demo[mode], {"demo": mode_demo[mode]}
            on = (f"lazy-path step {mid}, K={K}, "
                  + ("without attribution" if hot else "single tier"))
        entry(mode, launches, ms, plain_ms, bnd, by_path, on)

    HB = lcfg.handle_ring
    pend = torch.arange(HB, device=dev)[None, :] < s_mid.hr_count[:, None]
    unpin = ((s_mid.slab.stage[:, None, :] == s_mid.hr_stage[:, :, None])
             & (s_mid.slab.off[:, None, :] == s_mid.hr_off[:, :, None])
             & pend[:, :, None]).sum(dim=1, dtype=torch.int32)
    dslab = s_mid.slab._replace(refs=torch.clamp(s_mid.slab.refs - unpin, min=0))
    ones = torch.ones_like(pend)
    ring = (pend, s_mid.hr_stage, s_mid.hr_off, s_mid.hr_ver, s_mid.hr_vlen, ones, ones)
    log(f"drain inputs: {int(s_mid.hr_count.sum())} pending handles over {K} lanes "
        f"(at most {int(s_mid.hr_count.max())} in a lane)")
    for mode, slab_d, hot in (
        (drain_mode, dslab, lcfg.slab_hot_entries),
        ("drain", dslab._replace(stage_hops=dslab.stage_hops[:, :0]), 0),
    ):
        got, ms, plain_ms = timed((slab_d, *ring, lph.max_walk, 0, HB),
                                  dict(hot_entries=hot, drain=True), mode,
                                  plain_reps=1)
        leaves = walk_kernel.mode_fields(hot, slab_d.stage_hops.shape[1], True)
        bnd = bound(slab_d, got[0], leaves, ring, got[1:], EL, MP, D)
        if mode == "drain":
            launches, by_path = lazy_demo["drain"], {"lazy_demo": lazy_demo["drain"]}
            on = f"the lazy path's mid-chunk ring, single tier, K={K}"
        else:
            launches, by_path = lazy_runs[drain_mode], {"lazy_path": lazy_runs[drain_mode]}
            on = f"the lazy path's mid-chunk ring, K={K}"
        entry(mode, launches, ms, plain_ms, bnd, by_path, on)

    # 7. the whole-scan kernel ---------------------------------------------------
    t7 = time.perf_counter()

    def scan_matcher(pattern, lanes, conf):
        """A ``BatchMatcher`` with ``CEP_SCAN_KERNEL=1``, as a user turns it on."""
        os.environ["CEP_SCAN_KERNEL"] = "1"
        try:
            m = BatchMatcher(pattern, lanes, EngineConfig(**conf), device=dev)
        finally:
            del os.environ["CEP_SCAN_KERNEL"]
        if not m.uses_scan_kernel:
            fail("CEP_SCAN_KERNEL=1 but the matcher does not use the whole-scan kernel")
        return m

    def scan_bound(state_in, state_out, events_in, out, conf):
        """``(bound_ms, bound_by, MB moved, hops)`` of one whole scan: each
        state leaf the kernel instance writes once in and once out, the
        events once in, the output frames once out; the hops' compares
        against the 32-bit rate."""
        written = scan_kernel.mode_fields(EngineConfig(**conf))

        def leaf(st, f):
            return getattr(st.slab, f) if f in st.slab._fields else getattr(st, f)

        ev = [events_in.key, events_in.ts, events_in.off, events_in.valid,
              *scan_codegen.value_leaves(events_in.value)]
        moved = (nbytes(leaf(state_in, f) for f in written)
                 + nbytes(leaf(state_out, f) for f in written) + nbytes(ev) + nbytes(out))
        hops = int(sum((getattr(state_out.slab, c) - getattr(state_in.slab, c)).sum()
                       for c in ("walk_hops", "extract_hops")))
        E_, MP_, D_ = state_in.slab.pstage.shape[1], state_in.slab.pstage.shape[2], \
            state_in.ver.shape[2]
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = hops * (2 * E_ + MP_ * 3 * D_) / INT_OPS_PER_S * 1e3
        return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
                moved / 1e6, hops)

    # (b) parity: kernel == plain version, bit for bit.
    scan_err = {"default": 0, "lazy": 0}
    t0 = time.perf_counter()
    for name, (pat, conf, make_ev, scans) in cases.items():
        ccfg = EngineConfig(**conf)
        mode = scan_kernel.mode_name(ccfg)
        for Kc in PARITY_LANES:
            cbm = BatchMatcher(pat, Kc, ccfg, device=dev)
            ev = make_ev(Kc)
            s_k = s_p = cbm.init_state()
            for i in range(scans):
                s_k, o_k = scan_kernel.scan_pass(sources[name], ccfg, cbm.phases, s_k, ev)
                s_p, o_p = scan_kernel.scan_pass_plain(cbm.phases, s_p, ev)
                torch.cuda.synchronize()
                err = max(max_abs_err(torch, s_k, s_p), max_abs_err(torch, o_k, o_p))
                scan_err[mode] = max(scan_err[mode], err)
                log(f"scan parity: {name} K={Kc} scan {i + 1}/{scans}: max_abs_err {err}; "
                    f"match slots {int((o_k.count > 0).sum())}, handles "
                    f"{int(s_k.hr_count.sum())}, counters {cbm.counters(s_k)}")
                if err:
                    fail(f"scan_pass kernel != plain ({name}, K={Kc}, scan {i + 1})")
                ev = advance(ev)
    log(f"scan parity: seven cases x K {PARITY_LANES} bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")

    # (c) the headline scan: one whole-scan launch against phase 4's per-step path.
    sbm = scan_matcher(stock_pattern(Query), K, HEADLINE)
    t0 = time.perf_counter()
    _, warm_out = sbm.scan(state0, events)
    int(warm_out.count.sum())
    warm_s = time.perf_counter() - t0
    del warm_out
    skern.reset_counts()
    kern.reset_counts()
    start.record()
    s_state, s_out = sbm.scan(state0, events)
    s_hits = (s_out.count > 0).sum()  # a reduction of the outputs, consumed below
    end.record()
    torch.cuda.synchronize()
    scan_k_ms = start.elapsed_time(end)
    head_scan_launches = skern.launches_by_mode.get("default", 0)
    if skern.launches != 1 or head_scan_launches != 1 or kern.launches:
        fail(f"headline whole scan launched scan_pass {skern.launches_by_mode} and "
             f"walk_pass {kern.launches_by_mode}, want one default scan_pass launch")
    err = max(max_abs_err(torch, s_state, step_state), max_abs_err(torch, s_out, step_out))
    scan_err["default"] = max(scan_err["default"], err)
    if err or int(s_hits) != n_hits:
        fail(f"headline whole scan != per-step path (max_abs_err {err})")
    log(f"scan headline: K={K} T={T}: warm-up {warm_s:.2f} s; whole scan {scan_k_ms:.3f} ms "
        f"= {K * T / (scan_k_ms / 1e3):.0f} events/s, per-step path {scan_ms:.1f} ms: "
        f"{scan_ms / scan_k_ms:.1f}x; equal to the per-step path bit for bit "
        f"({int(s_hits)} run-slot matches) [{smi}]")
    head_bound = scan_bound(state0, s_state, events, s_out, HEADLINE)
    plain_head_ms = cuda_ms(torch, lambda: scan_kernel.scan_pass_plain(
        bm.phases, state0, window(EventBatch, events, 0, PLAIN_SCAN_STEPS)), 1)
    del s_state, s_out, step_state, step_out

    # (d) the lazy path, single tier: chunks and drains against the per-step path.
    pbm = BatchMatcher(stock_pattern(Query), K, EngineConfig(**LAZY_SINGLE), device=dev)
    lsbm = scan_matcher(stock_pattern(Query), K, LAZY_SINGLE)

    def drained(batch):
        """Every chunk's drain output and the final state (untimed)."""
        st, outs = batch.init_state(), []
        for c0 in range(0, T, LAZY_CHUNK):
            st, _ = batch.scan(st, window(EventBatch, events, c0, c0 + LAZY_CHUNK))
            st, dout = batch.drain(st)
            outs.append(dout)
        return st, tuple(outs)

    t0 = time.perf_counter()
    p_st, p_dr = drained(pbm)
    k_st, k_dr = drained(lsbm)
    torch.cuda.synchronize()
    err = max(max_abs_err(torch, k_st, p_st), max_abs_err(torch, k_dr, p_dr))
    scan_err["lazy"] = max(scan_err["lazy"], err)
    if err:
        fail(f"lazy single-tier path: whole scan != per-step path (max_abs_err {err})")
    lazy_slots = sum(int((d.count > 0).sum()) for d in k_dr)
    log(f"scan lazy path: K={K} T={T} (E=96, ring 512, drain every {LAZY_CHUNK}): whole "
        f"scans == per-step path, bit for bit, in every drain and the final state "
        f"({lazy_slots} drained matches, counters {lsbm.counters(k_st)}; "
        f"{time.perf_counter() - t0:.1f} s)")
    del p_st, p_dr, k_st, k_dr
    kern.reset_counts()
    start.record()
    _, p_n, _ = chunked(pbm, True)
    end.record()
    torch.cuda.synchronize()
    lazy_step_ms = start.elapsed_time(end)
    skern.reset_counts()
    kern.reset_counts()
    start.record()
    _, k_n, k_drains = chunked(lsbm, True)
    end.record()
    torch.cuda.synchronize()
    lazy_scan_ms = start.elapsed_time(end)
    lazy_scan_launches = skern.launches_by_mode.get("lazy", 0)
    n_chunks = T // LAZY_CHUNK
    if (skern.launches != n_chunks or lazy_scan_launches != n_chunks
            or kern.launches_by_mode.get("drain", 0) != n_chunks
            or kern.launches != n_chunks):
        fail(f"lazy whole-scan path launched scan_pass {skern.launches_by_mode} and "
             f"walk_pass {kern.launches_by_mode}, want {n_chunks} of each (lazy, drain)")
    if int(k_n) != int(p_n):
        fail("timed lazy runs disagree on match slots")
    k_drain_ms = sum(a.elapsed_time(b) for a, b in k_drains) / len(k_drains)
    log(f"scan lazy path: whole scans + drains {lazy_scan_ms:.3f} ms = "
        f"{K * T / (lazy_scan_ms / 1e3):.0f} events/s (drain {k_drain_ms:.3f} ms per pass), "
        f"per-step path {lazy_step_ms:.1f} ms: {lazy_step_ms / lazy_scan_ms:.1f}x [{smi}]")
    # One chunk's whole scan, timed alone, for the kernel report.
    l_mid, _ = lsbm.scan(lsbm.init_state(), window(EventBatch, events, 0, LAZY_CHUNK))
    l_mid, _ = lsbm.drain(l_mid)
    chunk2 = window(EventBatch, events, LAZY_CHUNK, 2 * LAZY_CHUNK)
    l_out_state, l_out = lsbm.scan(l_mid, chunk2)
    lazy_chunk_ms = cuda_ms(torch, lambda: lsbm.scan(l_mid, chunk2), 5)
    lazy_bound = scan_bound(l_mid, l_out_state, chunk2, l_out, LAZY_SINGLE)
    plain_lazy_ms = cuda_ms(torch, lambda: scan_kernel.scan_pass_plain(
        lsbm.phases, l_mid, window(EventBatch, chunk2, 0, PLAIN_SCAN_STEPS)), 1)
    del l_mid, l_out_state, l_out

    # (e) the stock demo through CEPProcessor with the switch on.
    scan_demo = {"default": 0, "lazy": 0}
    os.environ["CEP_SCAN_KERNEL"] = "1"
    try:
        skern.reset_counts()
        kern.reset_counts()
        proc = CEPProcessor(stock_pattern(Query), num_lanes=1, config=EngineConfig(**DEMO),
                            topic="StockEvents", device=dev)
        lines = [format_match(seq, name_of) for _, seq in proc.process(records)]
        counters = proc.counters()
        scan_demo["default"] = skern.launches_by_mode.get("default", 0)
        log(f"scan demo: {lines == EXPECTED and 'EXPECTED byte for byte' or lines}; "
            f"counters {counters}; scan_pass launches {skern.launches_by_mode}, "
            f"walk_pass launches {kern.launches_by_mode}")
        if lines != EXPECTED or any(counters.values()):
            fail(f"scan demo differs from EXPECTED or lost work: {lines} {counters}")
        if not proc.uses_scan_kernel or not scan_demo["default"] or kern.launches:
            fail("scan demo did not run through scan_pass alone")
        for interval, chunks in ((1, [records]),
                                 (3, [records[i:i + 2] for i in range(0, 8, 2)])):
            skern.reset_counts()
            kern.reset_counts()
            proc = CEPProcessor(
                stock_pattern(Query), num_lanes=1,
                config=EngineConfig(**DEMO, lazy_extraction=True), topic="StockEvents",
                drain_interval=interval, device=dev,
            )
            got = []
            for chunk in chunks:
                got += proc.process(chunk)
            got += proc.flush()
            lines = [format_match(seq, name_of) for _, seq in got]
            counters = proc.counters()
            log(f"scan lazy demo (drain_interval={interval}, {len(chunks)} batches + "
                f"flush): {lines == EXPECTED and 'EXPECTED byte for byte' or lines}; "
                f"counters {counters}; scan_pass launches {skern.launches_by_mode}, "
                f"walk_pass launches {kern.launches_by_mode}")
            if lines != EXPECTED or any(counters.values()):
                fail(f"scan lazy demo (drain_interval={interval}) differs from EXPECTED "
                     f"or lost work: {lines} {counters}")
            if (not skern.launches_by_mode.get("lazy") or not kern.launches_by_mode.get("drain")
                    or kern.launches_by_mode.get("default")):
                fail("scan lazy demo did not run through lazy scan_pass and drain launches")
            scan_demo["lazy"] += skern.launches_by_mode["lazy"]
    finally:
        del os.environ["CEP_SCAN_KERNEL"]

    # (f) fallback: a predicate the code generator refuses.
    caught = []

    class Catch(logging.Handler):
        def emit(self, record):
            caught.append(record.getMessage())

    handler = Catch(level=logging.WARNING)
    logging.getLogger(batch_mod.logger.name).addHandler(handler)
    try:
        fbm = scan_matcher(torch_call_pattern(Query), 64, SMALL)
        ref = BatchMatcher(torch_call_pattern(Query), 64, EngineConfig(**SMALL), device=dev)
        fev = x_batch(torch, EventBatch, np.random.default_rng(19).integers(0, 9, (64, 16)), dev)
        skern.reset_counts()
        kern.reset_counts()
        f_state, f_out = fbm.scan(fbm.init_state(), fev)
        fb_launches = dict(kern.launches_by_mode)
        r_state, r_out = ref.scan(ref.init_state(), fev)
        err = max(max_abs_err(torch, f_state, r_state), max_abs_err(torch, f_out, r_out))
    finally:
        logging.getLogger(batch_mod.logger.name).removeHandler(handler)
    if fbm.uses_scan_kernel or skern.launches or fb_launches.get("default") != 16 or err:
        fail(f"fallback: uses_scan_kernel {fbm.uses_scan_kernel}, scan_pass launches "
             f"{skern.launches}, walk_pass launches {fb_launches}, max_abs_err {err}")
    if not any("falling back to the per-step path" in m for m in caught):
        fail(f"fallback was not logged: {caught}")
    log(f"scan fallback: {caught[-1]!r}; uses_scan_kernel False; walk_pass launches "
        f"{fb_launches}, scan_pass launches 0; equal to the per-step path "
        f"({int((f_out.count > 0).sum())} match slots)")

    # (g) the kernel report's whole-scan entries.
    for mode, ms, plain_ms, bnd, by_path, on in (
        ("default", scan_k_ms, plain_head_ms, head_bound,
         {"headline": head_scan_launches, "demo": scan_demo["default"]},
         f"the headline scan, K={K}, T={T}"),
        ("lazy", lazy_chunk_ms, plain_lazy_ms, lazy_bound,
         {"lazy_path": lazy_scan_launches, "lazy_demo": scan_demo["lazy"]},
         f"the lazy path's second {LAZY_CHUNK}-step chunk, K={K}, E=96, single tier"),
    ):
        bound_ms, bound_by, mb, hops = bnd
        launches = sum(by_path.values())
        log(f"scan_pass[{mode}]: {ms:.3f} ms per scan on {on} (plain version "
            f"{plain_ms:.1f} ms over its first {PLAIN_SCAN_STEPS} steps): {mb:.1f} MB "
            f"moved, {hops} hops -> bound {bound_ms:.4f} ms ({bound_by}); launches "
            f"{by_path} [{smi}]")
        report.append({
            "name": f"scan_pass[{mode}]", "route": "cuda", "source": SCAN_SOURCE,
            "replaces": SCAN_REPLACES, "launches": launches, "launches_by_path": by_path,
            "max_abs_err": scan_err[mode], "ms": ms, "plain_ms": plain_ms,
            "plain_steps": PLAIN_SCAN_STEPS, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "timed_on": on,
        })
    log(f"whole scan phase: {time.perf_counter() - t7:.1f} s")

    log(f"total: {time.perf_counter() - t_start:.1f} s after the card check")
    log(smi)
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
