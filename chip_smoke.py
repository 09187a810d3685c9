"""Build the PyTorch port's CUDA kernels and drive its main path on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. build    — compile every kernel of the main path from the repo's sources
              with nvcc for sm_90a;
2. parity   — hold each kernel against its plain PyTorch version on the
              card, bit for bit, on random inputs made by numpy from a seed
              (K in {1, 37, 4096}, two slab configs, with and without puts);
3. headline — ``BatchMatcher.scan`` at K=4096 lanes with the headline config
              (``bench.py``'s): the first 32 steps through the kernel and
              through the plain pass must agree bit for bit;
4. main path — two paths, each with the launch count set to 0 just before
              it and read just after: the stock demo through ``CEPProcessor``
              on the card must print ``examples/stock_demo.py``'s four lines
              byte for byte with all counters 0; then the K=4096 x T=256
              headline scan is timed (CUDA events around a consumed
              reduction) after an untimed warm-up scan;
5. kernel timing — the walk-pass kernel and its plain version, timed on the
              slab-phase inputs of a mid-scan headline step, beside the
              kernel's bound.

The last two lines of standard output are the kernel report (one JSON
object) and the device line ``{"ok": true, "device": {...}}``; the card's
name and power limit (nvidia-smi) come on the line before the report.  The
script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    from kafkastreams_cep_tpu_torch import BatchMatcher, CEPProcessor, EngineConfig, Query, Record
    from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch, make_step
    from kafkastreams_cep_tpu_torch.parallel.batch import step_events
    from kafkastreams_cep_tpu_torch.ops import walk_inputs, walk_kernel

    dev = torch.device("cuda")
    kern = walk_kernel.walk_pass_kernel
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    path = kern.build()
    log(f"build: walk_pass -> {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in kern.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"build: ptxas {line.strip()}")

    # 2. parity on random inputs --------------------------------------------
    max_err = 0
    for name, (E, MP, D, W, R, H) in {
        "test_walk_kernel": (16, 4, 6, 8, 4, 2),
        "headline": (48, 8, 12, 12, 24, 3),
    }.items():
        for K in (1, 37, 4096):
            arrs = walk_inputs.random_inputs(K, K, E, MP, D, R, H)
            slab, wk, puts, ev_off = walk_inputs.as_tensors(arrs, dev)
            PW = wk[0].shape[1]
            for with_puts in (False, True):
                kw = dict(put_ops=puts, ev_off=ev_off) if with_puts else {}
                got = kern(slab, *wk, W, PW - R, R, **kw)
                want = walk_kernel.walk_pass_plain(slab, *wk, W, PW - R, R, **kw)
                torch.cuda.synchronize()
                err = max_abs_err(torch, got, want)
                max_err = max(max_err, err)
                log(f"parity: {name} K={K} puts={with_puts}: max_abs_err {err}")
                if err:
                    fail(f"walk_pass kernel != plain ({name}, K={K}, puts={with_puts})")

    # 3. headline: kernel vs plain path, step by step -----------------------
    K, T, T_CMP = 4096, 256, 32
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
        max_err = max(max_err, err)
        if err:
            fail(f"headline step {t}: kernel path != plain path (max_abs_err {err})")
    torch.cuda.synchronize()
    log(f"headline: {T_CMP} steps kernel path == plain path, bit for bit "
        f"({time.perf_counter() - t0:.1f} s); counters {bm.counters(s_k)}")

    # 4. the main path, with launch counts from 0 ----------------------------
    kern.launches = 0
    proc = CEPProcessor(
        stock_pattern(Query), num_lanes=1,
        config=EngineConfig(max_runs=32, slab_entries=64, slab_preds=8,
                            dewey_depth=16, max_walk=16),
        topic="StockEvents", device=dev,
    )
    name_of = {i: ev["name"] for i, ev in enumerate(STOCK_EVENTS)}
    records = [
        Record("stocks", {"price": ev["price"], "volume": ev["volume"]}, 1000 + i)
        for i, ev in enumerate(STOCK_EVENTS)
    ]
    lines = [format_match(seq, name_of) for _, seq in proc.process(records)]
    for line in lines:
        log(f"demo: {line}")
    counters = proc.counters()
    if lines != EXPECTED:
        fail(f"demo output differs from examples/stock_demo.py EXPECTED: {lines}")
    if any(counters.values()):
        fail(f"demo counters not all zero: {counters}")
    demo_launches = kern.launches
    if not demo_launches:
        fail("demo ran without launching the walk-pass kernel")
    log(f"demo: README parity OK, counters all 0, walk_pass launches {demo_launches}")

    state0 = bm.init_state()
    t0 = time.perf_counter()
    state, out = bm.scan(state0, events)
    total = int(out.count.sum())
    warm_s = time.perf_counter() - t0
    del state, out
    kern.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state, out = bm.scan(state0, events)
    hits = (out.count > 0).sum()  # a reduction of the outputs, consumed below
    end.record()
    torch.cuda.synchronize()
    scan_ms = start.elapsed_time(end)
    n_hits = int(hits)
    headline_launches = kern.launches
    if headline_launches != T:
        fail(f"walk_pass launches {headline_launches} in the timed scan, want {T}")
    launches = demo_launches + headline_launches
    if int(out.count.sum()) != total or not n_hits:
        fail("timed headline scan disagrees with the warm-up scan or found no match")
    if int(out.count.min()) < 0 or int(out.count.max()) > cfg.max_walk:
        fail("headline match counts out of range")
    log(f"headline: K={K} T={T}: warm-up scan {warm_s:.2f} s; timed scan "
        f"{scan_ms:.1f} ms = {scan_ms / T:.3f} ms/step, "
        f"{K * T / (scan_ms / 1e3):.0f} events/s, {n_hits} run-slot matches, "
        f"counters {bm.counters(state)} [{smi}]")

    # 5. kernel timing on a mid-scan headline step ---------------------------
    ph = bm.phases
    s_mid, _ = bm.scan(state0, EventBatch(
        events.key[:, :T // 2], {k: v[:, :T // 2] for k, v in events.value.items()},
        events.ts[:, :T // 2], events.off[:, :T // 2], events.valid[:, :T // 2],
    ))
    ev = step_events(events, T // 2)
    rec = ph.eval_chain(s_mid, ev)
    ops = ph.build_puts(s_mid, rec)
    wk = ph.build_walkers(s_mid, rec, ev)
    args = (s_mid.slab, *wk, ph.max_walk, ph.out_base, ph.out_rows)
    kw = dict(put_ops=ops, ev_off=ev.off)
    got = kern(*args, **kw)
    want = walk_kernel.walk_pass_plain(*args, **kw)
    err = max_abs_err(torch, got, want)
    if err:
        fail(f"mid-scan step: kernel != plain (max_abs_err {err})")
    ms = cuda_ms(torch, lambda: kern(*args, **kw), 50)
    plain_ms = cuda_ms(torch, lambda: walk_kernel.walk_pass_plain(*args, **kw), 3)
    # Where a step's time goes: the chain and queue builders, the kernel,
    # the queue compaction (CUDA events around each, mean of 8 steps).
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
    def nbytes(xs):  # bytes of the tensors as the engine hands them over
        return sum(x.numel() * x.element_size() for x in xs)

    slab_bytes = nbytes(getattr(s_mid.slab, f) for f in (
        "stage", "off", "refs", "npreds", "pstage", "poff", "pvlen", "pver",
        "missing", "trunc", "full_drops", "pred_drops", "walk_hops", "extract_hops"))
    in_bytes = slab_bytes + nbytes(wk) + nbytes(ops) + nbytes([ev.off])
    out_bytes = slab_bytes + nbytes(got[1:])
    hops = int((got[0].walk_hops + got[0].extract_hops - s_mid.slab.walk_hops
                - s_mid.slab.extract_hops).sum())
    E, MP, D = cfg.slab_entries, cfg.slab_preds, cfg.dewey_depth
    ops_count = hops * (2 * E + MP * 3 * D)  # per hop: key compares + compat
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_count / INT_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"walk_pass: {ms:.3f} ms/launch (plain {plain_ms:.1f} ms) at K={K}, "
        f"{(in_bytes + out_bytes) / 1e6:.1f} MB moved -> bound {bound_ms:.4f} ms "
        f"({hops} hops); launches on the main path: demo {demo_launches}, "
        f"timed headline scan {headline_launches} [{smi}]")

    report = {"kernels": [{
        "name": "walk_pass", "route": "cuda",
        "source": "kafkastreams_cep_tpu_torch/csrc/walk_pass.cu",
        "replaces": "kafkastreams_cep_tpu/ops/walk_kernel.py:734",
        "launches": launches, "demo_launches": demo_launches,
        "headline_launches": headline_launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}
    log(smi)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
