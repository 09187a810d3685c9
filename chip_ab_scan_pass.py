"""Time the whole-scan kernel built from this tree against the same kernel
built from another tree, on one GPU, in turns.

    python3 chip_ab_scan_pass.py OTHER_ROOT [ROUNDS] [--sass]

OTHER_ROOT is another checkout of the repository, for example a parent
commit unpacked with ``git archive`` into a directory ``.gitignore`` lists
(``kafkastreams_cep_tpu_torch/build/_parent``).  Both trees'
``csrc/scan_pass.cu`` are built with nvcc for the same generated
``cep_pattern.h`` in every instance of ``chip_smoke.py``'s report, each
through its own tree's wrapper (``ops/scan_kernel.py``), and fed
``chip_smoke.py``'s real inputs: the K=4096 x T=256 headline scan (default,
two-tier, attribution, two-tier + attribution), the lazy path's second
64-step chunk at E=96 (lazy, lazy + attribution, lazy + two-tier, lazy +
two-tier + attribution) and the tiered cell's first planted 128-step batch
(tiered, lazy + tiered, two-tier + attribution + tiered), and the wide
instance over the next 64 steps of phase 13's escalated state
(:func:`escalated`); and, for the placement rule of the slab's pointer
rows, the headline scan in the default instance at smaller slabs (E in
``SWEEP_E``).  Each instance's state, frames and promotions must agree bit
for bit between the two builds (this build in both placements of the
slab's pointer rows); then each build is timed by CUDA events in ROUNDS
rounds (default 5) of this, other, other, this, and this build's other
placement once a round.  With ``--sass`` the script first holds
the machine code of each pair of libraries against each other
(``cuobjdump -sass``, instructions and function names only) and prints
whether they are identical.  Prints the card, one line per instance with
both medians, their ratio and this build's geometry, and one JSON object
last.  Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

#: Slab sizes of the placement sweep (the headline config at E rows).
SWEEP_E = (16, 24, 32, 40)
#: The config ``chip_smoke.py`` phase 12 (a0)'s autosize reaches on
#: ``bench_processor``'s columns from the headline config (it prints it):
#: B1's two-tier + wide instance.
AUTOSIZED = dict(max_runs=16, slab_entries=112, slab_hot_entries=24, slab_preds=16,
                 dewey_depth=368, max_walk=44)


def stream_columns(torch, EventBatch, dev, K: int, T: int, b: int, t0: int = 0):
    """Batch ``b`` of ``bench_processor``'s stream (``chip_smoke.py:
    processor_stream``, ``K x T`` records a batch) as the ``[K, T]`` columns
    a processor hands its matcher: lane k takes record ``t * K + k`` at step
    t, timestamps ``b * K * T`` on, offsets ``t0 + b * T`` on."""
    import numpy as np

    _, prices, volumes = cs.processor_stream(K, T)
    rec = np.arange(T)[None, :] * K + np.arange(K)[:, None]
    i32 = torch.int32
    return EventBatch(
        key=torch.arange(K, dtype=i32, device=dev)[:, None].expand(K, T).contiguous(),
        value={"price": torch.as_tensor(prices[rec].astype(np.int32), device=dev),
               "volume": torch.as_tensor(volumes[rec].astype(np.int32), device=dev)},
        ts=torch.as_tensor((b * K * T + rec).astype(np.int32), device=dev),
        off=(t0 + b * T + torch.arange(T, dtype=i32, device=dev))[None, :].expand(K, T)
        .contiguous(),
        valid=torch.ones((K, T), dtype=torch.bool, device=dev),
    )


def escalated(torch, dev):
    """``chip_smoke.py`` phase 13 (b)'s escalated deployment, rebuilt
    without the supervisor: ``bench_processor``'s stream (K=SUP_LANES,
    ESC_STEPS steps a batch) from the headline config, batch by batch; a
    batch that loses work escalates the config (``sizing.escalate`` under
    ``EscalationPolicy(max_rounds=ESC_ROUNDS)``, the supervisor's rule) and
    runs again from the earlier batches' state at the wider config, until a
    batch has run wide after an escalation (phase 13's stop).  Returns
    ``(config, matcher, state before the last batch, the last batch)``; the
    phase's wide-from-start processor holds that state."""
    from kafkastreams_cep_tpu_torch import BatchMatcher, EngineConfig, Query
    from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch
    from kafkastreams_cep_tpu_torch.engine.sizing import (
        EscalationPolicy, capacity_counters, escalate,
    )

    K, T = cs.SUP_LANES, cs.ESC_STEPS
    pattern = cs.stock_pattern(Query)
    policy = EscalationPolicy(max_rounds=cs.ESC_ROUNDS)
    cfg, wide_at, shapes = EngineConfig(**cs.HEADLINE), None, []
    for b in range(cs.ESC_BATCHES):
        for _ in range(cs.ESC_ROUNDS + 1):
            bm = BatchMatcher(pattern, K, cfg, device=dev)
            st = bm.init_state()
            for i in range(b):
                st, _ = bm.scan(st, stream_columns(torch, EventBatch, dev, K, T, i))
            before = capacity_counters(bm.counters(st))
            after, _ = bm.scan(st, stream_columns(torch, EventBatch, dev, K, T, b))
            tripped = {k: v - before[k] for k, v in capacity_counters(bm.counters(after)).items()
                       if v > before[k]}
            del after
            new = escalate(cfg, tripped, policy) if tripped else None
            if new is None:
                break
            cfg = new
            shapes.append(cs.shape_of(cfg))
        if wide_at is not None:
            cs.log(f"escalated state: {len(shapes)} escalations ({', '.join(shapes)}), "
                   f"{b + 1} batches of {K} x {T}")
            return cfg, bm, st, stream_columns(torch, EventBatch, dev, K, T, b)
        if cfg.dewey_depth > 32 or cfg.slab_preds > 32:
            wide_at = b
    cs.fail(f"no batch ran wide after an escalation in {cs.ESC_BATCHES} batches "
            f"({cs.shape_of(cfg)})")


def autosized(torch, dev):
    """``chip_smoke.py`` phase 12 (a0)'s input to B1's two-tier + wide
    instance: the :data:`AUTOSIZED` config over the first SURGERY_STEPS
    steps of ``bench_processor``'s columns (K=SURGERY_LANES).  Returns
    ``(config, matcher, state at that step, the step's batch)``."""
    from kafkastreams_cep_tpu_torch import BatchMatcher, EngineConfig, Query
    from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch

    K, T = cs.SURGERY_LANES, cs.SURGERY_STEPS
    cfg = EngineConfig(**dict(cs.HEADLINE, **AUTOSIZED))
    bm = BatchMatcher(cs.stock_pattern(Query), K, cfg, device=dev)
    st, _ = bm.scan(bm.init_state(), stream_columns(torch, EventBatch, dev, K, T, 0))
    return cfg, bm, st, stream_columns(torch, EventBatch, dev, K, T, 1, t0=0)


def load_scan_module(root: Path, name: str):
    """``ops/scan_kernel.py`` of the tree at ``root`` as module ``name``
    (its imports resolve to this tree's package; its ``CSRC`` to its own
    ``csrc/``)."""
    path = root / "kafkastreams_cep_tpu_torch" / "ops" / "scan_kernel.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass(lib: Path) -> list:
    """The machine code of a library: ``cuobjdump -sass``'s function names
    and instruction lines (without the paths and build details around them)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    return [ln.strip() for ln in out.splitlines()
            if ln.strip().startswith(("Function :", "/*"))]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def real_cases(torch, dev):
    """``chip_smoke.py``'s real whole-scan inputs, one per instance:
    ``[(instance, on, (source, config, state, events), promo)]``.  Mid-scan
    states come from this tree's build."""
    from kafkastreams_cep_tpu_torch import BatchMatcher, EngineConfig, Query
    from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch
    from kafkastreams_cep_tpu_torch.ops import scan_codegen, scan_kernel
    from kafkastreams_cep_tpu_torch.parallel.tiered import TieredBatchMatcher

    K, T, chunk = cs.LANES, cs.STEPS, cs.LAZY_CHUNK
    events = cs.make_batch(torch, EventBatch, K, T, 42, dev)
    letters = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    os.environ["CEP_SCAN_KERNEL"] = "1"
    try:
        heads = [BatchMatcher(cs.stock_pattern(Query), K,
                              EngineConfig(**dict(cs.HEADLINE, **extra)), device=dev)
                 for extra in [{}] + [cs.mode_extra(m, cs.HEADLINE) for m in cs.SCAN_MODES]
                 + [dict(slab_entries=e) for e in SWEEP_E]]
        lazies = [BatchMatcher(cs.stock_pattern(Query), K, EngineConfig(**conf), device=dev)
                  for conf in (cs.LAZY_SINGLE, dict(cs.LAZY_SINGLE, stage_attribution=True),
                               dict(cs.LAZY_PATH, stage_attribution=False), cs.LAZY_PATH)]
        tiers = [TieredBatchMatcher(cs.bench_tier_pattern(Query), K,
                                    EngineConfig(**cs.TIER_CELL, tiering=True, **extra),
                                    device=dev)
                 for extra in cs.TIER_MODES.values()]
    finally:
        os.environ.pop("CEP_SCAN_KERNEL", None)
    srcs = [scan_codegen.generate(m.matcher.tables, events.value) for m in heads + lazies]
    srcs += [scan_codegen.generate(m.matcher.tables, letters) for m in tiers]
    modes = [scan_kernel.mode_of(m.matcher.config) for m in heads + lazies]
    modes += [scan_kernel.mode_of(m.matcher.config, tiered=True) for m in tiers]
    scan_kernel.scan_pass_kernel.build(*zip(srcs, modes))  # every nvcc together
    src_of = dict(zip(map(id, heads + lazies + tiers), srcs))

    cases = []
    for bm in heads:
        E = bm.matcher.config.slab_entries
        cases.append((scan_kernel.mode_name(bm.matcher.config),
                      f"the headline scan, K={K}, T={T}" if E == cs.HEADLINE["slab_entries"]
                      else f"the placement sweep's headline scan at E={E}",
                      (src_of[id(bm)], bm.matcher.config, bm.init_state(), events), None))
    chunk2 = cs.window(EventBatch, events, chunk, 2 * chunk)
    for bm in lazies:
        st, _ = bm.scan(bm.init_state(), cs.window(EventBatch, events, 0, chunk))
        st, _ = bm.drain(st)
        cases.append((scan_kernel.mode_name(bm.matcher.config),
                      f"the lazy path's second {chunk}-step chunk, E=96, K={K}",
                      (src_of[id(bm)], bm.matcher.config, st, chunk2), None))
    codes, hot = cs.tier_cell_codes(K, cs.TIER_STEPS)
    tev = cs.letters_batch(torch, EventBatch, codes, dev)
    b0 = hot[0] * cs.TIER_CHUNK
    ev_b = cs.window(EventBatch, tev, b0, b0 + cs.TIER_CHUNK)
    for tk in tiers:
        st = tk.init_state()
        for c0 in range(0, b0, cs.TIER_CHUNK):
            st, _ = tk.scan(st, cs.window(EventBatch, tev, c0, c0 + cs.TIER_CHUNK))
            st = tk.drain(st)[0]
        _, feed = tk._prefix.scan(st.carry, ev_b)
        cases.append((scan_kernel.mode_name(tk.matcher.config, tiered=True),
                      f"the tiered cell's batch at step {b0}, K={K}",
                      (src_of[id(tk)], tk.matcher.config, st.engine, ev_b),
                      (tk._promote, feed)))
    # The wide instance: the escalated state's next batch (phase 13 (b)).
    del heads, lazies, tiers
    torch.cuda.empty_cache()
    cfg, ebm, est, eev = escalated(torch, dev)
    esrc = scan_codegen.generate(ebm.matcher.tables, eev.value)
    scan_kernel.scan_pass_kernel.build((esrc, scan_kernel.mode_of(cfg)))
    cases.append((scan_kernel.mode_name(cfg),
                  f"the escalated state's next {eev.ts.shape[1]} steps ({cs.shape_of(cfg)}), "
                  f"K={eev.ts.shape[0]}", (esrc, cfg, est, eev), None))
    return cases


def main() -> None:
    import torch

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        cs.fail("usage: chip_ab_scan_pass.py OTHER_ROOT [ROUNDS] [--sass], on a CUDA machine")
    args_ = [a for a in sys.argv[1:] if not a.startswith("--")]
    other_root = Path(args_[0]).resolve()
    rounds = int(args_[1]) if len(args_) > 1 else 5
    from kafkastreams_cep_tpu_torch.ops import scan_kernel

    smi = card()
    cs.log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device(cs.DEVICE)
    cases = real_cases(torch, dev)
    other_mod = load_scan_module(other_root, "other_scan_kernel")
    this, other = scan_kernel.scan_pass_kernel, other_mod.ScanPassKernel()
    items = [(args[0], scan_kernel.mode_of(args[1], promo is not None))
             for _, _, args, promo in cases]
    libs = this.build(*items)
    # An older tree's Mode may have fewer fields (no ``wide``): these
    # instances are narrow in both.
    n_other = len(other_mod.Mode._fields)
    other_libs = other.build(*[(src, other_mod.Mode(*mode[:n_other])) for src, mode in items])
    same_sass = {}
    if "--sass" in sys.argv:
        for (mode, on, _, _), a, b in zip(cases, libs, other_libs):
            sa, sb = sass(a), sass(b)
            same_sass[f"{mode} on {on}"] = sa == sb
            diff = [(x, y) for x, y in zip(sa, sb) if x != y]
            cs.log(f"sass scan_pass[{mode}] on {on}: {a.name} vs {b.name}: "
                   + ("identical" if sa == sb else
                      f"differs ({len(diff) + abs(len(sa) - len(sb))} of "
                      f"{max(len(sa), len(sb))} lines)")
                   + f", {len(sa)} lines"
                   + "".join(f"\n  this:  {x}\n  other: {y}" for x, y in diff[:4]))
    for name, kern in (("this", this), ("other", other)):
        for lib, log in kern.build_logs.items():
            regs = "; ".join(ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                             if "registers" in ln or "spill" in ln)
            cs.log(f"build {name}: {lib}: ptxas {regs}")

    report = []
    for mode, on, args, promo in cases:
        def run(kern, **kw):
            return kern(*args, promo=promo, **kw)

        want = run(other)
        got = run(this)
        torch.cuda.synchronize()
        err = cs.max_abs_err(torch, got, want)
        if err:
            cs.fail(f"{mode}: this build != other build (max_abs_err {err})")
        geo = this.geometry(*args[:3], tiered=promo is not None)
        alt_kw = dict(pv_shared=not geo["pv_shared"])
        try:
            err = cs.max_abs_err(torch, run(this, **alt_kw), want)
        except ValueError as e:  # the other placement does not fit
            alt_kw = None
            cs.log(f"{mode}: the other pv placement is refused: {e}")
        if err:
            cs.fail(f"{mode}: the other pv placement != other build (max_abs_err {err})")
        del got, want
        reps = 2 if args[3].ts.shape[1] > cs.TIER_CHUNK else 5
        ms = {"this": [], "other": [], "alt": []}
        for _ in range(rounds):
            for name in ("this", "other", "other", "this"):
                kern = this if name == "this" else other
                ms[name].append(cs.cuda_ms(torch, lambda: run(kern), reps))
            if alt_kw:
                ms["alt"].append(cs.cuda_ms(torch, lambda: run(this, **alt_kw), reps))
        med = {n: statistics.median(v) for n, v in ms.items() if v}
        alt_txt = ""
        if "alt" in med:
            alt_txt = (f"; pv {'in device memory' if geo['pv_shared'] else 'shared'} "
                       f"instead: {med['alt']:.4f} ms")
        geo_txt = (f"; pv {'shared' if geo['pv_shared'] else 'in device memory'}, "
                   f"{geo['lane_bytes']} B a lane, {geo['lanes_per_sm']} lanes an SM, "
                   f"{geo['registers']} registers")
        cs.log(f"scan_pass[{mode}] on {on}: this {med['this']:.4f} ms, other "
               f"{med['other']:.4f} ms, this/other {med['this'] / med['other']:.3f} "
               f"(medians of {2 * rounds} turns; outputs equal){geo_txt}{alt_txt} [{smi}]")
        report.append({"mode": mode, "on": on, "this_ms": med["this"],
                       "other_ms": med["other"], "alt_ms": med.get("alt"), "geometry": geo,
                       "this_runs": ms["this"], "other_runs": ms["other"]})
    print(json.dumps({"card": smi, "ab": report, "same_sass": same_sass}), flush=True)


if __name__ == "__main__":
    main()
