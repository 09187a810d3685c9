"""Time the walk-pass kernel built from this tree against the same kernel
built from another tree, on one GPU, in turns.

    python3 chip_ab_walk_pass.py OTHER_ROOT [ROUNDS] [--sweep] [--sweep-wide] [--ablate]

OTHER_ROOT is another checkout of the repository, for example a parent
commit unpacked with ``git archive`` into a directory ``.gitignore`` lists
(``kafkastreams_cep_tpu_torch/build/_parent``).  Both kernels are built with
nvcc, each through its own tree's wrapper (``ops/walk_kernel.py``), and fed
``chip_smoke.py``'s real inputs (:func:`real_cases`): the headline scan's
step 128 for the default instance, the stacked cell's step 32 (16 queries
x 6,400 lanes, the bank callers' instance), the lazy path's step 160 for
the two-tier, attribution and two-tier + attribution instances, its
mid-chunk handle ring for the two drain instances, whose ring occupancy
(``hr_count``) and busiest lane's hops the script prints first, and the
wide instances' inputs (:func:`wide_cases`): phase 13's escalated state at
the middle step of its last batch (wide) and phase 12's autosized config at
step 128 of its sample (two-tier + wide).  Each
instance's outputs must agree bit for bit between the two builds; then
each build is timed by CUDA events (``chip_smoke.py: kernel_ms``, device
time of launches queued back to back) in ROUNDS rounds (default 5) of
this, other, other, this.  The spike kernel (``ops/spike_kernel.py``) of
both trees is held and timed the same way at ``spike_pallas.py`` main's
inputs.  ``--sweep`` also times this build's instances with other block
shapes and register caps (:data:`SHAPES`, the most lanes a block and blocks
an SM, built from copies of ``csrc/`` under ``build/shapes/``),
``--sweep-wide`` the wide instances with :data:`WIDE_SHAPES`, and
``--ablate`` times :data:`ABLATIONS`, copies of this build with a part of
the lanes' work cut out, to show what each part costs.  Prints the card,
one line per instance with both medians, their ratio and this build's
geometry, and one JSON object last.  Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import re
import shutil
import statistics
import sys
import threading
import types
from pathlib import Path

import chip_ab_scan_pass as ab
import chip_smoke as cs

#: Block shapes of ``--sweep``: (lanes a block, blocks an SM that
#: ``__launch_bounds__`` must allow, so registers a thread <= 65536 /
#: (32 * lanes * blocks)).  The first is the committed one.
SHAPES = ((8, 4), (1, 16), (16, 2))
#: Block shapes of ``--sweep-wide``, timed on the wide instances' inputs
#: only: the same, with the blocks an SM the wide instances ask for
#: (``kMinBlocksWide``).  The first is the committed one.
WIDE_SHAPES = ((8, 2), (8, 4), (4, 8), (16, 2))


def load_walk_module(root: Path, name: str, text_edits=()):
    """``ops/walk_kernel.py`` of the tree at ``root`` as module ``name``
    (its imports resolve to this tree's package; its ``SOURCE`` to its own
    ``csrc/``), after the ``(old, new)`` replacements ``text_edits``."""
    path = root / "kafkastreams_cep_tpu_torch" / "ops" / "walk_kernel.py"
    if not text_edits:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    text = path.read_text()
    for old, new in text_edits:
        if old not in text:
            raise RuntimeError(f"{path}: {old!r} not found")
        text = text.replace(old, new)
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    exec(compile(text, str(path), "exec"), mod.__dict__)
    return mod


def shape_module(root: Path, lanes: int, blocks: int, wide: bool = False):
    """This tree's wrapper over a copy of its ``csrc/`` whose kernel serves
    ``lanes`` lanes a block and asks for ``blocks`` blocks an SM (in the
    wide instances with ``wide``)."""
    from kafkastreams_cep_tpu_torch.ops.walk_kernel import BUILD_DIR

    name = f"{lanes}x{blocks}" + ("w" if wide else "")
    csrc = BUILD_DIR / "shapes" / name
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(root / "kafkastreams_cep_tpu_torch" / "csrc", csrc)
    blocks_const = "kMinBlocksWide" if wide else "kMinBlocks"
    for f, pat, rep in (("walk_layout.cuh", r"constexpr int kWalkLanes = \d+;",
                         f"constexpr int kWalkLanes = {lanes};"),
                        ("walk_pass.cu", rf"constexpr int {blocks_const} = \d+;",
                         f"constexpr int {blocks_const} = {blocks};")):
        text = (csrc / f).read_text()
        new, n = re.subn(pat, rep, text)
        if n != 1:
            raise RuntimeError(f"{f}: {pat} not found once")
        (csrc / f).write_text(new)
    mod = load_walk_module(root, f"walk_kernel_{name}",
                           [("LANES_PER_BLOCK = 8\n", f"LANES_PER_BLOCK = {lanes}\n")])
    mod.SOURCE = csrc / "walk_pass.cu"
    return mod


#: Ablations of ``--ablate``: this build with a part of each lane's work
#: cut out of a copy of ``walk_pass.cu`` (their outputs differ, so they are
#: timed, not compared): only the copies, the copies and the puts; and the
#: whole pass with each hop's versions read where they lie (``walk_one``
#: without ``kStageRow``; equal outputs).
ABLATIONS = {
    "copies only": ("  if (w < nl) {\n", "  if (w < nl && false) {\n"),
    "copies and puts": ("    for (int base = 0; base < PW; base += 32) {\n",
                        "    for (int base = 0; base < 0; base += 32) {\n"),
    "versions not staged": ("walk_one<kTwoTier, kAttr, kDrain, true>(",
                            "walk_one<kTwoTier, kAttr, kDrain, false>("),
}


def ablation_module(root: Path, name: str, edit):
    """This tree's wrapper over a copy of its ``csrc/`` with ``edit`` (old,
    new) made once in ``walk_pass.cu``."""
    from kafkastreams_cep_tpu_torch.ops.walk_kernel import BUILD_DIR

    csrc = BUILD_DIR / "ablate" / re.sub(r"\W+", "_", name)
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(root / "kafkastreams_cep_tpu_torch" / "csrc", csrc)
    text = (csrc / "walk_pass.cu").read_text()
    if text.count(edit[0]) != 1:
        raise RuntimeError(f"walk_pass.cu: {edit[0]!r} not found once")
    (csrc / "walk_pass.cu").write_text(text.replace(edit[0], edit[1]))
    mod = load_walk_module(root, f"walk_kernel_{re.sub(r'\W+', '_', name)}")
    mod.SOURCE = csrc / "walk_pass.cu"
    return mod


def real_cases(torch, dev):
    """``chip_smoke.py``'s real walk-pass inputs, one per instance:
    ``[(instance, on, args, kwargs)]``, plus the drain input's ring figures
    (``hr_count`` max and mean, the busiest lane's drain hops, the hops in
    all).  Mid-scan states come from this tree's build."""
    import numpy as np

    from kafkastreams_cep_tpu_torch import BatchMatcher, EngineConfig, Query
    from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch, step_events
    from kafkastreams_cep_tpu_torch.parallel.stacked import (
        StackedBankMatcher, replicate_events,
    )

    K, T, chunk = cs.LANES, cs.STEPS, cs.LAZY_CHUNK
    events = cs.make_batch(torch, EventBatch, K, T, 42, dev)
    cases = []
    bm = BatchMatcher(cs.stock_pattern(Query), K, EngineConfig(**cs.HEADLINE), device=dev)
    s_mid, _ = bm.scan(bm.init_state(), cs.window(EventBatch, events, 0, T // 2))
    ev = step_events(events, T // 2)
    ph = bm.phases
    rec = ph.eval_chain(s_mid, ev)
    cases.append(("default", f"the headline scan's step {T // 2}, K={K}",
                  (s_mid.slab, *ph.build_walkers(s_mid, rec, ev), ph.max_walk,
                   ph.out_base, ph.out_rows),
                  dict(put_ops=ph.build_puts(s_mid, rec), ev_off=ev.off)))
    # The stacked cell (chip_smoke.py: bank_phase (a)).
    N, TB = cs.BANK_N, cs.BANK_STEPS
    Kq = max((cs.BANK_TOTAL_LANES // N) // 128 * 128, 128)
    prices = np.random.default_rng(13).integers(80, 141, size=(Kq, TB)).astype(np.int32)
    t = torch.arange(TB, dtype=torch.int32, device=dev)[None, :].expand(Kq, TB)
    bev = EventBatch(key=torch.arange(Kq, dtype=torch.int32, device=dev)[:, None].expand(Kq, TB),
                     value={"price": torch.as_tensor(prices, device=dev)}, ts=t, off=t,
                     valid=torch.ones((Kq, TB), dtype=torch.bool, device=dev))
    stacked = StackedBankMatcher([cs.bank_pattern(Query, i) for i in range(N)], Kq,
                                 EngineConfig(**cs.BANK_CFG), device=dev)
    b_mid, _ = stacked.scan(stacked.init_state(), cs.window(EventBatch, bev, 0, TB // 2))
    ev = step_events(replicate_events(bev, N), TB // 2)
    sph = stacked.phases
    rec = sph.eval_chain(b_mid, ev, stacked.qids)
    cases.append(("default", f"the stacked cell's step {TB // 2}, {N * Kq} lanes",
                  (b_mid.slab, *sph.build_walkers(b_mid, rec, ev), sph.max_walk,
                   sph.out_base, sph.out_rows),
                  dict(put_ops=sph.build_puts(b_mid, rec), ev_off=ev.off)))
    # The lazy path (chip_smoke.py: LAZY_PATH).
    lcfg = EngineConfig(**cs.LAZY_PATH)
    lbm = BatchMatcher(cs.stock_pattern(Query), K, lcfg, device=dev)
    mid = 2 * chunk + chunk // 2
    l_mid, _ = lbm.scan(lbm.init_state(), cs.window(EventBatch, events, 0, 2 * chunk))
    l_mid, _ = lbm.drain(l_mid)
    l_mid, _ = lbm.scan(l_mid, cs.window(EventBatch, events, 2 * chunk, mid))
    ev = step_events(events, mid)
    lph = lbm.phases
    rec = lph.eval_chain(l_mid, ev)
    wk = lph.build_walkers(l_mid, rec, ev)
    puts = lph.build_puts(l_mid, rec)
    EH = lcfg.slab_hot_entries
    no_sa = l_mid.slab._replace(stage_hops=l_mid.slab.stage_hops[:, :0])
    on = f"the lazy path's step {mid}, E=96, K={K}"
    for mode, slab, hot in (("two_tier+attribution", l_mid.slab, EH),
                            ("two_tier", no_sa, EH), ("attribution", l_mid.slab, 0)):
        cases.append((mode, on, (slab, *wk, lph.max_walk, lph.out_base, lph.out_rows),
                      dict(put_ops=puts, ev_off=ev.off, hot_entries=hot)))
    # The drain of the mid-chunk ring (engine/matcher.py: build_drain).
    HB = lcfg.handle_ring
    pend = torch.arange(HB, device=dev)[None, :] < l_mid.hr_count[:, None]
    unpin = ((l_mid.slab.stage[:, None, :] == l_mid.hr_stage[:, :, None])
             & (l_mid.slab.off[:, None, :] == l_mid.hr_off[:, :, None])
             & pend[:, :, None]).sum(dim=1, dtype=torch.int32)
    dslab = l_mid.slab._replace(refs=torch.clamp(l_mid.slab.refs - unpin, min=0))
    ones = torch.ones_like(pend)
    ring = (pend, l_mid.hr_stage, l_mid.hr_off, l_mid.hr_ver, l_mid.hr_vlen, ones, ones)
    on = f"the lazy path's ring at step {mid}, HB={HB}, K={K}"
    for mode, slab, hot in (("two_tier+attribution+drain", dslab, EH),
                            ("drain", dslab._replace(stage_hops=dslab.stage_hops[:, :0]), 0)):
        cases.append((mode, on, (slab, *ring, lph.max_walk, 0, HB),
                      dict(hot_entries=hot, drain=True)))
    from kafkastreams_cep_tpu_torch.ops.walk_kernel import walk_pass_plain

    out = walk_pass_plain(*cases[-1][2], **cases[-1][3])[0]
    hops = out.drain_hops - cases[-1][2][0].drain_hops
    hr = l_mid.hr_count.float()
    ring_stats = dict(hr_count_max=int(hr.max()), hr_count_mean=float(hr.mean()),
                      drain_hops_max=int(hops.max()), drain_hops_mean=float(hops.float().mean()),
                      drain_hops_sum=int(hops.sum()))
    del bm, stacked, lbm, s_mid, b_mid, l_mid, out
    torch.cuda.empty_cache()
    cases += wide_cases(torch, dev)
    return cases, ring_stats


def wide_cases(torch, dev):
    """The wide instances' real inputs: phase 13 (b)'s escalated state at
    the middle step of its last batch (``wide``) and phase 12 (a0)'s
    autosized config at step SURGERY_STEPS of its sample (``two_tier+wide``;
    ``chip_ab_scan_pass.py: escalated, autosized``)."""
    from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch, step_events
    from kafkastreams_cep_tpu_torch.ops import walk_kernel

    cases = []
    for make, what in ((ab.escalated, "the escalated state"),
                       (ab.autosized, "the autosized config")):
        cfg, wbm, st, ev = make(torch, dev)
        T = ev.ts.shape[1]
        if make is ab.escalated:
            st, _ = wbm.scan(st, cs.window(EventBatch, ev, 0, T // 2))
            ev, at = step_events(ev, T // 2), "the middle step of its last batch"
        else:
            ev, at = step_events(ev, 0), f"step {T} of its sample"
        ph = wbm.phases
        rec = ph.eval_chain(st, ev)
        EH = int(cfg.slab_hot_entries)
        mode = walk_kernel.mode_name(EH, st.slab.stage_hops.shape[1], False, True)
        cases.append((mode, f"{what} ({cs.shape_of(cfg)}) at {at}, K={ev.off.shape[0]}",
                      (st.slab, *ph.build_walkers(st, rec, ev), ph.max_walk, ph.out_base,
                       ph.out_rows),
                      dict(put_ops=ph.build_puts(st, rec), ev_off=ev.off, hot_entries=EH)))
        del wbm
        torch.cuda.empty_cache()
    return cases


def main() -> None:
    import torch

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        cs.fail("usage: chip_ab_walk_pass.py OTHER_ROOT [ROUNDS] [--sweep] [--sweep-wide] "
                "[--ablate], "
                "on a CUDA machine")
    args_ = [a for a in sys.argv[1:] if not a.startswith("--")]
    sweep, ablate = "--sweep" in sys.argv, "--ablate" in sys.argv
    sweep_wide = "--sweep-wide" in sys.argv
    other_root = Path(args_[0]).resolve()
    rounds = int(args_[1]) if len(args_) > 1 else 5
    from kafkastreams_cep_tpu_torch.ops import walk_kernel

    smi = ab.card()
    cs.log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    this = walk_kernel.walk_pass_kernel
    other = load_walk_module(other_root, "other_walk_kernel").walk_pass_kernel
    shapes = {}
    if sweep:
        here = Path(__file__).resolve().parent
        shapes = {s: shape_module(here, *s).WalkPassKernel() for s in SHAPES[1:]}
    if sweep_wide:
        here = Path(__file__).resolve().parent
        shapes.update({(*s, "wide"): shape_module(here, *s, wide=True).WalkPassKernel()
                       for s in WIDE_SHAPES[1:]})
    ablations = {}
    if ablate:
        here = Path(__file__).resolve().parent
        ablations = {n: ablation_module(here, n, e).WalkPassKernel()
                     for n, e in ABLATIONS.items()}
    threads = [threading.Thread(target=k.build)
               for k in [this, other, *shapes.values(), *ablations.values()]]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name, kern in [("this", this), ("other", other)] + [
            (f"{s[0]} lanes x {s[1]} blocks", k) for s, k in shapes.items()]:
        regs = [ln.split(":", 1)[-1].strip() for ln in kern.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        paths = getattr(kern, "_paths", None) or {False: kern._path}  # an older wrapper: one
        cs.log(f"build {name}: {', '.join(p.name for p in paths.values())}; ptxas {regs}")

    dev = torch.device(cs.DEVICE)
    cases, ring = real_cases(torch, dev)
    cs.log(f"drain input: hr_count max {ring['hr_count_max']}, mean "
           f"{ring['hr_count_mean']:.2f}; drain hops a lane max {ring['drain_hops_max']}, "
           f"mean {ring['drain_hops_mean']:.2f}, {ring['drain_hops_sum']} in all")
    report = []
    for mode, on, args, kw in cases:
        ref = other(*args, **kw)
        PP = kw["put_ops"].en.shape[1] if kw.get("put_ops") is not None else 0
        err = cs.max_abs_err(torch, this(*args, **kw), ref)
        if err:
            cs.fail(f"{mode} on {on}: this build != other build (max_abs_err {err})")
        g = this.geometry(args[0], PP, kw.get("hot_entries", 0), kw.get("drain", False))
        ms = {"this": [], "other": []}
        for _ in range(rounds):
            for name in ("this", "other", "other", "this"):
                kern = this if name == "this" else other
                ms[name].append(cs.kernel_ms(torch, lambda: kern(*args, **kw), 10))
        for s, kern in shapes.items():
            if len(s) > 2 and "wide" not in mode:
                continue  # the wide shapes change only the wide instances
            if cs.max_abs_err(torch, kern(*args, **kw), ref):
                cs.fail(f"{mode} on {on}: block shape {s} != other build")
            ms[f"{s[0]}x{s[1]}" + ("w" if len(s) > 2 else "")] = [
                cs.kernel_ms(torch, lambda: kern(*args, **kw), 10) for _ in range(rounds)]
        for n, kern in ablations.items():
            ms[n] = [cs.kernel_ms(torch, lambda: kern(*args, **kw), 10) for _ in range(rounds)]
        med = {n: statistics.median(v) for n, v in ms.items() if v}
        bound = cs.bound(args[0], ref[0], walk_kernel.mode_fields(
            kw.get("hot_entries", 0), args[0].stage_hops.shape[1], kw.get("drain", False)),
            list(args[1:8]) + (list(kw["put_ops"]) + [kw["ev_off"]] if PP else []),
            ref[1:], *args[0].pver.shape[1:])
        sweep_txt = "".join(f"; {n} {v:.4f}" for n, v in med.items()
                            if n not in ("this", "other"))
        cs.log(f"walk_pass[{mode}] on {on}: this {med['this']:.4f} ms, other "
               f"{med['other']:.4f} ms, this/other {med['this'] / med['other']:.3f} "
               f"(medians of {2 * rounds} turns; outputs equal); {g['lanes_a_block']} lanes "
               f"a block, arena {g['arena_bytes']} B, {g['lanes_per_sm']} lanes an SM, "
               f"{g['registers']} registers, {g['local_bytes']} B local; bound "
               f"{bound[0]:.4f} ms ({bound[1]}, {bound[2]:.1f} MB){sweep_txt} [{smi}]")
        report.append({"mode": mode, "on": on, "this_ms": med["this"],
                       "other_ms": med["other"], "medians": med, "runs": ms,
                       "geometry": g, "bound_ms": bound[0], "bound_mb": bound[2]})
    report.append(spike_ab(torch, dev, other_root, rounds, smi))
    print(json.dumps({"card": smi, "ring": ring, "ab": report}), flush=True)


def spike_ab(torch, dev, other_root: Path, rounds: int, smi: str) -> dict:
    """The spike kernel of this tree and of ``other_root`` at
    ``spike_pallas.py`` main's inputs: equal outputs, then timed in turns
    as the walk pass is."""
    from kafkastreams_cep_tpu_torch.ops import spike_kernel

    path = other_root / "kafkastreams_cep_tpu_torch" / "ops" / "spike_kernel.py"
    spec = importlib.util.spec_from_file_location("other_spike_kernel", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    this, other = spike_kernel.spike_kernel, mod.SpikeKernel()
    x = cs.spike_inputs(torch, 0, dev)
    if not torch.equal(this(*x), other(*x)):
        cs.fail("spike: this build != other build")
    ms = {"this": [], "other": []}
    for _ in range(rounds):
        for name in ("this", "other", "other", "this"):
            kern = this if name == "this" else other
            ms[name].append(cs.kernel_ms(torch, lambda: kern(*x), 50))
    med = {n: statistics.median(v) for n, v in ms.items()}
    cs.log(f"spike on spike_pallas.py main's inputs: this {med['this']:.4f} ms, other "
           f"{med['other']:.4f} ms, this/other {med['this'] / med['other']:.4f} (medians of "
           f"{2 * rounds} turns; outputs equal) [{smi}]")
    return {"mode": "spike", "on": "spike_pallas.py main's inputs", "this_ms": med["this"],
            "other_ms": med["other"], "medians": med, "runs": ms}


if __name__ == "__main__":
    main()
