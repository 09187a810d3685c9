"""Time the walk-pass kernel built from this tree against the same kernel
built from another tree, on one GPU, in turns.

    python3 chip_ab_walk_pass.py OTHER_ROOT [ROUNDS]

OTHER_ROOT is another checkout of the repository, for example a parent
commit unpacked with ``git archive`` into a directory ``.gitignore`` lists.
Both kernels are built with nvcc and fed ``chip_smoke.py``'s real inputs:
the headline scan's step 128 for the default instance, the lazy path's step
160 for the two-tier, attribution and two-tier + attribution instances, and
its mid-chunk handle ring for the two drain instances.  Each instance's
outputs must agree bit for bit between the two builds; then each build is
timed by CUDA events in ROUNDS rounds (default 5) of this, other, other,
this.  Prints the card, one line per instance with both medians and their
ratio, and one JSON object last.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs


def main() -> None:
    import torch

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        cs.fail("usage: chip_ab_walk_pass.py OTHER_ROOT [ROUNDS], on a CUDA machine")
    other_csrc = Path(sys.argv[1]) / "kafkastreams_cep_tpu_torch" / "csrc"
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    from kafkastreams_cep_tpu_torch import BatchMatcher, EngineConfig, Query
    from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch, step_events
    from kafkastreams_cep_tpu_torch.ops import walk_kernel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    cs.log(f"card: {smi}")
    this = walk_kernel.walk_pass_kernel
    this.build()
    # The other build: the module reads its source paths at build time.
    source, header = walk_kernel.SOURCE, walk_kernel.HEADER
    walk_kernel.SOURCE = other_csrc / "walk_pass.cu"
    other_header = other_csrc / "walk_pass.cuh"
    walk_kernel.HEADER = other_header if other_header.exists() else walk_kernel.SOURCE
    other = walk_kernel.WalkPassKernel()
    try:
        other.build()
    finally:
        walk_kernel.SOURCE, walk_kernel.HEADER = source, header
    for name, kern in (("this", this), ("other", other)):
        regs = [ln.strip() for ln in kern.build_log.splitlines() if "registers" in ln]
        cs.log(f"build {name}: {kern._path.name}; ptxas {regs}")

    dev = torch.device(cs.DEVICE)
    K, T, chunk = cs.LANES, cs.STEPS, cs.LAZY_CHUNK
    events = cs.make_batch(torch, EventBatch, K, T, 42, dev)
    cases = []  # (mode, args, kwargs)
    bm = BatchMatcher(cs.stock_pattern(Query), K, EngineConfig(**cs.HEADLINE), device=dev)
    s_mid, _ = bm.scan(bm.init_state(), cs.window(EventBatch, events, 0, T // 2))
    ev = step_events(events, T // 2)
    ph = bm.phases
    rec = ph.eval_chain(s_mid, ev)
    cases.append(("default", (s_mid.slab, *ph.build_walkers(s_mid, rec, ev), ph.max_walk,
                              ph.out_base, ph.out_rows),
                  dict(put_ops=ph.build_puts(s_mid, rec), ev_off=ev.off)))
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
    for mode, slab, hot in (("two_tier+attribution", l_mid.slab, EH),
                            ("two_tier", no_sa, EH), ("attribution", l_mid.slab, 0)):
        cases.append((mode, (slab, *wk, lph.max_walk, lph.out_base, lph.out_rows),
                      dict(put_ops=puts, ev_off=ev.off, hot_entries=hot)))
    HB = lcfg.handle_ring
    pend = torch.arange(HB, device=dev)[None, :] < l_mid.hr_count[:, None]
    unpin = ((l_mid.slab.stage[:, None, :] == l_mid.hr_stage[:, :, None])
             & (l_mid.slab.off[:, None, :] == l_mid.hr_off[:, :, None])
             & pend[:, :, None]).sum(dim=1, dtype=torch.int32)
    dslab = l_mid.slab._replace(refs=torch.clamp(l_mid.slab.refs - unpin, min=0))
    ones = torch.ones_like(pend)
    ring = (pend, l_mid.hr_stage, l_mid.hr_off, l_mid.hr_ver, l_mid.hr_vlen, ones, ones)
    for mode, slab, hot in (("two_tier+attribution+drain", dslab, EH),
                            ("drain", dslab._replace(stage_hops=dslab.stage_hops[:, :0]), 0)):
        cases.append((mode, (slab, *ring, lph.max_walk, 0, HB),
                      dict(hot_entries=hot, drain=True)))

    report = []
    for mode, args, kw in cases:
        err = cs.max_abs_err(torch, this(*args, **kw), other(*args, **kw))
        if err:
            cs.fail(f"{mode}: this build != other build (max_abs_err {err})")
        ms = {"this": [], "other": []}
        for _ in range(rounds):
            for name in ("this", "other", "other", "this"):
                kern = this if name == "this" else other
                ms[name].append(cs.cuda_ms(torch, lambda: kern(*args, **kw), 10))
        med = {n: statistics.median(v) for n, v in ms.items()}
        cs.log(f"walk_pass[{mode}]: this {med['this']:.4f} ms, other {med['other']:.4f} ms, "
               f"this/other {med['this'] / med['other']:.3f} (medians of {2 * rounds} turns; "
               f"outputs equal) [{smi}]")
        report.append({"mode": mode, "this_ms": med["this"], "other_ms": med["other"],
                       "this_runs": ms["this"], "other_runs": ms["other"]})
    print(json.dumps({"card": smi, "ab": report}), flush=True)


if __name__ == "__main__":
    main()
