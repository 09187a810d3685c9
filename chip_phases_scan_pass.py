"""Where a whole scan's time goes, phase by phase, on one GPU.

    python3 chip_phases_scan_pass.py [ROOT ...]

For each ROOT (default: this tree) the script copies the tree's
``csrc/`` to ``kafkastreams_cep_tpu_torch/build/phases/<n>/`` (not
committed) and adds a ``clock64()`` probe in
front of each numbered phase comment of the kernel's step loop
(``// 1.`` ... ``// 7.``: the empty frame, the chains, the puts, the
walkers, the lazy ring, the compaction, the promotion) and a per-phase
tally that thread 0 of each lane adds to a device counter after the loop;
the time before the loop counts as phase 0 (loading the lane).  Inside
``walk_pass.cuh: walk_one`` four more probes split the walkers' time into
the row lookup (``warp_find``), the version check and ballot, the step to
the chosen pointer, and the compaction of pruned rows after the walk (and
the same four in ``walk_one_wide``, its check ending where the hop's
writes begin).  The committed kernel carries no probe.  Each instrumented
instance then runs on ``chip_ab_scan_pass.py``'s real inputs (the headline
scan in four instances, the lazy path's chunk in two, the tiered batch in
one, the escalated state's batch in the wide one), through
its own tree's wrapper, once to warm up and once counted; the script prints
each phase's share of the lane cycles, the cycles a lane spends on one step,
the card, and one JSON object last.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import inspect
import itertools
import json
import re
import shutil
import sys
from pathlib import Path

import chip_ab_scan_pass as ab
import chip_smoke as cs

PHASES = ("load", "frame", "chains", "puts", "walkers", "lazy ring", "compaction",
          "promotion")
WALK = ("find", "check", "step", "prune")
INSTANCES = ("default", "two_tier", "attribution", "two_tier+attribution", "lazy",
             "lazy+two_tier+attribution", "tiered", "wide")
_DECL = ("unsigned long long cep_pa_[8] = {}; long long cep_pl_ = clock64(); "
         "int cep_pc_ = 0;\nif (threadIdx.x < 4) cep_wsub_[threadIdx.x] = 0;\n__syncwarp();\n")
_PROBE = ("{ const long long n_ = clock64(); cep_pa_[cep_pc_] += n_ - cep_pl_; "
          "cep_pl_ = n_; cep_pc_ = %d; }\n")
_FLUSH = ("  { const long long n_ = clock64(); cep_pa_[cep_pc_] += n_ - cep_pl_; }\n"
          "  if (threadIdx.x == 0) {\n"
          "    for (int i_ = 0; i_ < 8; ++i_) atomicAdd(&cep_phase_acc[i_], cep_pa_[i_]);\n"
          "    for (int i_ = 0; i_ < 4; ++i_) atomicAdd(&cep_phase_acc[8 + i_], cep_wsub_[i_]);\n"
          "  }\n")
_WPROBE = ("{ const long long n_ = clock64(); if (threadIdx.x == 0) "
           "cep_wsub_[cep_wi_] += n_ - cep_wl_; cep_wl_ = n_; cep_wi_ = %d; }\n")
#: The walk functions' probes: (anchor line, probe placed after (True) or
#: before (False) it, the sub-phase it starts), in ``walk_one`` and, with
#: the check ending where the hop's writes begin, in ``walk_one_wide``.
_WALK_PROBES = (
    ("  for (int h = 0; h < W && active; ++h) {", True, 0),
    ("    const int e = warp_find(st, of, E, cs, co);", True, 1),
    ("    const unsigned okm = __ballot_sync(kFull, ok);", True, 2),
    ("  c.trunc += active;", False, 3),
)
_WIDE_PROBES = _WALK_PROBES[:2] + (
    ("    __syncwarp();\n    if (t == 0) {\n      rf[e] = newref;", False, 2),
) + _WALK_PROBES[3:]
_TAIL = """
extern "C" int cep_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, cep_phase_acc, sizeof(cep_phase_acc));
}
extern "C" int cep_phase_reset() {
  unsigned long long z[12] = {};
  return (int)cudaMemcpyToSymbol(cep_phase_acc, z, sizeof(z));
}
"""


def instrument(src: str) -> str:
    """``scan_pass.cu`` with the phase probes added."""
    lines = src.splitlines(keepends=True)
    out, in_loop, seen = [], False, set()
    for line in lines:
        if line.startswith('#include "walk_pass.cuh"'):
            out.append(line)
            out.append("__device__ unsigned long long cep_phase_acc[12];\n")
            continue
        if re.match(r"^  for \(int tt = 0; tt < T; \+\+tt\) \{$", line):
            in_loop = True
            out.append(line)
            continue
        if in_loop and line.rstrip("\n") == "  }":
            in_loop = False
            out.append(line)
            out.append(_FLUSH)
            continue
        m = re.match(r"^\s*// ([1-7])\. ", line)
        if in_loop and m:
            seen.add(int(m.group(1)))
            out.append(_PROBE % int(m.group(1)))
        out.append(line)
        if re.match(r"^__global__ void .*\{$", line):
            out.append(_DECL)
    text = "".join(out)
    if "cep_pa_[8]" not in text or _FLUSH not in text or not {1, 2, 3, 4, 6} <= seen:
        raise RuntimeError(f"could not place the probes (phases found: {sorted(seen)})")
    return text + _TAIL


def _probe_walk(body: str, probes) -> str:
    """One walk function's body with its probes added."""
    for anchor, after, k in probes:
        if body.count(anchor + "\n") != 1:
            raise RuntimeError(f"walk probe anchor not found once: {anchor!r}")
        probe = _WPROBE % k
        body = body.replace(anchor + "\n", anchor + "\n" + probe if after else probe + anchor + "\n")
    decl = "  bool active = true;\n"
    body = body.replace(decl, decl + "  long long cep_wl_ = clock64(); int cep_wi_ = 0;\n", 1)
    close = "  if (t == 0 && ocnt) *ocnt = cnt;\n"
    return body.replace(close, "  if (threadIdx.x == 0) cep_wsub_[cep_wi_] += clock64() - cep_wl_;\n"
                        + close, 1)


def instrument_walk(src: str) -> str:
    """``walk_pass.cuh`` with the probes of ``walk_one`` and, where the
    tree has it, ``walk_one_wide`` added."""
    src = src.replace("namespace {\n", "namespace {\n\n__shared__ unsigned long long cep_wsub_[4];\n", 1)
    narrow = src.index("__device__ __forceinline__ void walk_one(")
    wide = src.find("__device__ __forceinline__ void walk_one_wide(")
    if wide < 0:
        return src[:narrow] + _probe_walk(src[narrow:], _WALK_PROBES)
    return (src[:narrow] + _probe_walk(src[narrow:wide], _WALK_PROBES)
            + _probe_walk(src[wide:], _WIDE_PROBES))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        cs.fail("chip_phases_scan_pass.py needs a CUDA machine")
    from kafkastreams_cep_tpu_torch.ops.walk_kernel import BUILD_DIR

    roots = [Path(r).resolve() for r in sys.argv[1:]] or [Path(__file__).resolve().parent]
    smi = ab.card()
    cs.log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device(cs.DEVICE)
    cases = [c for c in ab.real_cases(torch, dev) if c[0] in INSTANCES and "sweep" not in c[1]]
    report = []
    for i, root in enumerate(roots):
        mod = ab.load_scan_module(root, f"phases_scan_kernel_{i}")
        csrc = BUILD_DIR / "phases" / str(i)
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(root / "kafkastreams_cep_tpu_torch" / "csrc", csrc)
        (csrc / "scan_pass.cu").write_text(instrument((csrc / "scan_pass.cu").read_text()))
        (csrc / "walk_pass.cuh").write_text(instrument_walk((csrc / "walk_pass.cuh").read_text()))
        mod.CSRC = csrc.resolve()
        kern = mod.ScanPassKernel()
        items = [(args[0], mod.mode_of(args[1], promo is not None))
                 for _, _, args, promo in cases]
        kern.build(*items)
        placements = [{}]
        if "pv_shared" in inspect.signature(kern.__call__).parameters:
            placements = [dict(pv_shared=True), dict(pv_shared=False)]
        for ((mode, on, args, promo), (src, m)), kw in itertools.product(
                list(zip(cases, items)), placements):
            lib = kern._libs[(src.tag, m)]
            try:
                kern(*args, promo=promo, **kw)  # warm-up
            except ValueError as e:  # a placement whose arena does not fit
                cs.log(f"phases [{root.name}] scan_pass[{mode}]: {kw} refused: {e}")
                continue
            torch.cuda.synchronize()
            lib.cep_phase_reset()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            kern(*args, promo=promo, **kw)
            end.record()
            torch.cuda.synchronize()
            acc = (ctypes.c_ulonglong * 12)()
            if lib.cep_phase_read(acc):
                cs.fail(f"{root}: {mode}: reading the phase counters failed")
            cyc, walk = list(acc)[:8], list(acc)[8:]
            total = sum(cyc)
            K, T = args[3].ts.shape
            shares = {p: c / total for p, c in zip(PHASES, cyc)}
            where = {True: "; pointer rows shared", False: "; pointer rows in device memory"}
            on = on + where.get(kw.get("pv_shared"), "")
            cs.log(f"phases [{root.name}] scan_pass[{mode}] on {on}: "
                   + ", ".join(f"{p} {100 * s:.1f} %" for p, s in shares.items())
                   + "; in the walkers: " + ", ".join(
                       f"{w} {100 * c / max(sum(walk), 1):.1f} %" for w, c in zip(WALK, walk))
                   + f"; {total / (K * T):.0f} cycles a lane-step; instrumented scan "
                   f"{start.elapsed_time(end):.3f} ms [{smi}]")
            report.append({"root": str(root), "mode": mode, "on": on, "cycles": cyc,
                           "walk_cycles": walk,
                           "lane_steps": K * T, "ms": start.elapsed_time(end)})
    print(json.dumps({"card": smi, "phases": report}), flush=True)


if __name__ == "__main__":
    main()
