"""Where a walk pass's time goes, phase by phase, on one GPU.

    python3 chip_phases_walk_pass.py [ROOT ...]

For each ROOT (default: this tree) the script copies the tree's ``csrc/``
to ``kafkastreams_cep_tpu_torch/build/phases_walk/<n>/`` (not committed)
and adds ``clock64()`` probes to the copy of ``walk_pass.cu``: in front of
each numbered phase comment of the kernel (``// 1.`` ... ``// 6.``: copy
in, the puts, reading the walker queue or the drain's ring, the walks,
waiting for the block's other lanes, copy out) or, in a tree whose kernel
has no numbered phases (the design before the shared-memory arena), in
front of the statements :data:`OLD_ANCHORS` names; the time before the
first probe counts as phase 0 (set-up).  Inside ``walk_pass.cuh:
walk_one`` four more probes split the walks into the row lookup
(``warp_find``), the version check and ballot, the step to the chosen
pointer, and the compaction of pruned rows after the walk (the anchors of
``chip_phases_scan_pass.py``, each tallied per warp).  Thread 0 of each
lane's warp adds its tallies to a device counter at the kernel's end.  The
committed kernel carries no probe; the wide instances' walk
(``walk_one_wide``) takes the same four probes, its check ending where the
hop's writes begin.  Each instrumented tree then runs
``chip_ab_walk_pass.py``'s real inputs (:data:`CASES`: the headline step,
the stacked step, the lazy step in two-tier + attribution, the drain, and
the wide instances' escalated and autosized steps),
through its own tree's wrapper, once to warm up and once counted; the
script prints each phase's share of the lane cycles, the cycles a lane
spends, the card, and one JSON object last.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import sys
from pathlib import Path

import chip_ab_scan_pass as ab
import chip_ab_walk_pass as abw
import chip_phases_scan_pass as phs
import chip_smoke as cs

PHASES = ("set-up", "copy in", "puts", "walker reads", "walks", "wait", "copy out")
WALK = phs.WALK
#: The real inputs of chip_ab_walk_pass.py that are measured:
#: (instance, the start of its input's description).
CASES = (("default", "the headline"), ("default", "the stacked"),
         ("two_tier+attribution", "the lazy path's step"), ("drain", "the lazy path's ring"),
         ("wide", "the escalated"), ("two_tier+wide", "the autosized"))
#: Probes of a kernel without numbered phases: (anchor line, phase).
OLD_ANCHORS = (
    ("  for (int i = t; i < E; i += 32) {\n", 1),
    ("  if (a.with_puts) {\n", 2),
    ("  const size_t wk = (size_t)k * PW;\n", 4),
    ("  if (t == 0) {\n    a.o_missing[k] = c.missing;\n", 6),
)
_DECL = ("unsigned long long cep_pa_[7] = {}; long long cep_pl_ = clock64(); int cep_pc_ = 0;\n"
         "if (threadIdx.x < 4) cep_wsub_[threadIdx.y * 4 + threadIdx.x] = 0;\n__syncwarp();\n")
_PROBE = ("{ const long long n_ = clock64(); cep_pa_[cep_pc_] += n_ - cep_pl_; "
          "cep_pl_ = n_; cep_pc_ = %d; }\n")
_FLUSH = ("  { const long long n_ = clock64(); cep_pa_[cep_pc_] += n_ - cep_pl_; }\n"
          "  if (threadIdx.x == 0 && blockIdx.x * blockDim.y + threadIdx.y < a.K) {\n"
          "    for (int i_ = 0; i_ < 7; ++i_) atomicAdd(&cep_phase_acc[i_], cep_pa_[i_]);\n"
          "    for (int i_ = 0; i_ < 4; ++i_)\n"
          "      atomicAdd(&cep_phase_acc[8 + i_], cep_wsub_[threadIdx.y * 4 + i_]);\n"
          "    atomicAdd(&cep_phase_acc[12], 1ull);\n"
          "  }\n")
_TAIL = """
extern "C" int cep_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, cep_phase_acc, sizeof(cep_phase_acc));
}
extern "C" int cep_phase_reset() {
  unsigned long long z[16] = {};
  return (int)cudaMemcpyToSymbol(cep_phase_acc, z, sizeof(z));
}
"""


def instrument(src: str) -> str:
    """``walk_pass.cu`` with the phase probes added."""
    head = src.index('#include "walk_pass.cuh"\n') + len('#include "walk_pass.cuh"\n')
    src = src[:head] + "__device__ unsigned long long cep_phase_acc[16];\n" + src[head:]
    start = re.search(r"\bwalk_pass\(Args a\) \{\n", src)
    if not start:
        raise RuntimeError("kernel walk_pass(Args a) not found")
    body0 = start.end()
    close = src.index("\n}\n", body0) + 1  # the kernel's closing brace
    body = src[body0:close]
    numbered = re.findall(r"^\s*// ([1-6])\. ", body, re.M)
    if numbered:
        body = re.sub(r"^(\s*)// ([1-6])\. ", lambda m: _PROBE % int(m.group(2)) + m.group(0),
                      body, flags=re.M)
        if not {"1", "2", "3", "4", "6"} <= set(numbered):
            raise RuntimeError(f"numbered phases found: {sorted(set(numbered))}")
    else:
        for anchor, k in OLD_ANCHORS:
            if anchor not in body:
                raise RuntimeError(f"anchor not found: {anchor!r}")
            body = body.replace(anchor, _PROBE % k + anchor, 1)
    return src[:body0] + _DECL + body + _FLUSH + src[close:] + _TAIL


def instrument_walk(src: str) -> str:
    """``walk_pass.cuh`` with walk_one's probes, tallied per warp."""
    src = phs.instrument_walk(src)
    src = src.replace("__shared__ unsigned long long cep_wsub_[4];",
                      "__shared__ unsigned long long cep_wsub_[32];")
    return src.replace("cep_wsub_[cep_wi_]", "cep_wsub_[threadIdx.y * 4 + cep_wi_]")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        cs.fail("chip_phases_walk_pass.py needs a CUDA machine")
    from kafkastreams_cep_tpu_torch.ops.walk_kernel import BUILD_DIR

    roots = [Path(r).resolve() for r in sys.argv[1:]] or [Path(__file__).resolve().parent]
    smi = ab.card()
    cs.log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device(cs.DEVICE)
    all_cases, _ = abw.real_cases(torch, dev)
    cases = [c for c in all_cases if any(c[0] == m and c[1].startswith(o) for m, o in CASES)]
    report = []
    for i, root in enumerate(roots):
        csrc = BUILD_DIR / "phases_walk" / str(i)
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(root / "kafkastreams_cep_tpu_torch" / "csrc", csrc)
        (csrc / "walk_pass.cu").write_text(instrument((csrc / "walk_pass.cu").read_text()))
        (csrc / "walk_pass.cuh").write_text(instrument_walk((csrc / "walk_pass.cuh").read_text()))
        mod = abw.load_walk_module(root, f"phases_walk_kernel_{i}")
        mod.SOURCE = csrc / "walk_pass.cu"
        if hasattr(mod, "HEADER"):  # a wrapper that hashes one header by name
            mod.HEADER = csrc / "walk_pass.cuh"
        kern = mod.WalkPassKernel()
        kern.build()
        # This tree's libraries by width (an older wrapper has one library).
        libs = getattr(kern, "_libs", None) or {False: kern._lib, True: kern._lib}
        for lib in libs.values():
            lib.cep_phase_read.restype = ctypes.c_int
            lib.cep_phase_reset.restype = ctypes.c_int
        for mode, on, args, kw in cases:
            lib = libs["wide" in mode]
            kern(*args, **kw)  # warm-up
            torch.cuda.synchronize()
            lib.cep_phase_reset()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            kern(*args, **kw)
            end.record()
            torch.cuda.synchronize()
            acc = (ctypes.c_ulonglong * 16)()
            if lib.cep_phase_read(acc):
                cs.fail(f"{root}: {mode}: reading the phase counters failed")
            cyc, walk, lanes = list(acc)[:7], list(acc)[8:12], acc[12]
            total = max(sum(cyc), 1)
            cs.log(f"phases [{root.name}] walk_pass[{mode}] on {on}: "
                   + ", ".join(f"{p} {100 * c / total:.1f} %" for p, c in zip(PHASES, cyc))
                   + "; in the walks: " + ", ".join(
                       f"{w} {100 * c / max(sum(walk), 1):.1f} %" for w, c in zip(WALK, walk))
                   + f"; {total / max(lanes, 1):.0f} cycles a lane ({lanes} lanes); "
                   f"instrumented pass {start.elapsed_time(end):.4f} ms [{smi}]")
            report.append({"root": str(root), "mode": mode, "on": on, "cycles": cyc,
                           "walk_cycles": walk, "lanes": lanes,
                           "ms": start.elapsed_time(end)})
    print(json.dumps({"card": smi, "phases": report}), flush=True)


if __name__ == "__main__":
    main()
