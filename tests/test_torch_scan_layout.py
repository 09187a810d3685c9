"""The whole-scan kernel's shared-memory arena, compiled on the CPU.

``csrc/scan_layout.cuh`` places each array of a lane's slab, run queue and
step scratch in the block's shared memory and decides whether the slab's
pointer rows (``pstage``, ``poff``, ``pvlen``, ``pver``) join them; the
wrapper (``ops/scan_kernel.py``) mirrors both in Python and the kernel
refuses a launch whose arena size disagrees.  This suite compiles the
header with ``g++`` into a shared library under ``tmp_path`` (skipping
where there is no ``g++``), as ``tests/test_torch_scan_codegen.py`` does
for the generated pattern header, and checks, for every configuration
``chip_smoke.py`` scans with the pattern it scans it with:

* every offset and the arena's size equal the Python mirror's, in both
  placements, with and without stage attribution;
* every array is 16-byte aligned and lies inside the arena;
* the rule's placement (C and Python agree) and that the chosen lane fits
  a block's 227 KB;

and that the widest pointer rows the kernel takes (E=96, MP=32, D=32) stay
in device memory without raising, while a lane too large for any
placement raises ``ValueError`` before a launch; and that the wide
instance's lane keeps no array of D digits in its arena (the run digits
and the put ops' versions in device scratch, ``scan_scratch_words``), so
that at the escalated shape an SM's shared memory holds many lanes.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import pytest
import torch

from kafkastreams_cep_tpu_torch import BatchMatcher, EngineConfig, Query
from kafkastreams_cep_tpu_torch.compiler.tables import lower
from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch
from kafkastreams_cep_tpu_torch.ops import scan_codegen, scan_kernel

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402

#: The fields of ``ScanLayout`` in the order the shim writes them (the
#: Python mirror's names; ``run<b>.<f>`` for the two run buffers).
FIELDS = (
    ["st", "of", "rf", "np", "dead", "ps", "po", "pl", "pv"]
    + [f"run{b}.{f}" for b in (0, 1)
       for f in scan_kernel._RUN_ARRAYS + ("ver", "agg")]
    + ["p_cur", "p_pst", "p_pof", "p_pvl", "p_ver", "p_sc", "p_list", "p_free",
       "w_stage", "w_off", "w_vlen", "w_run", "w_list",
       "r_id", "r_eval", "r_vlen", "r_event", "r_start", "r_bits", "r_agg",
       "b_id", "b_eval", "b_vlen", "b_event", "b_start", "b_agg", "stc", "sh",
       "p_bump", "c_src", "c_bump", "p_en", "p_first", "w_en", "b_en", "bytes"]
)

SHIM = r"""
#include "scan_layout.cuh"
#define RUN(q) q.alive, q.branching, q.id, q.eval, q.vlen, q.event, q.start, q.ver, q.agg
extern "C" void layout(const int* d, long long* out) {
  const ScanLayout l = scan_layout(d[0], d[1], d[2], d[3], d[4], d[5], d[6],
                                   d[7] != 0, d[8] != 0);
  const size_t v[] = {
      l.st, l.of, l.rf, l.np, l.dead, l.ps, l.po, l.pl, l.pv, RUN(l.run[0]),
      RUN(l.run[1]), l.p_cur, l.p_pst, l.p_pof, l.p_pvl, l.p_ver, l.p_sc,
      l.p_list, l.p_free,
      l.w_stage, l.w_off, l.w_vlen, l.w_run, l.w_list, l.r_id, l.r_eval,
      l.r_vlen, l.r_event, l.r_start, l.r_bits, l.r_agg, l.b_id, l.b_eval,
      l.b_vlen, l.b_event, l.b_start, l.b_agg, l.stc, l.sh, l.p_bump, l.c_src,
      l.c_bump, l.p_en, l.p_first, l.w_en, l.b_en, l.bytes};
  for (size_t i = 0; i < sizeof(v) / sizeof(v[0]); ++i) out[i] = (long long)v[i];
}
extern "C" int pv_rule(const int* d) {
  return scan_pv_shared(d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7] != 0,
                        d[8] != 0);
}
extern "C" long long scratch_words(int R, int D, int H, int wide) {
  return (long long)scan_scratch_words(R, D, H, wide != 0);
}
extern "C" long long smem_per_block() { return (long long)kSmemPerBlock; }
extern "C" long long pv_shared_max() { return (long long)kPvSharedMaxBytes; }
extern "C" long long pv_shared_max_tiered() { return (long long)kPvSharedMaxBytesTiered; }
"""

#: chip_smoke.py's scanned configurations: the pattern each is scanned
#: with, whether its scans are tiered, and where the rule puts its pointer
#: rows.
CONFIGS = {
    "HEADLINE": ("stock", False, False),
    "DEMO": ("stock", False, False),
    "LAZY_PATH": ("stock", False, False),
    "LAZY_SINGLE": ("stock", False, False),
    "TIER_PARITY": ("hybrid", True, False),
    "TIER_CELL": ("bench_tier", True, True),
    "SMALL": ("stock", False, True),
    "MIXED_CFG": ("mixed", False, False),
    "WIDE_SCAN": ("stock", False, False),
    "WIDE_TIER": ("hybrid", True, False),
    "ESCALATED": ("stock", False, False),
    "ESCALATED_D192": ("stock", False, False),
    "AUTOSIZED": ("stock", False, False),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the layout header on the host")
    d = tmp_path_factory.mktemp("scan_layout")
    (d / "shim.cpp").write_text(SHIM)
    out = d / "libshim.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{scan_kernel.CSRC}",
         str(d / "shim.cpp"), "-o", str(out)],
        check=True, capture_output=True, text=True,
    )
    shim = ctypes.CDLL(str(out))
    shim.smem_per_block.restype = ctypes.c_longlong
    shim.pv_shared_max.restype = ctypes.c_longlong
    shim.pv_shared_max_tiered.restype = ctypes.c_longlong
    return shim


def pattern_dims(kind):
    """``(H, NS, S)`` of the pattern chip_smoke.py scans a config with."""
    pattern = {
        "stock": lambda: cs.stock_pattern(Query),
        "hybrid": lambda: next(iter(cs.HYBRID.values()))(Query),
        "bench_tier": lambda: cs.bench_tier_pattern(Query),
        "mixed": lambda: cs.mixed_patterns(Query)[0],
    }[kind]()
    tables = lower(pattern)
    return tables.max_hops, max(tables.num_states, 1), tables.num_stages


#: Configurations besides chip_smoke.py's constants: its wide whole-scan
#: and tiered cases, and the headline config escalated to D=48, MP=16
#: (EscalationPolicy's doubling; at E=96 its pointer rows, 295 KB of pver
#: a lane, stay in device memory).
EXTRA = {
    "WIDE_SCAN": dict(cs.HEADLINE, **cs.WIDE),
    "WIDE_TIER": dict(cs.TIER_PARITY, **cs.WIDE),
    "ESCALATED": dict(cs.HEADLINE, slab_entries=96, slab_preds=16, dewey_depth=48),
    # Phase 13's escalated state (E=96, MP=16, D=192) and phase 12's
    # autosized config (chip_ab_scan_pass.py: AUTOSIZED).
    "ESCALATED_D192": dict(cs.HEADLINE, slab_entries=96, slab_preds=16, dewey_depth=192),
    "AUTOSIZED": dict(cs.HEADLINE, max_runs=16, slab_entries=112, slab_hot_entries=24,
                      slab_preds=16, dewey_depth=368, max_walk=44),
}


def conf_of(name):
    return EXTRA[name] if name in EXTRA else getattr(cs, name)


def dims_of(name):
    conf = conf_of(name)
    H, NS, S = pattern_dims(CONFIGS[name][0])
    return (conf["max_runs"], conf["slab_entries"], conf["slab_preds"],
            conf["dewey_depth"], H, NS, S)


def c_layout(lib, dims, attr, pv_shared):
    out = (ctypes.c_longlong * len(FIELDS))()
    lib.layout((ctypes.c_int * 9)(*dims, int(attr), int(pv_shared)), out)
    return dict(zip(FIELDS, out))


def test_constants_match(lib):
    assert lib.smem_per_block() == scan_kernel.SMEM_PER_BLOCK
    assert lib.pv_shared_max() == scan_kernel.PV_SHARED_MAX_BYTES
    assert lib.pv_shared_max_tiered() == scan_kernel.PV_SHARED_MAX_BYTES_TIERED


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layout_matches_mirror(lib, name):
    dims = dims_of(name)
    for attr in (False, True):
        for pv in (True, False):
            got = c_layout(lib, dims, attr, pv)
            want = scan_kernel.lane_layout(*dims, attr, pv)
            if not pv:  # no pointer rows in the arena: C reports offset 0
                want = dict(want, ps=0, po=0, pl=0, pv=0)
            assert got == {f: want[f] for f in FIELDS}, (name, attr, pv)
            assert all(o % 16 == 0 for o in got.values())
            assert max(got.values()) == got["bytes"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pointer_rows_placement(lib, name):
    dims = dims_of(name)
    _, tiered, placed = CONFIGS[name]
    attr = bool(conf_of(name).get("stage_attribution", False))
    shared = scan_kernel.pv_in_shared(*dims, attr, tiered)
    assert lib.pv_rule((ctypes.c_int * 9)(*dims, int(attr), int(tiered))) == shared
    assert shared == placed
    nbytes = scan_kernel.lane_layout(*dims, attr, shared)["bytes"]
    assert nbytes <= scan_kernel.SMEM_PER_BLOCK
    limit = (scan_kernel.PV_SHARED_MAX_BYTES_TIERED if tiered
             else scan_kernel.PV_SHARED_MAX_BYTES)
    assert shared == (scan_kernel.lane_layout(*dims, attr, True)["bytes"] <= limit)


def _arena(conf):
    bm = BatchMatcher(cs.stock_pattern(Query), 2, EngineConfig(**conf), device="cpu")
    ev = cs.make_batch(torch, EventBatch, 2, 4, 0, "cpu")
    source = scan_codegen.generate(bm.matcher.tables, ev.value)
    return scan_kernel.ScanPassKernel.arena(source, bm.matcher.config, bm.init_state())


def test_widest_pointer_rows_stay_in_device_memory():
    pv_shared, nbytes = _arena(dict(max_runs=24, slab_entries=96, slab_preds=32,
                                    dewey_depth=32, max_walk=12))
    assert not pv_shared
    assert nbytes <= scan_kernel.SMEM_PER_BLOCK


def test_lane_too_large_for_shared_memory_raises():
    with pytest.raises(ValueError, match="shared memory"):
        _arena(dict(max_runs=512, slab_entries=96, slab_preds=8, dewey_depth=32,
                    max_walk=12))


#: An H100 SM's shared memory (228 KB) and what the runtime reserves of it
#: for each resident block (1 KB).
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024


@pytest.mark.parametrize("MP, D", [(8, 12), (32, 32), (40, 48), (16, 192), (16, 368)])
def test_scratch_matches_mirror(lib, MP, D):
    """The wide instance keeps its run digits and put versions in device
    scratch; a narrow one keeps them in the arena and takes none."""
    wide = MP > 32 or D > 32
    lib.scratch_words.restype = ctypes.c_longlong
    want = scan_kernel.scratch_words(24, D, 3, wide)
    assert lib.scratch_words(24, D, 3, int(wide)) == want
    assert want == ((2 * 24 + 24 * 3) * D if wide else 0)


@pytest.mark.parametrize("name, at_most, lanes", [("ESCALATED_D192", 16 * 1024, 16),
                                                  ("AUTOSIZED", 16 * 1024, 16)])
def test_wide_lane_arena_is_small(name, at_most, lanes):
    """At the escalated shape (R=24, E=96, MP=16, D=192) the previous wide
    lane held both run buffers' digits and the put ops' versions in its
    arena, 85 KB or more, and an SM two lanes; with them in device scratch a
    lane takes under 16 KB and an SM's shared memory holds at least the 16
    lanes the kernel's register cap (kMinLanes) allows."""
    dims = dims_of(name)
    attr = bool(conf_of(name).get("stage_attribution", False))
    R, D, H = dims[0], dims[3], dims[4]
    assert not scan_kernel.pv_in_shared(*dims, attr, False)
    layout = scan_kernel.lane_layout(*dims, attr, False)
    assert layout["bytes"] <= at_most
    assert SMEM_PER_SM // (layout["bytes"] + SMEM_RESERVED_PER_BLOCK) >= lanes
    assert layout["run0.ver"] == layout["run0.agg"]  # no digits in the arena
    digits = (2 * R + R * H) * D * 4  # what the previous arena held besides
    assert digits == 4 * scan_kernel.scratch_words(R, D, H, True)
    assert SMEM_PER_SM // (layout["bytes"] + digits + SMEM_RESERVED_PER_BLOCK) <= 2
