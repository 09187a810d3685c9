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
placement raises ``ValueError`` before a launch.
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
       "p_en", "p_first", "w_en", "b_en", "bytes"]
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
      l.b_vlen, l.b_event, l.b_start, l.b_agg, l.stc, l.sh, l.p_en, l.p_first,
      l.w_en, l.b_en, l.bytes};
  for (size_t i = 0; i < sizeof(v) / sizeof(v[0]); ++i) out[i] = (long long)v[i];
}
extern "C" int pv_rule(const int* d) {
  return scan_pv_shared(d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7] != 0,
                        d[8] != 0);
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


def dims_of(name):
    conf = getattr(cs, name)
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
    attr = bool(getattr(cs, name).get("stage_attribution", False))
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
