"""The walk-pass kernel's shared-memory arena, compiled on the CPU.

``csrc/walk_layout.cuh`` places each array of a block's lanes' slab keys,
tombstones, staged versions, stage tallies, put ops and scratch in the
block's shared memory and decides how many lanes a block serves (up to
eight, fewer where that many do not fit); the wrapper
(``ops/walk_kernel.py``) mirrors both in Python and the kernel refuses a
launch that disagrees.  This suite compiles the header with ``g++`` into a
shared library under ``tmp_path`` (skipping where there is no ``g++``), as
``tests/test_torch_scan_layout.py`` does for the whole scan's arena, and
checks, for every configuration ``chip_smoke.py`` runs the walk pass with
(its puts, two-tier slab, stage tally or drain as that path has them):

* every offset and the arena's size equal the Python mirror's, at the
  block's lane count and at one lane;
* every array is 16-byte aligned and lies inside the arena;
* the lanes a block serves (C and Python agree, and as listed), that their
  arena fits a block's 227 KB and that one lane more would not;

and that the widest lane the kernel takes (E=96, MP=32, D=32) is served
eight a block, that slabs past what eight lanes' arena holds are served in
smaller blocks down to one lane, while a lane too large for a block raises
``ValueError`` before a launch.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import pytest

from kafkastreams_cep_tpu_torch import Query
from kafkastreams_cep_tpu_torch.compiler.tables import lower
from kafkastreams_cep_tpu_torch.ops import walk_inputs, walk_kernel
from kafkastreams_cep_tpu_torch.ops.slab import SlabState

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402

FIELDS = ("st", "of", "rf", "np", "dead", "row", "q", "sh", "p_sc", "p_list", "p_free",
          "p_cur", "p_pst", "p_pof", "p_pvl", "p_en", "p_first", "spans", "bytes")

SHIM = r"""
#include "walk_layout.cuh"
extern "C" void layout(const int* d, long long* out) {
  const WalkLayout l = walk_layout(d[0], d[1], d[2], d[3], d[4], d[5], d[6] != 0);
  const size_t v[] = {l.st, l.of, l.rf, l.np, l.dead, l.row, l.q, l.sh, l.p_sc,
                      l.p_list, l.p_free, l.p_cur, l.p_pst, l.p_pof, l.p_pvl,
                      l.p_en, l.p_first, l.spans, l.bytes};
  for (size_t i = 0; i < sizeof(v) / sizeof(v[0]); ++i) out[i] = (long long)v[i];
}
extern "C" int lanes_rule(const int* d) {
  return walk_lanes(d[0], d[1], d[2], d[3], d[4], d[5] != 0);
}
extern "C" int lanes() { return kWalkLanes; }
extern "C" int wide(int MP, int D) { return walk_wide(MP, D); }
extern "C" int dead_words(int MP) { return walk_dead_words(MP); }
extern "C" long long smem_per_block() { return (long long)kSmemPerBlock; }
extern "C" int put_cols() { return kScanPutCols; }
extern "C" long long span_bytes() { return (long long)kWalkSpanBytes; }
"""


def _pattern_dims(kind):
    """``(H, S)`` of the pattern chip_smoke.py runs a config with: frames a
    run (put ops a run) and stages (the stage tally's width)."""
    pattern = {
        "stock": lambda: cs.stock_pattern(Query),
        "bank": lambda: cs.bank_pattern(Query, 0),
        "tenant": lambda: cs.tenant_pattern(Query, 1, 2, 3),
        "mixed": lambda: cs.mixed_patterns(Query)[0],
        "bench_tier": lambda: cs.bench_tier_pattern(Query),
    }[kind]()
    tables = lower(pattern)
    return tables.max_hops, tables.num_stages


def _engine(name, kind, drain=False):
    """``(E, MP, D, PP, S, puts)`` of a walk pass over config ``name`` run
    with pattern ``kind`` (a drain has no puts; the closed-form puts run
    single tier)."""
    conf = getattr(cs, name)
    H, stages = _pattern_dims(kind)
    PP = 0 if drain else conf["max_runs"] * H
    S = stages if conf.get("stage_attribution") else 0
    puts = not drain and not conf.get("slab_hot_entries")
    return (conf["slab_entries"], conf["slab_preds"], conf["dewey_depth"], PP, S, puts)


def _parity(E, MP, D, R, H, EH=0, S=0, drain=False):
    """A random parity case of chip_smoke.py (phase 2 and its mode cases)."""
    return (E, MP, D, 0 if drain else R * H, S, not drain and not EH)


#: Every walk pass chip_smoke.py runs: its dims and the lanes a block
#: serves.
CONFIGS = {
    "HEADLINE": (_engine("HEADLINE", "stock"), 8),
    "DEMO": (_engine("DEMO", "stock"), 8),
    "LAZY_PATH": (_engine("LAZY_PATH", "stock"), 8),
    "LAZY_PATH drain": (_engine("LAZY_PATH", "stock", drain=True), 8),
    "LAZY_SINGLE drain": (_engine("LAZY_SINGLE", "stock", drain=True), 8),
    "TIER_PARITY": (_engine("TIER_PARITY", "bench_tier"), 8),
    "TIER_CELL": (_engine("TIER_CELL", "bench_tier"), 8),
    "BANK_CFG": (_engine("BANK_CFG", "bank"), 8),
    "TENANT_CFG": (_engine("TENANT_CFG", "tenant"), 8),
    "MIXED_CFG": (_engine("MIXED_CFG", "mixed"), 8),
    "parity test_walk_kernel": (_parity(16, 4, 6, 4, 2), 8),
    "parity test_walk_kernel two_tier+attribution": (_parity(16, 4, 6, 4, 2, 8, 4), 8),
    "parity test_walk_kernel drain": (_parity(16, 4, 6, 4, 2, drain=True), 8),
    "parity headline": (_parity(48, 8, 12, 24, 3), 8),
    "parity headline two_tier+attribution+drain": (_parity(48, 8, 12, 24, 3, 16, 4, True), 8),
    "parity misaligned": (_parity(25, 3, 5, 4, 2), 8),
    "parity misaligned two_tier+attribution": (_parity(25, 3, 5, 4, 2, 8, 4), 8),
    "parity wide": (_parity(1536, 8, 12, 24, 3), 5),
    "parity wide two_tier+attribution": (_parity(1536, 8, 12, 24, 3, 16, 4), 7),
    "parity wide drain": (_parity(1536, 8, 12, 24, 3, drain=True), 7),
    "parity d48_mp40": (_parity(24, 40, 48, 8, 3), 8),
    "parity d48_mp40 two_tier+attribution+drain": (_parity(24, 40, 48, 8, 3, 16, 4, True), 8),
    "parity d96_mp64": (_parity(16, 64, 96, 4, 3), 8),
    "parity d96_mp64 two_tier+attribution": (_parity(16, 64, 96, 4, 3, 8, 4), 8),
    # The headline config escalated to D=48 (EscalationPolicy's doubling)
    # and its pointer lists to 16.
    "escalated headline": ((96, 16, 48, 72, 0, True), 8),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the layout header on the host")
    d = tmp_path_factory.mktemp("walk_layout")
    (d / "shim.cpp").write_text(SHIM)
    out = d / "libshim.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
         f"-I{walk_kernel.SOURCE.parent}", str(d / "shim.cpp"), "-o", str(out)],
        check=True, capture_output=True, text=True,
    )
    shim = ctypes.CDLL(str(out))
    shim.smem_per_block.restype = ctypes.c_longlong
    shim.span_bytes.restype = ctypes.c_longlong
    return shim


def c_layout(lib, dims, lanes):
    out = (ctypes.c_longlong * len(FIELDS))()
    lib.layout((ctypes.c_int * 7)(lanes, *map(int, dims)), out)
    return dict(zip(FIELDS, out))


def c_lanes(lib, dims):
    return lib.lanes_rule((ctypes.c_int * 6)(*map(int, dims)))


@pytest.mark.parametrize("MP, D", [(1, 1), (8, 12), (32, 32), (33, 5), (8, 33), (40, 48),
                                   (64, 96), (65, 200)])
def test_wide_rule_matches_mirror(lib, MP, D):
    """Which slabs run the wide instances, and their tombstone words a row."""
    assert bool(lib.wide(MP, D)) == walk_kernel.is_wide(MP, D) == (MP > 32 or D > 32)
    assert lib.dead_words(MP) == walk_kernel.dead_words(MP) == max(1, -(-MP // 32))


def test_constants_match(lib):
    assert lib.lanes() == walk_kernel.LANES_PER_BLOCK
    assert lib.smem_per_block() == walk_kernel.SMEM_PER_BLOCK
    assert lib.put_cols() == walk_kernel.PUT_COLS
    assert lib.span_bytes() == walk_kernel.SPAN_BYTES


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layout_matches_mirror(lib, name):
    dims, lanes = CONFIGS[name]
    for n in sorted({1, lanes}):
        got = c_layout(lib, dims, n)
        want = walk_kernel.block_layout(*dims, lanes=n)
        assert got == {f: want[f] for f in FIELDS}, (name, n)
        assert all(o % 16 == 0 for o in got.values())
        assert max(got.values()) == got["bytes"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lanes_a_block(lib, name):
    dims, lanes = CONFIGS[name]
    assert walk_kernel.block_lanes(*dims) == c_lanes(lib, dims) == lanes
    assert walk_kernel.block_layout(*dims, lanes=lanes)["bytes"] <= walk_kernel.SMEM_PER_BLOCK
    if lanes < walk_kernel.LANES_PER_BLOCK:
        assert (walk_kernel.block_layout(*dims, lanes=lanes + 1)["bytes"]
                > walk_kernel.SMEM_PER_BLOCK)


def _slab(E, MP, D, S=0):
    arrs = walk_inputs.random_inputs(0, 1, E, MP, D, 1, 1)
    slab, _, _, _ = walk_inputs.as_tensors(arrs, "cpu", stage_hops=S)
    assert isinstance(slab, SlabState)
    return slab


def test_widest_lane_is_served_eight_a_block():
    slab = _slab(96, 32, 32, S=walk_inputs.NUM_STAGES)
    lanes, nbytes = walk_kernel.WalkPassKernel.arena(slab, 24 * 3)
    assert lanes == walk_kernel.LANES_PER_BLOCK
    assert nbytes == walk_kernel.block_layout(96, 32, 32, 72, walk_inputs.NUM_STAGES, True)["bytes"]
    assert nbytes <= walk_kernel.SMEM_PER_BLOCK
    assert walk_kernel.WalkPassKernel.arena(slab, 0, 16)[0] == walk_kernel.LANES_PER_BLOCK


@pytest.mark.parametrize("E, lanes", [(1536, 5), (3072, 2), (8192, 1)])
def test_slab_past_eight_lanes_is_served_in_smaller_blocks(lib, E, lanes):
    """Slabs whose eight lanes' arena is over a block's shared memory: the
    block serves as many lanes as fit, down to one."""
    slab = _slab(E, 8, 12)
    got, nbytes = walk_kernel.WalkPassKernel.arena(slab, 24 * 3)
    assert got == lanes == c_lanes(lib, (E, 8, 12, 72, 0, True))
    assert nbytes == walk_kernel.block_layout(E, 8, 12, 72, 0, True, lanes)["bytes"]
    assert nbytes <= walk_kernel.SMEM_PER_BLOCK


def test_escalated_headline_fits_eight_lanes_a_block():
    """At the escalated headline shape (E=96, MP=16, D=48) a lane's keys,
    tombstones, staged row and query version take KBs while its pver
    (96 x 16 x 48 int32, 295 KB) stays in device memory."""
    slab = _slab(96, 16, 48)
    lanes, nbytes = walk_kernel.WalkPassKernel.arena(slab, 72)
    assert lanes == walk_kernel.LANES_PER_BLOCK
    assert nbytes // lanes < 10 * 1024
    assert slab.pver[0].numel() * 4 == 96 * 16 * 48 * 4


def test_arena_too_large_for_a_block_raises(lib):
    slab = _slab(12000, 2, 2)
    assert c_lanes(lib, (12000, 2, 2, 0, 0, False)) == 0
    with pytest.raises(ValueError, match="a block holds"):
        walk_kernel.WalkPassKernel.arena(slab, 0)
    slab = _slab(96, 32, 32)
    with pytest.raises(ValueError, match="a block holds"):
        walk_kernel.WalkPassKernel.arena(slab, 8192)
