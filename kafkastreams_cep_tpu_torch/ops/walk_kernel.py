"""The step's slab phase — consuming puts, then every buffer walk — as one
hand-written CUDA kernel for Hopper, beside its plain PyTorch version.

Replaces ``kafkastreams_cep_tpu/ops/walk_kernel.py: walk_pass_kernel`` (the
Pallas kernel) in all of its single-query modes: the default (eager, single
tier), the two-tier slab (``hot_entries > 0``), stage attribution (a slab
whose ``stage_hops`` is ``[K, S > 0]``) and the lazy drain pass
(``drain=True``), alone or together.  Each mode is a compile-time template
instance of one kernel, ``csrc/walk_pass.cu``; its header says how it maps
lanes to warps and blocks, what bounds each mode on the H100 and the
contract it keeps.

A block of up to :data:`LANES_PER_BLOCK` lanes (:func:`block_lanes`: fewer
where that many do not fit) keeps its lanes' slab keys, tombstones, stage
tallies, put ops and scratch in a shared-memory arena
(``csrc/walk_layout.cuh``, mirrored by :func:`block_layout`); the pointer
rows stay in device memory.  :meth:`WalkPassKernel.arena` gives a call's
lanes a block and arena bytes, :meth:`WalkPassKernel.geometry` its lanes per
SM and registers on the card.

:func:`walk_pass` is the entry point the engine calls.  For tensors on the
CPU it runs :func:`walk_pass_plain` (``puts_batched`` then
``walks_compacted``, ``ops/slab.py``); for CUDA tensors it launches the
kernel or raises — it never falls back.  Both give the same result bit for
bit; ``chip_smoke.py`` holds them against each other on the card.

The kernel builds at first use with ``nvcc`` for ``sm_90a`` into
``kafkastreams_cep_tpu_torch/build/``, keyed by a hash of the source, of
every header it includes and of the flags, and is bound with ``ctypes`` (a
plain C entry point, no PyTorch headers).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from kafkastreams_cep_tpu_torch.ops import slab as slab_mod
from kafkastreams_cep_tpu_torch.ops.slab import PutOps, SlabState
from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("ops.walk_kernel")

I32 = torch.int32
SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "walk_pass.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: ``csrc/walk_layout.cuh``'s and ``csrc/scan_layout.cuh``'s constants: the
#: most lanes a block serves, a block's dynamic shared memory on the H100
#: (227 KB) and the closed-form put's scratch columns.
LANES_PER_BLOCK = 8
SMEM_PER_BLOCK = 232448
PUT_COLS = 8
SPAN_BYTES = 1024  # the copy tables (walk_layout.cuh: kWalkSpanBytes)


def includes(path: Path) -> List[Path]:
    """``path`` and every header it includes with ``#include "..."`` beside
    it, recursively, in first-seen order: what a build of ``path`` reads."""
    seen: List[Path] = []
    todo = [path]
    while todo:
        p = todo.pop(0)
        if p in seen or not p.exists():
            continue
        seen.append(p)
        todo += [p.parent / m for m in re.findall(r'^#include "([^"]+)"', p.read_text(), re.M)]
    return seen


def is_wide(MP: int, D: int) -> bool:
    """Whether a slab of ``MP`` pointers a row and Dewey depth ``D`` runs the
    wide instances (``walk_layout.cuh: walk_wide``): ``MP`` or ``D`` above
    32."""
    return MP > 32 or D > 32


def dead_words(MP: int) -> int:
    """Tombstone words a slab row (``walk_layout.cuh: walk_dead_words``):
    ``ceil(MP / 32)`` when ``MP > 32``, else one."""
    return -(-MP // 32) if MP > 32 else 1


def block_layout(E: int, MP: int, D: int, PP: int, S: int, puts: bool,
                 lanes: int = LANES_PER_BLOCK) -> Dict[str, int]:
    """One block's shared-memory arena (``walk_layout.cuh: walk_layout``):
    each array's byte offset, every one 16-byte aligned, and ``"bytes"``,
    the arena's size.  Each array holds the block's ``lanes`` lanes one after
    another: the slab keys and tombstones (:func:`dead_words` a row), a
    hop's staged versions (``row``), the walker's version (``q``, wide
    instances only), the stage tally; the put scratch only with ``puts``
    (the closed-form puts, single tier); the ``PP`` put ops (0 without puts)
    always, without their versions; ``spans`` is the block's copy tables."""
    LE, LPP = lanes * E, (lanes * PP if puts else 0)
    ints = [("st", LE), ("of", LE), ("rf", LE), ("np", LE), ("dead", LE * dead_words(MP))]
    ints += [("row", lanes * MP * D)] + ([("q", lanes * D)] if is_wide(MP, D) else [])
    ints += [("sh", lanes * S),
             ("p_sc", LPP * PUT_COLS), ("p_list", LPP), ("p_free", LE if puts else 0)]
    ints += [(f, lanes * PP) for f in ("p_cur", "p_pst", "p_pof", "p_pvl")]
    arrays = [(f, 4 * n) for f, n in ints]
    arrays += [("p_en", lanes * PP), ("p_first", lanes * PP), ("spans", SPAN_BYTES)]
    out, o = {"q": 0}, 0  # no q in a narrow arena
    for f, n in arrays + [("bytes", 0)]:
        out[f] = o = (o + 15) & ~15
        o += n
    return out


def block_lanes(E: int, MP: int, D: int, PP: int, S: int, puts: bool) -> int:
    """The lanes a block serves (``walk_layout.cuh: walk_lanes``): the most,
    up to ``LANES_PER_BLOCK``, whose arena fits a block's shared memory; 0
    when not even one lane's does."""
    for lanes in range(LANES_PER_BLOCK, 0, -1):
        if block_layout(E, MP, D, PP, S, puts, lanes)["bytes"] <= SMEM_PER_BLOCK:
            return lanes
    return 0


#: Slab leaves every mode reads and writes, in the kernel's pointer order.
_BASE_FIELDS = ("stage", "off", "refs", "npreds", "pstage", "poff", "pvlen",
                "pver", "missing", "trunc", "full_drops", "pred_drops",
                "walk_hops", "extract_hops")
#: Leaves only some modes write, in the kernel's pointer order: the tier
#: counters (two-tier), ``drain_hops`` (drain) and ``stage_hops``
#: (attribution).
_MODE_FIELDS = ("hot_hits", "hot_misses", "overflow_walks", "demotions",
                "drain_hops", "stage_hops")


def walk_pass_plain(
    slab: SlabState, en, stage, off, ver, vlen, is_remove, want_out,
    max_walk: int, out_base: int, out_rows: int,
    put_ops: Optional[PutOps] = None, ev_off=None, hot_entries: int = 0,
    drain: bool = False, budget: int = 1,
):
    """The plain PyTorch slab phase: the step's consuming puts (when
    ``put_ops`` is given; op by op under two-tier), then its walkers one at
    a time in queue order (``budget`` at a time in lockstep when ``budget >
    1``: ``EngineConfig.walker_budget``).  Returns ``(slab, out_stage [K,
    OR, W], out_off, count [K, OR])``."""
    if put_ops is not None:
        slab = slab_mod.puts_batched(slab, put_ops, ev_off, hot_entries)
    return slab_mod.walks_compacted(
        slab, en, stage, off, ver, vlen, is_remove, want_out,
        max_walk, out_base, out_rows, hot_entries=hot_entries, drain=drain,
        budget=budget,
    )


def check_hot_entries(hot_entries: int, num_entries: int) -> None:
    """The two-tier contract (``kafkastreams_cep_tpu/ops/walk_kernel.py:
    782-786``): 0, or a multiple of 8 strictly inside ``(0, E)``."""
    if hot_entries and (hot_entries % 8 or not 0 < hot_entries < num_entries):
        raise ValueError(
            f"hot_entries={hot_entries} must be a multiple of 8 strictly "
            f"below slab_entries={num_entries}"
        )


def mode_name(hot_entries: int, stage_slots: int, drain: bool, wide: bool = False) -> str:
    """The kernel instance a call runs: ``"default"`` or the ``+``-joined
    modes (``"two_tier"``, ``"attribution"``, ``"drain"``, ``"wide"``: MP or
    D above 32)."""
    modes = [m for m, on in (("two_tier", hot_entries), ("attribution", stage_slots),
                             ("drain", drain), ("wide", wide)) if on]
    return "+".join(modes) or "default"


def mode_fields(hot_entries: int, stage_slots: int, drain: bool) -> List[str]:
    """The slab leaves a kernel instance reads and writes: the base leaves,
    plus the tier counters (two-tier), ``drain_hops`` (drain) and
    ``stage_hops`` (attribution)."""
    fields = list(_BASE_FIELDS)
    if hot_entries:
        fields += ["hot_hits", "hot_misses", "overflow_walks", "demotions"]
    if drain:
        fields.append("drain_hops")
    if stage_slots:
        fields.append("stage_hops")
    return fields


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the walk-pass kernel builds "
        "from csrc/walk_pass.cu at first use on a CUDA machine"
    )


class WalkPassKernel:
    """The built kernel library plus its launch counts.

    ``launches`` goes up by one for each kernel launch and for nothing
    else, and ``launches_by_mode[mode_name(...)]`` with it, so a run can
    show that it went through the kernel and in which modes."""

    def __init__(self):
        self.launches = 0
        self.launches_by_mode: Dict[str, int] = {}
        self.build_log = ""
        self.build_seconds = 0.0
        self._lib = None

    def build(self) -> Path:
        """Compile the source (once per source hash) and load it."""
        if self._lib is not None:
            return self._path
        blob = b"".join(p.read_bytes() for p in includes(SOURCE))
        tag = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"libwalkpass-{tag}.so"
        if not out.exists():
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                tmp_out = Path(tmp) / out.name
                cmd = [_nvcc(), *NVCC_FLAGS, str(SOURCE), "-o", str(tmp_out)]
                res = subprocess.run(cmd, capture_output=True, text=True)
                self.build_log = res.stdout + res.stderr
                if res.returncode:
                    raise RuntimeError(
                        f"nvcc failed ({res.returncode}):\n{self.build_log}"
                    )
                os.replace(tmp_out, out)  # atomic publish
            self.build_seconds = time.perf_counter() - t0
            logger.info("built %s in %.1f s", out.name, self.build_seconds)
        lib = ctypes.CDLL(str(out))
        lib.cep_walk_pass.argtypes = [
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_void_p,
        ]
        lib.cep_walk_pass.restype = ctypes.c_int
        lib.cep_walk_occupancy.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        lib.cep_walk_occupancy.restype = ctypes.c_int
        if lib.cep_walk_lanes() != LANES_PER_BLOCK:
            raise RuntimeError(f"{out.name} serves up to {lib.cep_walk_lanes()} lanes "
                               f"a block, the wrapper {LANES_PER_BLOCK}")
        self._lib, self._path = lib, out
        return out

    @staticmethod
    def arena(slab: SlabState, PP: int, hot_entries: int = 0) -> Tuple[int, int]:
        """``(lanes, bytes)`` of a call on ``slab`` with ``PP`` put ops (0
        without puts): the lanes a block serves (:func:`block_lanes`) and
        the size of its shared-memory arena.  Raises ``ValueError`` when not
        even one lane's arena fits a block's shared memory."""
        _, E, MP, D = slab.pver.shape
        S = slab.stage_hops.shape[1]
        dims = (E, MP, D, PP, S, bool(PP) and not hot_entries)
        lanes = block_lanes(*dims)
        if not lanes:
            raise ValueError(
                f"walk-pass arena of one lane, {block_layout(*dims, 1)['bytes']} bytes, "
                f"is over the {SMEM_PER_BLOCK} a block holds (E={E}, MP={MP}, D={D}, "
                f"PP={PP})"
            )
        return lanes, block_layout(*dims, lanes)["bytes"]

    def geometry(self, slab: SlabState, PP: int, hot_entries: int = 0,
                 drain: bool = False) -> Dict:
        """How the built instance for these arguments runs on this card: the
        lanes a block serves, the block's arena bytes, the lanes resident
        per SM, and the registers and local memory of a thread."""
        lanes, nbytes = self.arena(slab, PP, hot_entries)
        self.build()
        mode = (int(bool(hot_entries)) | int(slab.stage_hops.shape[1] > 0) << 1
                | int(drain) << 2 | int(is_wide(*slab.pver.shape[2:])) << 3)
        occ = (ctypes.c_int * 3)()
        err = self._lib.cep_walk_occupancy(mode, lanes, nbytes, occ)
        if err:
            raise RuntimeError(f"occupancy query failed: error {err}")
        return dict(lanes_a_block=lanes, arena_bytes=nbytes, lanes_per_sm=occ[0],
                    registers=occ[1], local_bytes=occ[2])

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_mode = {}

    def __call__(
        self, slab: SlabState, en, stage, off, ver, vlen, is_remove,
        want_out, max_walk: int, out_base: int, out_rows: int,
        put_ops: Optional[PutOps] = None, ev_off=None, hot_entries: int = 0,
        drain: bool = False,
    ):
        """One launch."""
        K, E = slab.stage.shape
        MP = slab.pstage.shape[2]
        D = slab.pver.shape[3]
        S = slab.stage_hops.shape[1]
        PW = en.shape[1]
        W, OR, EH = int(max_walk), int(out_rows), int(hot_entries)
        dev = slab.stage.device
        if dev.type != "cuda":
            raise ValueError(f"walk-pass kernel needs CUDA tensors, got {dev}")
        if out_base < 0 or out_base + OR > PW:
            raise ValueError(
                f"output rows [{out_base}, {out_base + OR}) outside the "
                f"{PW}-walker queue"
            )
        check_hot_entries(EH, E)
        mode = mode_name(EH, S, drain, is_wide(MP, D))

        def arg(x, shape, name, dtype=I32):
            if x.device != dev:
                raise ValueError(f"{name} on {x.device}, slab on {dev}")
            if tuple(x.shape) != tuple(shape):
                raise ValueError(f"{name} shape {tuple(x.shape)} != {shape}")
            if x.dtype != dtype:
                raise ValueError(f"{name} dtype {x.dtype}, want {dtype}")
            return x.contiguous()

        def flag(x, shape, name):
            # The kernel reads a bool as its one byte: a view, not a copy.
            return arg(x, shape, name, torch.bool).view(torch.uint8)

        shapes = dict(stage=(K, E), off=(K, E), refs=(K, E), npreds=(K, E),
                      pstage=(K, E, MP), poff=(K, E, MP), pvlen=(K, E, MP),
                      pver=(K, E, MP, D), stage_hops=(K, S))
        slab_in = {f: arg(getattr(slab, f), shapes.get(f, (K,)), f)
                   for f in _BASE_FIELDS + _MODE_FIELDS}
        if put_ops is not None:
            PP = put_ops.en.shape[1]
            puts_in = [
                flag(put_ops.en, (K, PP), "put en"),
                flag(put_ops.first, (K, PP), "put first"),
                arg(put_ops.cur_stage, (K, PP), "put cur_stage"),
                arg(put_ops.prev_stage, (K, PP), "put prev_stage"),
                arg(put_ops.prev_off, (K, PP), "put prev_off"),
                arg(put_ops.vlen, (K, PP), "put vlen"),
                arg(put_ops.ver, (K, PP, D), "put ver"),
                arg(ev_off, (K,), "ev_off"),
            ]
        else:
            PP = 0
            puts_in = [torch.zeros((1,), dtype=I32, device=dev)] * 8
        walk_in = [
            flag(en, (K, PW), "en"), arg(stage, (K, PW), "stage"),
            arg(off, (K, PW), "off"), arg(vlen, (K, PW), "vlen"),
            arg(ver, (K, PW, D), "ver"), flag(is_remove, (K, PW), "is_remove"),
            flag(want_out, (K, PW), "want_out"),
        ]
        # The mode's outputs; a leaf the mode does not write gets its input,
        # which the kernel instance never touches.
        written = mode_fields(EH, S, drain)
        outs = {f: (torch.empty_like(slab_in[f]) if f in written else slab_in[f])
                for f in _BASE_FIELDS + _MODE_FIELDS}
        out_stage = torch.empty((K, OR, W), dtype=I32, device=dev)
        out_off = torch.empty_like(out_stage)
        count = torch.empty((K, OR), dtype=I32, device=dev)
        lanes, nbytes = self.arena(slab, PP, EH)

        self.build()
        tensors = (
            [slab_in[f] for f in _BASE_FIELDS] + puts_in + walk_in
            + [outs[f] for f in _BASE_FIELDS] + [out_stage, out_off, count]
            + [slab_in[f] for f in _MODE_FIELDS] + [outs[f] for f in _MODE_FIELDS]
        )
        dims = (ctypes.c_int * 15)(
            K, E, MP, D, PP, PW, W, int(out_base), OR, int(put_ops is not None),
            EH, S, int(bool(drain)), lanes, nbytes,
        )
        ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
        if K:
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._lib.cep_walk_pass(dims, ptrs, ctypes.c_void_p(stream))
            if err:
                raise RuntimeError(f"walk-pass kernel launch failed: CUDA error {err}")
            self.launches += 1
            self.launches_by_mode[mode] = self.launches_by_mode.get(mode, 0) + 1
        new_slab = slab._replace(**{f: outs[f] for f in written})
        return new_slab, out_stage, out_off, count


#: The process's kernel library (built at first launch).
walk_pass_kernel = WalkPassKernel()


def walk_pass(
    slab: SlabState, en, stage, off, ver, vlen, is_remove, want_out,
    max_walk: int, out_base: int, out_rows: int,
    put_ops: Optional[PutOps] = None, ev_off=None, hot_entries: int = 0,
    drain: bool = False, budget: int = 1,
):
    """The step's (or the drain's) slab phase for ``[K]``-batched lanes: the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors.

    ``budget`` is ``EngineConfig.walker_budget``.  The kernel serves every
    walker alone in queue order whatever it is, as the JAX package's Pallas
    kernel does (``kafkastreams_cep_tpu/engine/matcher.py:146``); the plain
    version on the CPU runs the lockstep batches of ``budget`` walkers, as
    the JAX package's jnp pass does."""
    if slab.stage.is_cuda:
        return walk_pass_kernel(
            slab, en, stage, off, ver, vlen, is_remove, want_out,
            max_walk, out_base, out_rows, put_ops=put_ops, ev_off=ev_off,
            hot_entries=hot_entries, drain=drain,
        )
    return walk_pass_plain(
        slab, en, stage, off, ver, vlen, is_remove, want_out,
        max_walk, out_base, out_rows, put_ops=put_ops, ev_off=ev_off,
        hot_entries=hot_entries, drain=drain, budget=budget,
    )
