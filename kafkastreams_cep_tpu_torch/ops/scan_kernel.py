"""The whole ``[K, T]`` event loop as one hand-written CUDA kernel for
Hopper, beside its plain PyTorch version.

Replaces ``kafkastreams_cep_tpu/ops/scan_kernel.py: build_scan`` (the
Pallas kernel that runs a whole scan with state resident in VMEM) for one
query in every mode it takes: eager or lazy extraction, single or two-tier
slab, with or without stage attribution, each with and without
``enforce_windows``; and its tiered form ``build_scan(..., promotion=p)``,
which after each step promotes the stencil prefix's completions into the
NFA tier (``promo=``).  The kernel, ``csrc/scan_pass.cu``, is ``template
<bool kLazy, bool kTwoTier, bool kAttr, bool kPromo, bool kPvShared>``; its
header says how it maps lanes to warps and steps to a loop, what bounds it
on the H100, and the contract it keeps.  It shares the slab phase with the
walk-pass kernel (``csrc/walk_pass.cuh``).  Each lane runs in its block's
shared memory (``csrc/scan_layout.cuh``, mirrored here by
:func:`lane_layout`); the slab's pointer rows join it where
:func:`pv_in_shared` says so, else they stay in device memory.

A pattern's predicates and folds reach the kernel as C++ that
``ops/scan_codegen.py`` generates into a header, ``cep_pattern.h``; a
library holds one instance for one generated header, built at first use
with ``nvcc`` for ``sm_90a`` into ``kafkastreams_cep_tpu_torch/build/``,
keyed by a hash of the sources, the header and the flags (the instance's
among them), and bound with ``ctypes`` (a plain C entry point, no PyTorch
headers).

:func:`scan_pass` is the entry point ``BatchMatcher.scan`` and
``TieredBatchMatcher.scan`` call.  For tensors on the CPU it runs
:func:`scan_pass_plain` (T plain engine steps, each followed under
``promo`` by the plain promotion); for CUDA tensors it launches the kernel
or raises — it never falls back.  Both give the same result bit for bit;
``chip_smoke.py`` holds them against each other on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from kafkastreams_cep_tpu_torch.engine.matcher import (
    EngineConfig,
    EngineState,
    EventBatch,
    StepOutput,
    StepPhases,
    make_step,
    scan_steps,
    step_events,
    tree_where,
)
from kafkastreams_cep_tpu_torch.ops.scan_codegen import ScanSource, value_leaves
from kafkastreams_cep_tpu_torch.ops.walk_kernel import (
    BUILD_DIR,
    _nvcc,
    dead_words,
    is_wide,
    walk_pass_plain,
)
from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("ops.scan_kernel")

I32 = torch.int32
CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("scan_pass.cu", "scan_layout.cuh", "walk_pass.cuh", "scan_expr.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # The plain version rounds every float operation: no a*b+c contraction.
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Run-state and slab leaves the kernel writes in every mode.
_RUN_FIELDS = ("alive", "branching", "id_pos", "eval_pos", "ver", "vlen",
               "event_off", "start_ts", "agg")
_SLAB_FIELDS = ("stage", "off", "refs", "npreds", "pstage", "poff", "pvlen",
                "pver", "missing", "trunc", "full_drops", "pred_drops",
                "walk_hops", "extract_hops")
_COUNT_FIELDS = ("run_drops", "ver_overflows", "step_seq")
#: The handle ring, written under lazy extraction only.
_RING_FIELDS = ("hr_stage", "hr_off", "hr_ver", "hr_vlen", "hr_ts", "hr_seq",
                "hr_row", "hr_count", "handle_overflows")
#: The two-tier counters and the stage tallies (``stage_counts`` is the
#: engine's, the rest the slab's).
_HOT_FIELDS = ("hot_hits", "hot_misses", "overflow_walks", "demotions")
_ATTR_FIELDS = ("stage_counts", "stage_hops")
#: Every leaf the kernel takes, in its pointer order (in, then out).
_FIELDS = (_RUN_FIELDS + _SLAB_FIELDS + _COUNT_FIELDS + _RING_FIELDS
           + _HOT_FIELDS + _ATTR_FIELDS)
_ENGINE_ONLY = set(_RUN_FIELDS + _COUNT_FIELDS + _RING_FIELDS) | {"stage_counts"}


#: ``csrc/scan_layout.cuh``'s constants: a block's dynamic shared memory on
#: the H100 (227 KB), the largest lane that takes the pointer rows into
#: shared memory (untiered, tiered), and the closed-form put's scratch
#: columns.
SMEM_PER_BLOCK = 232448
PV_SHARED_MAX_BYTES = 13 * 1024
PV_SHARED_MAX_BYTES_TIERED = 48 * 1024
PUT_COLS = 8
_RUN_ARRAYS = ("alive", "branching", "id", "eval", "vlen", "event", "start")


def lane_layout(R: int, E: int, MP: int, D: int, H: int, NS: int, S: int,
                attribution: bool, pv_shared: bool) -> Dict[str, int]:
    """One lane's shared-memory arena (``scan_layout.cuh: scan_layout``):
    each array's byte offset, every one 16-byte aligned, and ``"bytes"``,
    the arena's size.  The pointer rows (``ps``, ``po``, ``pl``, ``pv``)
    are in it only with ``pv_shared``; the stage tallies only under
    ``attribution``.  The wide instance (``MP`` or ``D`` above 32) takes
    :func:`dead_words` tombstone words a row, keeps its arrays of D digits
    (the run buffers' ``run<b>.ver`` and the put ops' ``p_ver``) in device
    scratch (:func:`scratch_words`), and adds each op's bumped digit
    (``p_bump``) and each next-queue row's source (``c_src``, ``c_bump``)."""
    RH, PW, EMP = R * H, R * H + 2 * R, E * MP
    wide = is_wide(MP, D)
    ints = [("st", E), ("of", E), ("rf", E), ("np", E), ("dead", E * dead_words(MP))]
    if pv_shared:
        ints += [("ps", EMP), ("po", EMP), ("pl", EMP), ("pv", EMP * D)]
    for b in (0, 1):
        ints += [(f"run{b}.{f}", R) for f in _RUN_ARRAYS]
        ints += [(f"run{b}.ver", 0 if wide else R * D), (f"run{b}.agg", R * NS)]
    ints += [(f, RH) for f in ("p_cur", "p_pst", "p_pof", "p_pvl")]
    ints += [("p_ver", 0 if wide else RH * D), ("p_sc", RH * PUT_COLS), ("p_list", RH),
             ("p_free", E)]
    ints += [(f, PW) for f in ("w_stage", "w_off", "w_vlen", "w_run", "w_list")]
    ints += [(f, R) for f in ("r_id", "r_eval", "r_vlen", "r_event", "r_start", "r_bits")]
    ints += [("r_agg", R * NS)]
    ints += [(f, RH) for f in ("b_id", "b_eval", "b_vlen", "b_event", "b_start")]
    ints += [("b_agg", RH * NS), ("stc", 4 * S if attribution else 0),
             ("sh", S if attribution else 0)]
    ints += [("p_bump", RH), ("c_src", R), ("c_bump", R)] if wide else []
    arrays = [(f, 4 * n) for f, n in ints]
    arrays += [("p_en", RH), ("p_first", RH), ("w_en", PW), ("b_en", RH)]
    out, o = {"p_bump": 0, "c_src": 0, "c_bump": 0}, 0  # none in a narrow arena
    for f, n in arrays + [("bytes", 0)]:
        out[f] = o = (o + 15) & ~15
        o += n
    return out


def scratch_words(R: int, D: int, H: int, wide: bool) -> int:
    """A lane's device scratch in int32 (``scan_layout.cuh:
    scan_scratch_words``): in the wide instance the run buffers' version
    digits ``[2, R, D]``, then the put ops' versions ``[R*H, D]``; none in
    a narrow one."""
    return (2 * R + R * H) * D if wide else 0


def pv_in_shared(R: int, E: int, MP: int, D: int, H: int, NS: int, S: int,
                 attribution: bool, tiered: bool) -> bool:
    """The placement rule (``scan_layout.cuh: scan_pv_shared``): the
    pointer rows go to shared memory when the lane then needs at most
    ``PV_SHARED_MAX_BYTES`` (``PV_SHARED_MAX_BYTES_TIERED`` in a tiered
    instance)."""
    limit = PV_SHARED_MAX_BYTES_TIERED if tiered else PV_SHARED_MAX_BYTES
    return lane_layout(R, E, MP, D, H, NS, S, attribution, True)["bytes"] <= limit


class Mode(NamedTuple):
    """One kernel instance (its template parameters); ``wide``: a slab
    with ``slab_preds`` or ``dewey_depth`` above 32."""

    lazy: bool
    two_tier: bool
    attribution: bool
    tiered: bool
    wide: bool = False

    @property
    def name(self) -> str:
        """``"default"``, or the instance's modes joined by ``+``
        (``"lazy"``, ``"two_tier+attribution"``, ``"lazy+tiered"``, ...)."""
        parts = [f for f in self._fields if getattr(self, f)]
        return "+".join(parts) or "default"

    @property
    def defines(self) -> Tuple[str, ...]:
        return (f"-DCEP_LAZY={int(self.lazy)}", f"-DCEP_TWO_TIER={int(self.two_tier)}",
                f"-DCEP_ATTR={int(self.attribution)}", f"-DCEP_PROMO={int(self.tiered)}",
                f"-DCEP_WIDE={int(self.wide)}")


def mode_of(config: EngineConfig, tiered: bool = False) -> Mode:
    """The kernel instance a config runs (``tiered``: with promotions)."""
    return Mode(bool(config.lazy_extraction), bool(config.slab_hot_entries),
                bool(config.stage_attribution), bool(tiered),
                is_wide(int(config.slab_preds), int(config.dewey_depth)))


def mode_name(config: EngineConfig, tiered: bool = False) -> str:
    return mode_of(config, tiered).name


def mode_fields(config: EngineConfig) -> Tuple[str, ...]:
    """The state leaves a kernel instance writes: the run state, the slab
    and the counters; the handle ring under lazy extraction; the hot-tier
    counters under the two-tier slab; ``stage_counts`` and ``stage_hops``
    under stage attribution."""
    m = mode_of(config)
    return (_RUN_FIELDS + _SLAB_FIELDS + _COUNT_FIELDS
            + (_RING_FIELDS if m.lazy else ())
            + (_HOT_FIELDS if m.two_tier else ())
            + (_ATTR_FIELDS if m.attribution else ()))


def scan_pass_plain(phases: StepPhases, state: EngineState, events: EventBatch,
                    promo=None):
    """The plain PyTorch version: ``T`` engine steps (``make_step`` over the
    plain walk pass).  Returns ``(state, StepOutput [K, T, ...])``.

    With ``promo = (promote, feed)`` (``engine/tiered.py: Promote`` and the
    stencil tier's ``PromoOutput [K, T, ...]``) each step is followed by
    ``promote`` at that slot, and each lane is gated per step: a lane with
    no live run and no completion at ``t`` is left as it is but for
    ``step_seq``; returns ``(state, StepOutput, promoted [K])``."""
    step = make_step(phases, walk_pass_plain)
    if promo is None:
        return scan_steps(step, state, events)
    promote, feed = promo
    K = state.alive.shape[0]
    promoted = torch.zeros((K,), dtype=I32, device=state.alive.device)
    outs = []
    for t in range(events.ts.shape[1]):
        fire = feed.fire[:, t].to(torch.bool)
        needed = state.alive.any(dim=1) | fire
        new, out = step(state, step_events(events, t))
        state = tree_where(needed, new, state)._replace(step_seq=new.step_seq)
        outs.append(StepOutput(
            torch.where(needed[:, None, None], out.stage, -1),
            torch.where(needed[:, None, None], out.off, -1),
            torch.where(needed[:, None], out.count, 0),
        ))
        state, n = promote(state, fire, feed.offs[:, t], feed.anchor_ts[:, t],
                           feed.sver[:, t])
        promoted = promoted + n
    return state, StepOutput(*(torch.stack(x, dim=1) for x in zip(*outs))), promoted


class ScanPassKernel:
    """The built kernel libraries (one per generated header and instance)
    plus launch counts.

    ``launches`` goes up by one for each kernel launch and for nothing
    else, and ``launches_by_mode[mode.name]`` with it."""

    def __init__(self):
        self.launches = 0
        self.launches_by_mode: Dict[str, int] = {}
        self.build_logs: Dict[str, str] = {}
        self.build_seconds: Dict[str, float] = {}
        self._libs: Dict[Tuple[str, Mode], ctypes.CDLL] = {}

    def library(self, source: ScanSource, mode: Mode) -> Path:
        """Where ``source``'s library of instance ``mode`` lands (keyed by a
        hash of the kernel's sources, the generated header and the flags)."""
        blob = b"".join((CSRC / f).read_bytes() for f in SOURCES)
        blob += source.header.encode() + " ".join(NVCC_FLAGS + mode.defines).encode()
        tag = hashlib.sha256(blob).hexdigest()[:16]
        return BUILD_DIR / f"libscanpass-{tag}.so"

    def build(self, *items: Tuple[ScanSource, Mode]) -> List[Path]:
        """Compile every ``(source, mode)`` not built yet (one ``nvcc``
        each, all started together) and load them."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        outs = [self.library(src, mode) for src, mode in items]
        jobs = []
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            for (src, mode), out in zip(items, outs):
                if out.exists() or any(out == j[0] for j in jobs):
                    continue
                inc = Path(tmp) / out.stem
                inc.mkdir()
                (inc / "cep_pattern.h").write_text(src.header)
                tmp_out = inc / out.name
                cmd = [_nvcc(), *NVCC_FLAGS, *mode.defines, f"-I{CSRC}", f"-I{inc}",
                       str(CSRC / "scan_pass.cu"), "-o", str(tmp_out)]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
                jobs.append((out, tmp_out, proc, time.perf_counter()))
            failed = []
            for out, tmp_out, proc, t0 in jobs:
                log, _ = proc.communicate()
                self.build_logs[out.name] = log
                self.build_seconds[out.name] = time.perf_counter() - t0
                if proc.returncode:
                    failed.append(f"{out.name}: nvcc failed ({proc.returncode}):\n{log}")
                    continue
                os.replace(tmp_out, out)  # atomic publish
                logger.info("built %s in %.1f s", out.name, self.build_seconds[out.name])
            if failed:
                raise RuntimeError("\n".join(failed))
        for (src, mode), out in zip(items, outs):
            if (src.tag, mode) not in self._libs:
                lib = ctypes.CDLL(str(out))
                lib.cep_scan_pass.argtypes = [
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_void_p),
                    ctypes.c_void_p,
                ]
                lib.cep_scan_pass.restype = ctypes.c_int
                lib.cep_scan_occupancy.argtypes = [
                    ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ]
                lib.cep_scan_occupancy.restype = ctypes.c_int
                lib.cep_scan_mode.restype = ctypes.c_int
                bits = sum(int(v) << i for i, v in enumerate(mode))
                if lib.cep_scan_mode() != bits:
                    raise RuntimeError(f"{out.name} holds instance {lib.cep_scan_mode()}, "
                                       f"not {mode.name}")
                self._libs[(src.tag, mode)] = lib
        return outs

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_mode = {}

    @staticmethod
    def arena(source: ScanSource, config: EngineConfig, state: EngineState,
              pv_shared: Optional[bool] = None, tiered: bool = False) -> Tuple[bool, int]:
        """``(pv_shared, bytes)``: where a lane's pointer rows go (the rule
        of :func:`pv_in_shared` for the instance, ``tiered`` or not, unless
        ``pv_shared`` is given) and the size of its shared-memory arena.
        Raises ``ValueError`` when the arena exceeds a block's shared
        memory."""
        R = state.alive.shape[1]
        E, MP = state.slab.pstage.shape[1:]
        dims = (R, E, MP, state.ver.shape[2], source.hops, state.agg.shape[2],
                state.slab.stage_hops.shape[1], bool(config.stage_attribution))
        if pv_shared is None:
            pv_shared = pv_in_shared(*dims, tiered)
        nbytes = lane_layout(*dims, pv_shared)["bytes"]
        if nbytes > SMEM_PER_BLOCK:
            raise ValueError(
                f"a lane needs {nbytes} bytes of shared memory with the pointer rows "
                f"{'shared' if pv_shared else 'in device memory'}, over the "
                f"{SMEM_PER_BLOCK} a block holds (R={R}, E={E}, MP={MP})"
            )
        return bool(pv_shared), nbytes

    def geometry(self, source: ScanSource, config: EngineConfig, state: EngineState,
                 tiered: bool = False, pv_shared: Optional[bool] = None) -> Dict:
        """How the built instance for ``config`` (``tiered``: with
        promotions) runs ``state``'s lanes on this card: the pointer rows'
        placement, the arena's bytes, the lanes resident per SM, and the
        registers and local memory of a thread."""
        pv, nbytes = self.arena(source, config, state, pv_shared, tiered)
        occ = (ctypes.c_int * 3)()
        lib = self._libs[(source.tag, mode_of(config, tiered))]
        err = lib.cep_scan_occupancy(int(pv), nbytes, occ)
        if err:
            raise RuntimeError(f"occupancy query failed: error {err}")
        return dict(pv_shared=pv, lane_bytes=nbytes, lanes_per_sm=occ[0],
                    registers=occ[1], local_bytes=occ[2])

    def __call__(self, source: ScanSource, config: EngineConfig,
                 state: EngineState, events: EventBatch, promo=None,
                 pv_shared: Optional[bool] = None):
        """One launch over ``events``; ``pv_shared`` overrides the
        placement rule (for tests and measurements)."""
        K, R = state.alive.shape
        E, MP = state.slab.pstage.shape[1:]
        D = state.ver.shape[2]
        NS = state.agg.shape[2]
        HB = state.hr_stage.shape[1]
        S = state.slab.stage_hops.shape[1]
        T = events.ts.shape[1]
        W = int(config.max_walk)
        dev = state.alive.device
        if dev.type != "cuda":
            raise ValueError(f"whole-scan kernel needs CUDA tensors, got {dev}")
        mode = mode_of(config, promo is not None)
        if mode.wide != is_wide(MP, D):
            raise ValueError(f"config's slab width is not the state's (MP={MP}, D={D})")
        EH = int(config.slab_hot_entries)
        pv_shared, lane_bytes = self.arena(source, config, state, pv_shared,
                                           promo is not None)
        nwords = scratch_words(R, D, source.hops, mode.wide)
        scratch = torch.empty((K, nwords), dtype=I32, device=dev) if nwords else None

        def arg(x, shape, name, dtype=I32):
            if x.device != dev:
                raise ValueError(f"{name} on {x.device}, state on {dev}")
            if tuple(x.shape) != tuple(shape):
                raise ValueError(f"{name} shape {tuple(x.shape)} != {shape}")
            if x.dtype != dtype:
                raise ValueError(f"{name} dtype {x.dtype}, want {dtype}")
            return x.contiguous()

        def flag(x, shape, name):
            # The kernel reads a bool as its one byte: a view, not a copy.
            return arg(x, shape, name, torch.bool).view(torch.uint8)

        leaves = value_leaves(events.value)
        if len(leaves) != len(source.kinds):
            raise ValueError(
                f"{len(leaves)} event leaves, the generated source reads "
                f"{len(source.kinds)}"
            )
        kind_dtype = {"i": I32, "f": torch.float32, "b": torch.bool}
        ev_leaves = []
        for i, (x, kind) in enumerate(zip(leaves, source.kinds)):
            ev_leaves.append(
                flag(x, (K, T), f"leaf {i}") if kind == "b"
                else arg(x, (K, T), f"leaf {i}", kind_dtype[kind])
            )
        ev = [arg(events.key, (K, T), "key"), arg(events.ts, (K, T), "ts"),
              arg(events.off, (K, T), "off"), flag(events.valid, (K, T), "valid")]

        shapes = dict(
            alive=(K, R), branching=(K, R), id_pos=(K, R), eval_pos=(K, R),
            ver=(K, R, D), vlen=(K, R), event_off=(K, R), start_ts=(K, R),
            agg=(K, R, NS), stage=(K, E), off=(K, E), refs=(K, E),
            npreds=(K, E), pstage=(K, E, MP), poff=(K, E, MP),
            pvlen=(K, E, MP), pver=(K, E, MP, D), hr_stage=(K, HB),
            hr_off=(K, HB), hr_ver=(K, HB, D), hr_vlen=(K, HB), hr_ts=(K, HB),
            hr_seq=(K, HB), hr_row=(K, HB), stage_counts=(K, 4, S),
            stage_hops=(K, S),
        )

        def state_in(f):
            leaf = getattr(state, f) if f in _ENGINE_ONLY else getattr(state.slab, f)
            if f in ("alive", "branching"):
                return flag(leaf, shapes[f], f)
            return arg(leaf, shapes.get(f, (K,)), f)

        # The kernel's pointer order; a leaf the mode does not write gets its
        # input as its output, which the kernel never touches.
        ins = {f: state_in(f) for f in _FIELDS}
        written = mode_fields(config)
        outs = {f: (torch.empty_like(ins[f]) if f in written else ins[f]) for f in _FIELDS}
        out_stage = torch.empty((K, T, R, W), dtype=I32, device=dev)
        out_off = torch.empty_like(out_stage)
        count = torch.empty((K, T, R), dtype=I32, device=dev)
        promoted = torch.zeros((K,), dtype=I32, device=dev)
        if promo is not None:
            promote, feed = promo
            P = promote.prefix_len
            if not 0 < P <= D:
                raise ValueError(f"prefix length {P} outside 1..D={D}")
            if tuple(promote.idents) != source.idents[:P] or P >= len(source.idents):
                raise ValueError(f"promotion prefix {promote.idents} is not the first {P} "
                                 f"stage identities of the generated source")
            pr = [flag(feed.fire, (K, T), "fire"), arg(feed.offs, (K, T, P), "offs"),
                  arg(feed.anchor_ts, (K, T), "anchor_ts"), arg(feed.sver, (K, T), "sver"),
                  promoted]
            promo_dims = [P, promote.eval_pos, *promote.idents[:32]]
        else:
            pr = [None] * 5
            promo_dims = [0, 0]

        def result(new_state):
            out = StepOutput(out_stage, out_off, count)
            return (new_state, out) if promo is None else (new_state, out, promoted)

        if not (K and T):  # nothing to scan: the state stays as it is
            return result(state)
        if (source.tag, mode) not in self._libs:
            self.build((source, mode))
        lib = self._libs[(source.tag, mode)]
        tensors = (
            ev + [ins[f] for f in _FIELDS] + [outs[f] for f in _FIELDS]
            + [out_stage, out_off, count] + pr + [scratch] + ev_leaves
        )
        dims = [K, T, R, E, MP, D, W, HB, int(bool(config.enforce_windows)), EH, S,
                *promo_dims[:2], int(pv_shared), lane_bytes, *promo_dims[2:]]
        dims = (ctypes.c_int * len(dims))(*dims)
        ptrs = (ctypes.c_void_p * len(tensors))(
            *[None if x is None else x.data_ptr() for x in tensors]
        )
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cep_scan_pass(dims, ptrs, ctypes.c_void_p(stream))
        if err:
            raise RuntimeError(f"whole-scan kernel launch failed: error {err}")
        self.launches += 1
        self.launches_by_mode[mode.name] = self.launches_by_mode.get(mode.name, 0) + 1

        def state_out(f):
            leaf = outs[f]
            return leaf.view(torch.bool) if f in ("alive", "branching") else leaf

        slab = state.slab._replace(
            **{f: state_out(f) for f in _FIELDS if f not in _ENGINE_ONLY}
        )
        return result(state._replace(
            slab=slab, **{f: state_out(f) for f in _FIELDS if f in _ENGINE_ONLY},
        ))


#: The process's kernel libraries (built at first launch).
scan_pass_kernel = ScanPassKernel()


def scan_pass(source: ScanSource, config: EngineConfig, phases: StepPhases,
              state: EngineState, events: EventBatch, promo=None):
    """A ``[K, T]`` scan: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors.  Returns ``(state, StepOutput [K, T, ...])``, and
    ``promoted [K]`` third with ``promo = (promote, feed)``."""
    if state.alive.is_cuda:
        return scan_pass_kernel(source, config, state, events, promo)
    return scan_pass_plain(phases, state, events, promo)
