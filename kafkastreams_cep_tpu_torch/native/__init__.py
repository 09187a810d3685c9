"""Native host-runtime bindings: C++ batch packing + JSON-lines parsing.

The compute path is PyTorch and CUDA (``engine/``, ``ops/``); the host
runtime around it — grouping micro-batches into lanes, scattering columns
into ``[K, T]`` grids that are then copied to the card, and parsing the
JSON ingest boundary — is native C++ (``src/ingest.cpp``), the part the
reference delegates to the JVM and its serdes (``CEPProcessor.java:
154-163``, ``demo/StockEventSerDe.java:50-89``).  Its C ABI is the JAX
package's (``kafkastreams_cep_tpu/native/src/ingest.cpp``); this package
keeps its own copy of the source.

The shared library is built with ``g++`` at first use into
``kafkastreams_cep_tpu_torch/build/``, keyed by the source's hash, and
loaded with ``ctypes``.  Every entry point has a plain NumPy version with
the same semantics (``*_plain``): the public functions run the C++ library
when it loaded and the plain version otherwise.  ``available()`` says
which is active; ``CEP_NO_NATIVE=1`` forces the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import math
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("native")

_SRC = Path(__file__).parent / "src" / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
_ABI_VERSION = 1

_lib: Optional[ctypes.CDLL] = None
_tried = False


def build_library(src: Path, stem: str) -> Path:
    """Compile the C++ source ``src`` into ``build/<stem>-<hash>.so``
    (reused when present) and return its path; raises when ``g++`` fails."""
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"{stem}-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build beside the target so the publishing rename stays on one
    # filesystem; concurrent builds race benignly.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(src),
             "-o", str(tmp_out)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp_out, out)
    logger.info("built native library: %s", out)
    return out


def build() -> Path:
    """Compile ``src/ingest.cpp`` into ``build/libcepingest-<hash>.so``
    (reused when present) and return its path; raises when ``g++`` fails."""
    return build_library(_SRC, "libcepingest")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("CEP_NO_NATIVE"):
        logger.info("CEP_NO_NATIVE set; using the NumPy plain versions")
        return None
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        logger.warning(
            "native ingest library unavailable (%s: %s); using the NumPy "
            "plain versions %s", type(e).__name__, e,
            detail.decode(errors="replace") if isinstance(detail, bytes) else detail,
        )
        return None

    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32, i64 = ctypes.c_int32, ctypes.c_int64

    lib.cep_native_abi_version.restype = i32
    if lib.cep_native_abi_version() != _ABI_VERSION:
        logger.warning("native ABI mismatch; using the NumPy plain versions")
        return None
    lib.cep_queue_positions.restype = i32
    lib.cep_queue_positions.argtypes = [i32p, u8p, i64, i32, i32p, i32p]
    for name, vp in (("cep_pack_i32", i32p), ("cep_pack_f32", f32p),
                     ("cep_pack_i64", i64p)):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [vp, vp, i32p, i32p, u8p, i64, i64]
    lib.cep_pack_valid.restype = None
    lib.cep_pack_valid.argtypes = [u8p, i32p, i32p, u8p, i64, i64]
    lib.cep_parse_json_lines.restype = i64
    lib.cep_parse_json_lines.argtypes = [
        ctypes.c_char_p, i64, ctypes.c_char_p, i32, ctypes.c_char_p,
        f64p, ctypes.c_char_p, i64, u8p, i64, i64p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the C++ library is loaded (False = the plain versions)."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# -- lane-queue positions ------------------------------------------------------


def queue_positions(
    lanes: np.ndarray, keep: np.ndarray, num_lanes: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Each kept record's position in its lane queue (arrival order), the
    queue lengths ``[num_lanes]``, and the longest queue; records with
    ``keep[i] == 0`` get position -1."""
    lib = _load()
    if lib is None:
        return queue_positions_plain(lanes, keep, num_lanes)
    lanes = np.ascontiguousarray(lanes, dtype=np.int32)
    keep = np.ascontiguousarray(keep, dtype=np.uint8)
    n = lanes.shape[0]
    pos = np.empty(n, dtype=np.int32)
    qlen = np.zeros(num_lanes, dtype=np.int32)
    max_len = lib.cep_queue_positions(
        _ptr(lanes, ctypes.c_int32), _ptr(keep, ctypes.c_uint8), n, num_lanes,
        _ptr(pos, ctypes.c_int32), _ptr(qlen, ctypes.c_int32),
    )
    return pos, qlen, int(max_len)


def queue_positions_plain(lanes, keep, num_lanes: int):
    """The NumPy version of :func:`queue_positions`."""
    lanes = np.asarray(lanes, dtype=np.int32)
    pos = np.full(lanes.shape[0], -1, dtype=np.int32)
    idx = np.flatnonzero(np.asarray(keep, dtype=bool))
    if idx.size:
        kl = lanes[idx]
        order = np.argsort(kl, kind="stable")
        sor = kl[order]
        starts = np.r_[0, np.flatnonzero(np.diff(sor)) + 1]
        ranks = np.arange(sor.size) - np.repeat(starts, np.diff(np.r_[starts, sor.size]))
        pos[idx[order]] = ranks
    qlen = np.bincount(lanes[idx], minlength=num_lanes).astype(np.int32)
    return pos, qlen, int(qlen.max(initial=0))


# -- columnar scatter ----------------------------------------------------------


def _row_columns(lanes, pos, keep):
    """``lanes``, ``pos`` and ``keep`` as contiguous int32, int32 and uint8
    columns of one length (the C++ scatter reads that many of each; the
    positions themselves come from :func:`queue_positions`)."""
    lanes = np.ascontiguousarray(lanes, dtype=np.int32)
    pos = np.ascontiguousarray(pos, dtype=np.int32)
    keep = np.ascontiguousarray(keep, dtype=np.uint8)
    if lanes.ndim != 1 or pos.shape != lanes.shape or keep.shape != lanes.shape:
        raise ValueError(
            f"lanes {lanes.shape}, pos {pos.shape} and keep {keep.shape} must be "
            "1-D columns of one length")
    return lanes, pos, keep


_PACK = {np.dtype(np.int32): ("cep_pack_i32", ctypes.c_int32),
         np.dtype(np.float32): ("cep_pack_f32", ctypes.c_float),
         np.dtype(np.int64): ("cep_pack_i64", ctypes.c_int64)}


def pack_column(dst: np.ndarray, src, lanes, pos, keep) -> None:
    """``dst[lanes[i], pos[i]] = src[i]`` for every kept record.  ``dst`` is
    a C-contiguous ``[K, T]`` grid of int32, float32 or int64 (the
    runtime's column types; any other dtype takes the plain version)."""
    lib = _load()
    entry = _PACK.get(dst.dtype)
    if lib is None or entry is None or not dst.flags.c_contiguous:
        return pack_column_plain(dst, src, lanes, pos, keep)
    name, ctype = entry
    lanes, pos, keep = _row_columns(lanes, pos, keep)
    src = np.ascontiguousarray(src, dtype=dst.dtype)
    if src.shape != lanes.shape:
        raise ValueError(f"pack_column: src shape {src.shape} != lanes shape {lanes.shape}")
    getattr(lib, name)(
        _ptr(dst, ctype), _ptr(src, ctype), _ptr(lanes, ctypes.c_int32),
        _ptr(pos, ctypes.c_int32), _ptr(keep, ctypes.c_uint8),
        lanes.shape[0], dst.shape[1],
    )


def pack_column_plain(dst: np.ndarray, src, lanes, pos, keep) -> None:
    """The NumPy version of :func:`pack_column`."""
    m = np.asarray(keep, dtype=bool)
    dst[np.asarray(lanes)[m], np.asarray(pos)[m]] = np.asarray(src, dtype=dst.dtype)[m]


def pack_valid(dst: np.ndarray, lanes, pos, keep) -> None:
    """``dst[lanes[i], pos[i]] = True`` for every kept record (``dst`` is
    the boolean validity grid)."""
    lib = _load()
    if lib is None or dst.dtype != np.bool_ or not dst.flags.c_contiguous:
        return pack_valid_plain(dst, lanes, pos, keep)
    lanes, pos, keep = _row_columns(lanes, pos, keep)
    lib.cep_pack_valid(
        _ptr(dst, ctypes.c_uint8), _ptr(lanes, ctypes.c_int32),
        _ptr(pos, ctypes.c_int32), _ptr(keep, ctypes.c_uint8),
        lanes.shape[0], dst.shape[1],
    )


def pack_valid_plain(dst: np.ndarray, lanes, pos, keep) -> None:
    """The NumPy version of :func:`pack_valid`."""
    m = np.asarray(keep, dtype=bool)
    dst[np.asarray(lanes)[m], np.asarray(pos)[m]] = True


# -- JSON-lines parsing --------------------------------------------------------


def parse_json_lines(
    text: bytes, fields: Sequence[str], key_field: str = "", key_width: int = 32,
) -> Tuple[np.ndarray, List[Optional[str]], np.ndarray]:
    """Parse newline-separated flat JSON objects into columns.

    Returns ``(values[n, F] float64, keys[n], ok[n] bool)``: ``keys`` holds
    each line's ``key_field`` string (None when absent, empty, or when the
    line failed).  The fast path rejects (rather than interprets) anything
    outside its fragment — nested containers, escapes, booleans or null,
    string-typed numeric fields, numbers outside the JSON grammar, keys
    longer than ``key_width`` bytes — so a caller re-parses ``ok=False``
    lines with a full JSON parser.  Lines split on ``\\n`` only.  The C++
    and plain versions keep this contract identically."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    lib = _load()
    if lib is None or not text:
        return parse_json_lines_plain(text, fields, key_field, key_width)
    F = len(fields)
    n_lines = text.count(b"\n") + (0 if text.endswith(b"\n") else 1)
    values = np.full((n_lines, F), np.nan, dtype=np.float64)
    ok = np.zeros(n_lines, dtype=np.uint8)
    keys_buf = np.zeros((n_lines, key_width), dtype=np.uint8)
    names_blob = b"".join(f.encode() + b"\0" for f in fields)
    n_bad = ctypes.c_int64(0)
    consumed = lib.cep_parse_json_lines(
        text, len(text), names_blob, F, key_field.encode(),
        _ptr(values, ctypes.c_double), keys_buf.ctypes.data_as(ctypes.c_char_p),
        key_width, _ptr(ok, ctypes.c_uint8), n_lines, ctypes.byref(n_bad),
    )
    if consumed < 0:  # more fields than the C++ name table holds
        return parse_json_lines_plain(text, fields, key_field, key_width)
    keys: List[Optional[str]] = [
        (bytes(keys_buf[i]).rstrip(b"\0").decode("utf-8", "replace") or None)
        if ok[i] and key_field else None
        for i in range(n_lines)
    ]
    return values, keys, ok.astype(bool)


def parse_json_lines_plain(
    text: bytes, fields: Sequence[str], key_field: str = "", key_width: int = 32,
) -> Tuple[np.ndarray, List[Optional[str]], np.ndarray]:
    """The Python version of :func:`parse_json_lines` (``json.loads`` per
    line, held to the C++ path's accept/reject contract)."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    F = len(fields)
    if not text:
        return np.zeros((0, F), dtype=np.float64), [], np.zeros(0, dtype=bool)

    def tofloat(v):
        # As strtod: JSON integer literals beyond float range are +-inf.
        try:
            return float(v)
        except OverflowError:
            return math.inf if v > 0 else -math.inf

    # errors="replace", as the C++ path: invalid bytes fail a line's parse
    # (outside strings) or survive as U+FFFD inside key strings.
    lines = text.decode("utf-8", errors="replace").split("\n")
    if text.endswith(b"\n"):
        lines.pop()
    values = np.full((len(lines), F), np.nan, dtype=np.float64)
    ok = np.zeros(len(lines), dtype=bool)
    keys: List[Optional[str]] = []
    for i, line in enumerate(lines):
        row, key = None, None
        # The C++ path fails any string holding a backslash (no escapes).
        if "\\" not in line:
            try:
                obj = json.loads(line)
                if (
                    isinstance(obj, dict)
                    and not any(isinstance(v, (bool, dict, list)) or v is None
                                for v in obj.values())
                    and all(isinstance(obj.get(f), (int, float)) for f in fields)
                ):
                    row = [tofloat(obj[f]) for f in fields]
                    raw = obj.get(key_field) if key_field else None
                    if isinstance(raw, str):
                        if len(raw.encode("utf-8")) > key_width:
                            row = None  # a key too wide fails the line
                        else:
                            key = raw or None
            except (ValueError, KeyError, TypeError):
                row = None
        if row is None:
            keys.append(None)
            continue
        values[i] = row
        ok[i] = True
        keys.append(key)
    return values, keys, ok
