"""Durable record journal — the Kafka changelog-segment analog.

The reference's recovery story rests on broker log segments: state stores
are changelog-backed, so a restarted task replays the log to rebuild state
(SURVEY §5, ``CEPProcessor.java:144-149``).  Here the supervisor pairs
array checkpoints with this journal: every processed batch is appended as
one CRC32-framed payload, and after *any* failure — device loss or a full
process crash — the journal's intact prefix replays deterministically on
top of the last checkpoint.

Writes go through the native C++ path (``src/journal.cpp``, one syscall
per batch, optional fsync) when the shared library is available: it is
built with ``g++`` at first use into ``kafkastreams_cep_tpu_torch/build/``
(``CEP_NO_NATIVE=1`` skips it).  The pure Python fallback produces
byte-identical files (same framing, same zlib CRC32), so journals are fully
interchangeable between the two, and with the JAX package's journal, whose
format this is.

A torn final frame (crash mid-write) is detected by magic/length/CRC
validation and simply ends the replay — exactly a log truncated at the
last good record.  ``Journal.replay`` also *repairs* the file by
truncating the corrupt tail so subsequent appends never interleave with
garbage.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import zlib
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from kafkastreams_cep_tpu_torch.native import build_library
from kafkastreams_cep_tpu_torch.utils.failpoints import fire as _failpoint
from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("native.journal")

_SRC = Path(__file__).parent / "src" / "journal.cpp"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    """The C++ journal library, built at first use; None when it cannot
    be built or ``CEP_NO_NATIVE`` is set (the Python path then writes the
    same bytes)."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("CEP_NO_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(str(build_library(_SRC, "libcepjournal")))
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("native journal library unavailable (%s: %s); using the "
                       "Python path", type(e).__name__, e)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.cep_journal_append.restype = ctypes.c_int32
    lib.cep_journal_append.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int64, ctypes.c_int32]
    lib.cep_journal_scan.restype = ctypes.c_int64
    lib.cep_journal_scan.argtypes = [u8p, ctypes.c_int64, i64p, ctypes.c_int64, i64p]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the C++ journal library is loaded."""
    return _load() is not None

MAGIC = 0x43455031  # "CEP1"
_HEADER = struct.Struct("<III")  # magic, payload_len, crc32


class Journal:
    """Append-only CRC-framed payload log at ``path``.

    ``sync=True`` fsyncs every append (machine-crash durable); the default
    covers process crashes only, like Kafka's default ``flush.messages``.
    """

    def __init__(self, path: str, sync: bool = False):
        self.path = str(path)
        self.sync = bool(sync)

    # -- writing ------------------------------------------------------------

    def append(self, payload: bytes) -> None:
        payload = bytes(payload)
        # Fault site: an append that fails before anything reaches the file
        # (EROFS, ENOSPC at open) — see utils/failpoints.py.
        _failpoint("journal.append")
        # Remember the last good boundary: a failed append may leave a torn
        # frame that would make every LATER (successful) frame unreachable
        # on replay — roll back to this size before reporting the failure.
        try:
            size0 = os.path.getsize(self.path)
        except OSError:
            size0 = 0
        try:
            self._append(payload)
            # Fault site at the durability barrier: the frame bytes reached
            # the OS but the fsync (or the write itself, native path) is
            # reported failed — the except clause below rolls the frame
            # back so the on-disk journal stays a clean frame prefix.
            _failpoint("journal.fsync")
        except Exception:
            self._rollback(size0)
            raise

    def _append(self, payload: bytes) -> None:
        lib = _load()
        if lib is not None:
            # Zero-copy borrow: c_char_p points at the bytes object's
            # buffer, which the C side only reads.
            buf = ctypes.cast(
                ctypes.c_char_p(payload or b"\0"),
                ctypes.POINTER(ctypes.c_uint8),
            )
            rc = lib.cep_journal_append(
                self.path.encode(), buf, len(payload), 1 if self.sync else 0
            )
            if rc != 0:
                raise OSError(f"journal append failed (rc={rc}): {self.path}")
            return
        frame = _HEADER.pack(MAGIC, len(payload), zlib.crc32(payload))
        with open(self.path, "ab") as f:
            f.write(frame + payload)
            f.flush()
            if self.sync:
                os.fsync(f.fileno())

    def _rollback(self, size: int) -> None:
        try:
            if os.path.getsize(self.path) > size:
                with open(self.path, "r+b") as f:
                    f.truncate(size)
        except FileNotFoundError:
            return  # nothing was written — nothing to roll back
        except OSError:
            logger.exception(
                "journal %s: rollback after failed append also failed; "
                "later frames may be unreachable until replay repairs",
                self.path,
            )

    # -- reading ------------------------------------------------------------

    def _scan(self, data: bytes) -> tuple:
        """(frame spans, intact-prefix length) of ``data``."""
        lib = _load()
        if lib is not None and data:
            max_frames = max(len(data) // _HEADER.size, 1)
            out = np.empty(2 * max_frames, dtype=np.int64)
            valid = ctypes.c_int64(0)
            buf = ctypes.cast(
                ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8)
            )
            n = lib.cep_journal_scan(
                buf, len(data),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                max_frames, ctypes.byref(valid),
            )
            spans = [(int(out[2 * i]), int(out[2 * i + 1])) for i in range(n)]
            return spans, int(valid.value)
        spans: List[tuple] = []
        pos = 0
        while pos + _HEADER.size <= len(data):
            magic, plen, crc = _HEADER.unpack_from(data, pos)
            if magic != MAGIC:
                break
            start = pos + _HEADER.size
            if start + plen > len(data):
                break  # truncated tail
            if zlib.crc32(data[start:start + plen]) != crc:
                break  # corrupt
            spans.append((start, plen))
            pos = start + plen
        return spans, pos

    def replay(self, repair: bool = True) -> Iterator[bytes]:
        """Yield every intact payload in order; optionally truncate a
        corrupt/torn tail so future appends start at a clean boundary."""
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return
        spans, valid = self._scan(data)
        if repair and valid < len(data):
            logger.warning(
                "journal %s: truncating %d corrupt tail bytes after %d "
                "intact frames", self.path, len(data) - valid, len(spans),
            )
            with open(self.path, "r+b") as f:
                f.truncate(valid)
        for start, plen in spans:
            yield data[start:start + plen]

    # -- lifecycle ----------------------------------------------------------

    def truncate(self) -> None:
        """Drop all frames (checkpoint taken; the tail restarts empty)."""
        with open(self.path, "wb"):
            pass

    def delete(self) -> None:
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass
