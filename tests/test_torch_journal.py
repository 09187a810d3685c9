"""The port's durable journal (``native/journal.py`` and its C++ write path
``native/src/journal.cpp``, built with g++ at first use) against the JAX
package's, after ``tests/test_journal.py``: each package reads the other's
journal frame for frame, the C++ and Python paths of the port write the
same bytes as the JAX package, and a torn or corrupt tail ends the replay
and is truncated, in both packages alike."""

import pickle
import shutil

import pytest

from kafkastreams_cep_tpu import native as jnative
from kafkastreams_cep_tpu.native.journal import Journal as JJournal
from kafkastreams_cep_tpu_torch.native import journal as tjournal
from kafkastreams_cep_tpu_torch.native.journal import Journal as TJournal

PAYLOADS = [b"alpha", b"", b"x" * 5000, pickle.dumps({"k": [1, 2, 3]}), bytes(range(256)) * 9]


def _paths():
    """``(package, use_native)`` writers and readers available here."""
    out = [("torch", False), ("jax", False)]
    if shutil.which("g++") and tjournal.available():
        out.append(("torch", True))
    if jnative.available():
        out.append(("jax", True))
    return out


def _run(pkg, use_native, fn):
    """``fn()`` with the package's C++ library on or off."""
    mod, attr = (tjournal, "_lib") if pkg == "torch" else (jnative, "_lib")
    saved = getattr(mod, attr)
    try:
        if not use_native:
            setattr(mod, attr, None)
        return fn()
    finally:
        setattr(mod, attr, saved)


def _journal(pkg, path):
    return (TJournal if pkg == "torch" else JJournal)(str(path))


def test_native_journal_builds_with_gpp():
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    assert tjournal.available()
    assert tjournal._load().cep_journal_scan is not None


@pytest.mark.parametrize("writer", _paths(), ids=lambda p: f"{p[0]}-{'cpp' if p[1] else 'py'}")
@pytest.mark.parametrize("reader", _paths(), ids=lambda p: f"{p[0]}-{'cpp' if p[1] else 'py'}")
def test_each_package_reads_the_others_journal(tmp_path, writer, reader):
    path = tmp_path / "j.log"
    wj = _journal(writer[0], path)
    _run(*writer, lambda: [wj.append(p) for p in PAYLOADS])
    got = _run(*reader, lambda: list(_journal(reader[0], path).replay()))
    assert got == PAYLOADS


@pytest.mark.parametrize("writer", _paths(), ids=lambda p: f"{p[0]}-{'cpp' if p[1] else 'py'}")
def test_bytes_equal_the_jax_packages(tmp_path, writer):
    a, b = tmp_path / "a.log", tmp_path / "b.log"
    wj = _journal(writer[0], a)
    _run(*writer, lambda: [wj.append(p) for p in PAYLOADS])
    ref = JJournal(str(b))
    _run("jax", False, lambda: [ref.append(p) for p in PAYLOADS])
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("tail", ["torn", "corrupt_middle", "garbage"])
@pytest.mark.parametrize("use_native", [False, True])
def test_bad_tails_end_replay_as_in_the_jax_package(tmp_path, tail, use_native):
    if use_native and not (shutil.which("g++") and tjournal.available()):
        pytest.skip("needs g++")
    results = {}
    for pkg in ("torch", "jax"):
        path = tmp_path / f"{pkg}.log"
        j = _journal(pkg, path)
        _run(pkg, use_native and pkg == "torch", lambda: [j.append(p) for p in PAYLOADS])
        data = bytearray(path.read_bytes())
        if tail == "torn":
            data += data[:12 + 5][:12] + b"al"  # a frame's header, part of its payload
        elif tail == "corrupt_middle":
            data[12 + 5 + 12 + 2] ^= 0xFF  # the third frame's payload
        else:
            data += b"\x00garbage-tail\x01"
        path.write_bytes(bytes(data))
        got = _run(pkg, use_native and pkg == "torch", lambda: list(j.replay()))
        results[pkg] = (got, path.read_bytes())
    assert results["torch"] == results["jax"]
    got, repaired = results["torch"]
    assert got == (PAYLOADS[:2] if tail == "corrupt_middle" else PAYLOADS)


def test_truncate_and_missing_file(tmp_path):
    j = TJournal(str(tmp_path / "none.log"))
    assert list(j.replay()) == []
    j.append(b"a")
    j.truncate()
    assert list(j.replay()) == []
    j.delete()
    j.delete()
