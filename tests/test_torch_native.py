"""The port's native ingest library (``kafkastreams_cep_tpu_torch/native``)
against its plain NumPy versions and against the JAX package's ``native``.

Every entry point runs three ways on the same inputs — the port's C++
library (built with g++ into the port's ``build/``), the port's plain
version, and the JAX package's C++ library or fallback — and all three must
agree exactly, on the cases of ``tests/test_native.py``: queue positions,
the three column types and the validity grid, and the JSON-lines parser's
accept/reject contract (huge integers, empty keys, duplicate key fields,
empty input).
"""

import json

import numpy as np
import pytest

from kafkastreams_cep_tpu import native as jnative
from kafkastreams_cep_tpu.utils import serde as jserde
from kafkastreams_cep_tpu_torch import native
from kafkastreams_cep_tpu_torch.utils import serde


def jax_native(use_native, fn):
    """Run ``fn`` with the JAX package's C++ library on or off."""
    saved = jnative._lib
    try:
        if not use_native:
            jnative._lib = None
        return fn(jnative)
    finally:
        jnative._lib = saved


def three_ways(call):
    """``call(queue_positions, pack_column, pack_valid, parse_json_lines)``
    through the port's C++ library, the port's plain versions and the JAX
    package's C++ path and fallback."""
    assert native.available()
    ways = {
        "port_native": call(native.queue_positions, native.pack_column,
                            native.pack_valid, native.parse_json_lines),
        "port_plain": call(native.queue_positions_plain, native.pack_column_plain,
                           native.pack_valid_plain, native.parse_json_lines_plain),
    }
    for label, on in (("jax_native", True), ("jax_fallback", False)):
        ways[label] = jax_native(on, lambda m: call(
            m.queue_positions, m.pack_column, m.pack_valid, m.parse_json_lines))
    return ways


def assert_all_equal(ways):
    ref_label, ref = next(iter(ways.items()))
    for label, got in ways.items():
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, (label, ref_label)
                np.testing.assert_array_equal(a, b, err_msg=f"{label} vs {ref_label}")
            else:
                assert a == b, (label, ref_label)


def test_library_builds_into_the_port_build_dir():
    path = native.build()
    assert native.available()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libcepingest-") and path.suffix == ".so"


@pytest.mark.parametrize("case", ["mixed", "all_dropped", "empty"])
def test_queue_positions(case):
    if case == "mixed":
        lanes = np.array([0, 1, 0, 2, 1, 0, 2, 2], dtype=np.int32)
        keep = np.array([1, 1, 1, 0, 1, 1, 1, 1], dtype=np.uint8)
        K = 4
    elif case == "all_dropped":
        lanes, keep, K = np.array([0, 1], np.int32), np.zeros(2, np.uint8), 2
    else:
        lanes, keep, K = np.zeros(0, np.int32), np.zeros(0, np.uint8), 3
    ways = three_ways(lambda qp, *_: qp(lanes, keep, K))
    assert_all_equal(ways)
    pos, qlen, max_len = ways["port_native"]
    if case == "mixed":
        assert pos.tolist() == [0, 0, 1, -1, 1, 2, 0, 1]
        assert qlen.tolist() == [3, 2, 2, 0] and max_len == 3
    else:
        assert max_len == 0 and not qlen.any()


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int64])
@pytest.mark.parametrize("seed", [3, 4])
def test_pack_column_and_valid(dtype, seed):
    rng = np.random.default_rng(seed)
    n, K = 64, 8
    lanes = rng.integers(0, K, size=n).astype(np.int32)
    keep = (rng.random(n) < 0.8).astype(np.uint8)
    pos, _, max_len = native.queue_positions_plain(lanes, keep, K)
    T = max(max_len, 1)
    src = (rng.integers(-1000, 1000, size=n) * (1.5 if dtype == np.float32 else 1)).astype(dtype)

    def call(_qp, pack, valid_fn, _parse):
        dst = np.zeros((K, T), dtype=dtype)
        pack(dst, src, lanes, pos, keep)
        valid = np.zeros((K, T), dtype=bool)
        valid_fn(valid, lanes, pos, keep)
        return dst, valid

    ways = three_ways(call)
    assert_all_equal(ways)
    m = keep.astype(bool)
    want = np.zeros((K, T), dtype=dtype)
    want[lanes[m], pos[m]] = src[m]
    np.testing.assert_array_equal(ways["port_native"][0], want)
    assert ways["port_native"][1].sum() == m.sum()


def parse(text, fields=("price", "volume"), key_field="name"):
    """The parser three ways; values of rejected lines are unspecified (a
    caller re-parses them), so each way's values keep only its ok rows."""
    def call(*fns):
        values, keys, ok = fns[3](text, list(fields), key_field)
        return values[ok], keys, ok

    return three_ways(call)


def test_parse_json_lines_values_and_keys():
    lines = [
        {"name": "e1", "price": 100, "volume": 1010},
        {"name": "e2", "price": 120.5, "volume": 990},
        {"name": "e3", "price": -3, "volume": 1.5e3},
    ]
    ways = parse("\n".join(json.dumps(o) for o in lines).encode())
    assert_all_equal(ways)
    values, keys, ok = ways["port_native"]
    assert ok.all() and keys == ["e1", "e2", "e3"]
    np.testing.assert_array_equal(values, [[100, 1010], [120.5, 990], [-3, 1500]])


def test_parse_json_lines_bad_lines_and_spacing():
    text = (b'{"price":1,"volume":2}\n'
            b"not json at all\n"
            b'{"price":3}\n'
            b'  {"price": 7 , "volume": 8}  \n'
            b'{"price":4,"volume":5}\n')
    ways = parse(text, key_field="")
    assert_all_equal(ways)
    values, keys, ok = ways["port_native"]
    assert ok.tolist() == [True, False, False, True, True]
    assert keys == [None] * 5
    np.testing.assert_array_equal(values, [[1, 2], [7, 8], [4, 5]])


def test_parse_json_lines_reject_contract():
    """The cases of ``tests/test_native.py``: every path rejects exactly
    the same out-of-fragment lines."""
    cases = [
        (b'{"name":"' + b"x" * 33 + b'","price":1,"volume":2}', False),  # key > 32 B
        (b'{"name":"' + b"x" * 32 + b'","price":1,"volume":2}', True),  # key = 32 B
        (b'{"name":"e\\t1","price":1,"volume":2}', False),  # escape
        (b'{"price":true,"volume":2}', False),
        (b'{"price":null,"volume":2}', False),
        (b'{"price":1,"volume":2,"extra":[1]}', False),
        (b'{"price":1,"volume":2,"extra":{"a":1}}', False),
        (b'{"price":"12","volume":2}', False),
        (b'{"price":inf,"volume":2}', False),
        (b'{"price":0x1A,"volume":2}', False),
        (b'{"price":-1.5e2,"volume":2}', True),
        (b'{"price":1,"volume":2,"note":"ok"}', True),
        (b'{"price":01,"volume":2}', False),
        (b'{"price":1.,"volume":2}', False),
        (b'{"price":1.e3,"volume":2}', False),
        (b'{"price":0.5e+1,"volume":2}', True),
        (b'\xff{"price":1,"volume":2}', False),
        (b'{"price":1,"volume":2} trailing', False),
        (b'[1, 2]', False),
    ]
    ways = parse(b"\n".join(c for c, _ in cases))
    assert_all_equal(ways)
    values, keys, ok = ways["port_native"]
    assert ok.tolist() == [want for _, want in cases]
    np.testing.assert_array_equal(values[1], [-150.0, 2.0])  # the second ok line
    assert keys[1] == "x" * 32


def test_parse_json_lines_huge_integers_are_inf():
    text = ('{"price":1' + "0" * 400 + ',"volume":-1' + "0" * 400 + "}").encode()
    ways = parse(text, key_field="")
    assert_all_equal(ways)
    values, _, ok = ways["port_native"]
    assert ok.tolist() == [True]
    assert values[0, 0] == np.inf and values[0, 1] == -np.inf


@pytest.mark.parametrize("text,want_keys", [
    (b'{"name":"","price":1,"volume":2}', [None]),  # empty key
    (b'{"name":"abcdef","name":"x","price":1,"volume":2}', ["x"]),  # last wins
    (b'{"price":1,"volume":2}', [None]),  # absent key
])
def test_parse_json_lines_key_field_cases(text, want_keys):
    ways = parse(text)
    assert_all_equal(ways)
    _, keys, ok = ways["port_native"]
    assert ok.tolist() == [True] and keys == want_keys


@pytest.mark.parametrize("text", [b"", "", b"\n"])
def test_parse_json_lines_empty_input(text):
    ways = parse(text)
    assert_all_equal(ways)
    values, keys, ok = ways["port_native"]
    if text in (b"", ""):
        assert values.shape == (0, 2) and keys == [] and ok.shape == (0,)
    else:
        assert ok.tolist() == [False] and keys == [None]


def test_no_native_env_selects_plain_versions(monkeypatch):
    """``CEP_NO_NATIVE=1`` loads no library: every entry point runs its
    plain version."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("CEP_NO_NATIVE", "1")
    assert not native.available()
    lanes = np.array([1, 0, 1], np.int32)
    pos, qlen, max_len = native.queue_positions(lanes, np.ones(3, np.uint8), 2)
    assert pos.tolist() == [0, 0, 1] and qlen.tolist() == [1, 2] and max_len == 2
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv("CEP_NO_NATIVE")
    assert native.available()


def test_pack_refuses_columns_of_other_lengths():
    dst = np.zeros((2, 2), np.int32)
    lanes, pos, keep = np.zeros(3, np.int32), np.arange(3, dtype=np.int32), np.ones(3, np.uint8)
    with pytest.raises(ValueError, match="src shape"):
        native.pack_column(dst, np.zeros(2, np.int32), lanes, pos, keep)
    with pytest.raises(ValueError, match="one length"):
        native.pack_valid(np.zeros((2, 2), bool), lanes, pos[:2], keep)


@pytest.mark.parametrize("value", [{"name": "e1", "price": 100, "volume": 1010},
                                   [1, 2.5, None], "caf\u00e9", 7])
def test_serde_equals_jax(value):
    for make in ("json_serde", "string_serde"):
        if make == "string_serde" and not isinstance(value, str):
            continue
        t, j = getattr(serde, make)(), getattr(jserde, make)()
        data = t.serialize(value)
        assert data == j.serialize(value)
        assert t.deserialize(data) == j.deserialize(data) == value
