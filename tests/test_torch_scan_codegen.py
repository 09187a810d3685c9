"""The C++ that ``ops/scan_codegen.py`` emits for a pattern's predicates
and folds, compiled on the CPU and held against the JAX package's lambdas.

The generated header and ``csrc/scan_expr.cuh`` compile under a host
compiler as well as under nvcc; this suite builds them with ``g++ -O2
-ffp-contract=off`` into a shared library under ``tmp_path`` (skipping where
there is no ``g++``), evaluates every predicate and every fold over numpy
inputs through ``ctypes``, and asserts bit equality with the same lambdas
evaluated by JAX (predicates as bools, folds as their state's int32 bit
pattern), on:

* the stock query at int32 values above 2^24, where float32 and double
  arithmetic disagree on ``v["volume"] < 0.8 * st.get_or_else("volume", 0)``;
* negative operands of ``//`` and ``%`` (ints against JAX, floats against
  PyTorch, whose semantics the port's plain version has);
* the EMA fold of ``tests/test_scan_kernel.py``;
* every query of ``tests/torch_scenarios.py``;

and the cases the tracer refuses with ``LoweringError``.
"""

import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenarios as ts
from kafkastreams_cep_tpu.compiler.tables import lower as jlower
from kafkastreams_cep_tpu.engine.matcher import ArrayStates as JStates
from kafkastreams_cep_tpu_torch.compiler.tables import lower as tlower
from kafkastreams_cep_tpu_torch.engine.matcher import ArrayStates as TStates
from kafkastreams_cep_tpu_torch.ops import scan_codegen
from kafkastreams_cep_tpu_torch.ops.scan_codegen import LoweringError

CSRC = Path(scan_codegen.__file__).resolve().parent.parent / "csrc"

SHIM = r"""
#include "cep_pattern.h"
extern "C" void eval_all(int n, const void* const* leaves, const int32_t* key,
                         const int32_t* ts, const int32_t* agg, uint8_t* preds,
                         int32_t* folds) {
  const int G = CEP_G > 0 ? CEP_G : 1, A = CEP_A > 0 ? CEP_A : 1;
  for (int i = 0; i < n; ++i) {
    const CepEvent e = cep_load_event(leaves, i, key[i], ts[i]);
    const int32_t* ag = agg + (size_t)i * CEP_NS;
    for (int g = 0; g < CEP_G; ++g) preds[i * G + g] = cep_pred(g, e, ag);
    for (int a = 0; a < CEP_A; ++a)
      folds[i * A + a] = cep_fold(a, e, ag[cep_agg_state[a]]);
  }
}
"""


def compile_source(source, tmp_path):
    """The generated header plus the shim as a host shared library."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the generated header on the host")
    d = tmp_path / source.tag
    d.mkdir(exist_ok=True)
    (d / "cep_pattern.h").write_text(source.header)
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run(
        ["g++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
         f"-I{CSRC}", f"-I{d}", str(d / "shim.cpp"), "-o", str(lib)],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(lib))


def run_c(lib, source, leaves, key, tstamp, agg):
    """Every predicate ``[n, G]`` (bool) and fold ``[n, A]`` (int32 bits)."""
    n = key.shape[0]
    held = [np.ascontiguousarray(x) for x in leaves]
    ptrs = (ctypes.c_void_p * max(len(held), 1))(*[x.ctypes.data for x in held])
    preds = np.zeros((n, max(source.num_preds, 1)), np.uint8)
    folds = np.zeros((n, max(source.num_aggs, 1)), np.int32)
    args = [np.ascontiguousarray(a) for a in (key, tstamp, agg)]
    lib.eval_all(ctypes.c_int(n), ptrs, *[ctypes.c_void_p(a.ctypes.data) for a in args],
                 ctypes.c_void_p(preds.ctypes.data), ctypes.c_void_p(folds.ctypes.data))
    return preds[:, :source.num_preds].astype(bool), folds[:, :source.num_aggs]


def run_jax(tables, value, key, tstamp, agg):
    """The same predicates and folds evaluated by JAX on ``[n]`` arrays."""
    n = key.shape[0]
    flt = [d == "float32" for d in tables.state_dtypes]

    def dec(a, f):
        return jax.lax.bitcast_convert_type(jnp.asarray(a), jnp.float32) if f else jnp.asarray(a)

    def enc(v, f):
        if f:
            return np.asarray(jax.lax.bitcast_convert_type(jnp.asarray(v, jnp.float32), jnp.int32))
        return np.asarray(jnp.asarray(v, jnp.int32))

    jv = jax.tree_util.tree_map(jnp.asarray, value)
    states = JStates({nm: dec(agg[:, i], flt[i]) for i, nm in enumerate(tables.state_names)})
    preds = [
        np.broadcast_to(np.asarray(jnp.asarray(p(jnp.asarray(key), jv, jnp.asarray(tstamp), states), jnp.bool_)), (n,))
        for p in tables.predicates
    ]
    folds = [
        np.broadcast_to(enc(s.fn(jnp.asarray(key), jv, dec(agg[:, s.state], flt[s.state])), flt[s.state]), (n,))
        for s in tables.aggs
    ]
    return (np.stack(preds, 1) if preds else np.zeros((n, 0), bool),
            np.stack(folds, 1) if folds else np.zeros((n, 0), np.int32))


def run_torch(tables, value, key, tstamp, agg):
    """The same, evaluated by PyTorch (the port's plain step semantics)."""
    n = key.shape[0]
    flt = [d == "float32" for d in tables.state_dtypes]

    def dec(a, f):
        t = torch.as_tensor(np.ascontiguousarray(a))
        return t.view(torch.float32) if f else t

    def enc(v, f):
        v = torch.as_tensor(v)
        return (v.to(torch.float32).view(torch.int32) if f else v.to(torch.int32)).numpy()

    tv = jax.tree_util.tree_map(lambda x: torch.as_tensor(np.asarray(x)), value)
    k, t = torch.as_tensor(key), torch.as_tensor(tstamp)
    states = TStates({nm: dec(agg[:, i], flt[i]) for i, nm in enumerate(tables.state_names)})
    preds = [np.broadcast_to(torch.as_tensor(p(k, tv, t, states)).to(torch.bool).numpy(), (n,))
             for p in tables.predicates]
    folds = [np.broadcast_to(enc(s.fn(k, tv, dec(agg[:, s.state], flt[s.state])), flt[s.state]), (n,))
             for s in tables.aggs]
    return (np.stack(preds, 1) if preds else np.zeros((n, 0), bool),
            np.stack(folds, 1) if folds else np.zeros((n, 0), np.int32))


def random_agg(rng, tables, n, float_scale=100.0):
    """``[n, NS]`` encoded fold states: wide int32s, float32 bit patterns."""
    NS = max(tables.num_states, 1)
    agg = rng.integers(-2 ** 31, 2 ** 31, size=(n, NS), dtype=np.int64).astype(np.int32)
    for i, d in enumerate(tables.state_dtypes):
        if d == "float32":
            agg[:, i] = (rng.normal(size=n) * float_scale).astype(np.float32).view(np.int32)
    return agg


def check(builder, value, agg, tmp_path, against=("jax",)):
    """Compile ``builder``'s generated C++ and compare it with JAX (and/or
    PyTorch) on the given leaves and states, bit for bit."""
    jtab, ttab = jlower(builder(ts.JQuery)), tlower(builder(ts.TQuery))
    tvalue = jax.tree_util.tree_map(lambda x: torch.as_tensor(np.asarray(x)), value)
    source = scan_codegen.generate(ttab, tvalue)
    lib = compile_source(source, tmp_path)
    n = agg.shape[0]
    key = np.arange(n, dtype=np.int32) - n // 2
    tstamp = np.arange(n, dtype=np.int32) * 7 - 100
    leaves = [x.numpy() for x in scan_codegen.value_leaves(tvalue)]  # the header's order
    got = run_c(lib, source, leaves, key, tstamp, agg)
    for name in against:
        want = (run_jax(jtab, value, key, tstamp, agg) if name == "jax"
                else run_torch(ttab, value, key, tstamp, agg))
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"predicates vs {name}")
        np.testing.assert_array_equal(got[1], want[1], err_msg=f"folds vs {name}")
    return got


def test_stock_query_above_float32_integers(tmp_path):
    rng = np.random.default_rng(0)
    n = 4096
    value = {
        "price": rng.integers(-2 ** 31, 2 ** 31, size=n, dtype=np.int64).astype(np.int32),
        "volume": rng.integers(2 ** 24, 2 ** 31, size=n, dtype=np.int64).astype(np.int32),
    }
    tables = tlower(ts.stock(ts.TQuery))
    agg = random_agg(rng, tables, n)
    vol = tables.state_names.index("volume")
    agg[:, vol] = rng.integers(2 ** 24, 2 ** 31, size=n, dtype=np.int64).astype(np.int32)
    # The pair where float32 and double disagree.
    value["volume"][0], agg[0, vol] = 1_463_366_179, 1_829_207_724
    assert (np.float32(value["volume"][0]) < np.float32(0.8) * np.float32(agg[0, vol])) != (
        float(value["volume"][0]) < 0.8 * float(agg[0, vol]))
    preds, _ = check(ts.stock, value, agg, tmp_path, against=("jax", "torch"))
    assert preds.any() and not preds.all()


def floor_ops(Q):
    """Floor division and remainder with negative operands, int and float."""
    return (
        Q().select().where(lambda k, v, ts_, st: (v["a"] // v["b"]) % 5 == st.get("s") % -3)
        .fold("s", lambda k, v, curr: (curr - v["a"]) // 3 + v["a"] % -7)
        .fold("f", lambda k, v, curr: (curr * 1.5 - v["a"]) // 2.5 + curr % -1.75,
              init=0.0)
        .then().select().where(lambda k, v, ts_, st: (-v["a"]) // 4 < st.get("f") % 3.0)
        .fold("s", lambda k, v, curr: -(curr // -5) - (v["b"] % 6))
        .build()
    )


def test_floor_division_and_remainder_negative_operands(tmp_path):
    rng = np.random.default_rng(1)
    n = 4096
    b = rng.integers(-50, 50, size=n).astype(np.int32)
    b[b == 0] = 7
    value = {"a": rng.integers(-1000, 1000, size=n).astype(np.int32), "b": b}
    tables = tlower(floor_ops(ts.TQuery))
    agg = random_agg(rng, tables, n)
    agg[:, tables.state_names.index("s")] = rng.integers(-10 ** 6, 10 ** 6, size=n)
    # Integer floors against JAX; the float folds against PyTorch, whose
    # floor_divide/remainder the port's plain version runs.
    got = check(floor_ops, value, agg, tmp_path, against=("torch",))
    want = run_jax(jlower(floor_ops(ts.JQuery)), value, np.arange(n, dtype=np.int32) - n // 2,
                   np.arange(n, dtype=np.int32) * 7 - 100, agg)
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])  # int predicate
    for a, slot in enumerate(tables.aggs):
        if tables.state_dtypes[slot.state] == "int32":
            np.testing.assert_array_equal(got[1][:, a], want[1][:, a], err_msg=f"fold {a}")
    assert (value["a"] < 0).any() and (b < 0).any()


def ema(Q):
    """``tests/test_scan_kernel.py``'s typed float folds."""
    return (
        Q().select("a").where(lambda k, v, ts_, st: v["x"] > 0)
        .fold("ema", lambda k, v, curr: 0.5 * curr + 0.25 * v["x"], init=0.0)
        .fold("n", lambda k, v, curr: curr + 1, init=0)
        .then().select("b").skip_till_next_match()
        .where(lambda k, v, ts_, st: (st.get("ema") > 0.7) & (st.get("n") > 1))
        .build()
    )


def test_ema_fold(tmp_path):
    rng = np.random.default_rng(2)
    n = 4096
    value = {"x": rng.integers(-20, 20, size=n).astype(np.int32)}
    tables = tlower(ema(ts.TQuery))
    agg = random_agg(rng, tables, n, float_scale=3.0)
    check(ema, value, agg, tmp_path, against=("jax", "torch"))


@pytest.mark.parametrize("name", sorted(ts.SCENARIOS))
def test_scenario_queries(tmp_path, name):
    builder, kind = ts.SCENARIOS[name]
    rng = np.random.default_rng(3)
    n = 512
    value = ts.trace(kind, rng, n, 1)
    value = ({f: v[:, 0] - 3 for f, v in value.items()} if isinstance(value, dict)
             else value[:, 0] - 3)
    tables = tlower(builder(ts.TQuery))
    check(builder, value, random_agg(rng, tables, n, float_scale=4.0), tmp_path)


def _pattern(pred=None, fold=None):
    q = ts.TQuery().select().where(pred or (lambda k, v, t, st: v["x"] > 0))
    if fold is not None:
        q = q.fold("s", fold)
    return q.then().select().where(lambda k, v, t, st: v["x"] < 0).build()


REFUSED = {
    "torch_call": dict(pred=lambda k, v, t, st: torch.abs(v["x"]) > 1),
    "if": dict(pred=lambda k, v, t, st: (v["x"] > 1) if v["x"] > 0 else False),
    "and": dict(pred=lambda k, v, t, st: v["x"] > 1 and v["x"] < 5),
    "int": dict(pred=lambda k, v, t, st: int(v["x"]) > 1),
    "float": dict(pred=lambda k, v, t, st: float(v["x"]) > 1),
    "method": dict(pred=lambda k, v, t, st: v["x"].float() > 1),
    "numpy": dict(pred=lambda k, v, t, st: np.abs(v["x"]) > 1),
    "pow": dict(pred=lambda k, v, t, st: v["x"] ** 2 > 1),
    "max": dict(pred=lambda k, v, t, st: max(v["x"], 3) > 4),
    "floor": dict(pred=lambda k, v, t, st: math.floor(v["x"]) > 4),
    "fold_tensor": dict(fold=lambda k, v, curr: torch.tensor(1)),
    "fold_where": dict(fold=lambda k, v, curr: torch.where(v["x"] > 0, curr, 0)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_lowering_errors(case):
    tables = tlower(_pattern(**REFUSED[case]))
    with pytest.raises(LoweringError):
        scan_codegen.generate(tables, {"x": torch.zeros(2, 3, dtype=torch.int32)})


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64, torch.int16])
def test_unsupported_leaf_dtypes(dtype):
    tables = tlower(_pattern())
    with pytest.raises(LoweringError, match="dtype"):
        scan_codegen.generate(tables, {"x": torch.zeros(2, 3, dtype=dtype)})


def test_python_scalars_round_to_float32_and_stay_weak():
    """``int32 op int`` stays int32; ``int32 op float`` rounds the constant
    to float32 and computes in float32; ``/`` is float32; bool ``&`` is
    logical."""
    tables = tlower(_pattern(
        pred=lambda k, v, t, st: ((v["x"] * 3 + 1) < 0.1 * v["x"]) & (v["x"] / 2 > 1),
    ))
    header = scan_codegen.generate(tables, {"x": torch.zeros(1, dtype=torch.int32)}).header
    assert "cep_mul(e.v0, 3)" in header and "cep_add(" in header
    assert f"{float(np.float32(0.1)).hex()}f" in header
    assert "(((float)e.v0) / ((float)2))" in header
    assert " && " in header
