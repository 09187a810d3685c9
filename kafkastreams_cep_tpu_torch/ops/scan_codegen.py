"""A pattern's predicates and folds as CUDA C++, for the whole-scan kernel.

The counterpart of the step in which ``kafkastreams_cep_tpu/ops/
scan_kernel.py`` traces the user's predicates and folds into its Pallas
kernel as ``[R, L]`` vector code (``:356-372`` predicates, ``:554-560``
folds, ``dec``/``enc`` at ``:203-211``).  A hand-written CUDA kernel cannot
run Python, so :func:`generate` calls each of the pattern's predicates and
each fold once, on symbolic proxies of ``key``, ``value`` (one proxy per
leaf, with the leaf's dtype), ``ts``, ``states`` and ``curr``, records every
operation the lambda performs, and emits it as C++ over one run's scalars:
one ``cep_pred_<g>`` per predicate and one ``cep_fold_<a>`` per fold, plus
the pattern's transition tables as constant arrays, into a header that
``csrc/scan_pass.cu`` includes.  The kernel's own source stays hand-written;
the header holds only the user's expressions and tables.

The emitted code keeps PyTorch's semantics, which are the plain version's:

* dtypes promote as tensors do with weak Python scalars: ``int32 op int``
  stays int32, ``int32 op float`` is float32 (the constant rounded to
  float32 first), ``/`` is always float32, comparisons promote int to
  float32; ``&``, ``|``, ``^`` and ``~`` on bools are logical;
* ``//`` floors and ``%`` takes the divisor's sign (``csrc/scan_expr.cuh``);
  int32 arithmetic wraps;
* a predicate's result is cast to bool, a fold's to its state's dtype and
  stored through its int32 bit pattern (``engine/matcher.py`` ``as_bool``
  and ``enc``);
* every operation rounds on its own: the kernel is compiled without
  floating-point contraction (``-fmad=false``).

What the tracer cannot express raises :class:`LoweringError` on the host,
before any build: a call into ``torch`` or ``numpy``, a method or operator
it does not know, ``bool()`` of a proxy (an ``if``, ``and``, ``or``, ``min``
or ``max``), ``int()``/``float()`` of one, or an event leaf whose dtype is
not int32, float32 or bool.  ``parallel/batch.py`` then runs the per-step
path instead.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from kafkastreams_cep_tpu_torch.compiler.tables import (
    OP_BEGIN,
    OP_TAKE,
    TYPE_BEGIN,
    TransitionTables,
)

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1
#: Scalar kinds: bool, int32, float32, in promotion order.
_RANK = {"b": 0, "i": 1, "f": 2}
_CTYPE = {"b": "bool", "i": "int32_t", "f": "float"}
_TORCH = {"b": torch.bool, "i": torch.int32, "f": torch.float32}
_KIND_OF = {torch.bool: "b", torch.int32: "i", torch.float32: "f"}


class LoweringError(Exception):
    """A predicate or fold the code generator cannot express in C++."""


class _Tape:
    """The operations one traced function performs, as C++ statements."""

    def __init__(self, what: str):
        self.what = what
        self.lines: List[str] = []

    def emit(self, kind: str, expr: str) -> "Expr":
        name = f"t{len(self.lines)}"
        self.lines.append(f"  const {_CTYPE[kind]} {name} = {expr};")
        return Expr(self, name, kind)


def _const(x) -> Tuple[str, str]:
    """A Python scalar as ``(kind, C++ literal)``."""
    if isinstance(x, (bool, np.bool_)):
        return "b", "true" if x else "false"
    if isinstance(x, (int, np.integer)):
        v = int(x)
        if not _I32_MIN <= v <= _I32_MAX:
            raise LoweringError(f"integer constant {v} outside int32")
        return "i", "(-2147483647 - 1)" if v == _I32_MIN else str(v)
    if isinstance(x, (float, np.floating)):
        f = np.float32(x)
        if np.isfinite(f):
            return "f", f"{float(f).hex()}f"
        return "f", f"cep_bits_f({int(f.view(np.int32))})"
    raise LoweringError(f"operand of type {type(x).__name__}")


def _cast(kind: str, code: str, to: str) -> str:
    if kind == to:
        return code
    if to == "b":
        return f"({code} != 0)" if kind == "i" else f"({code} != 0.0f)"
    if to == "i":
        return f"((int32_t){code})" if kind == "b" else f"cep_f2i({code})"
    return f"({code} ? 1.0f : 0.0f)" if kind == "b" else f"((float){code})"


def _refuse(name):
    def method(self, *args, **kwargs):
        raise LoweringError(
            f"{self._tape.what}: {name} of a traced value is not supported "
            "(the whole-scan kernel runs the expression in C++)"
        )

    return method


class Expr:
    """A traced scalar: the C++ name of one value of kind ``b``/``i``/``f``.

    It looks like a 0-d tensor to the pattern combinators (``dtype`` and
    ``shape``) and supports the operators a predicate or fold may use on
    tensors; anything else raises :class:`LoweringError`."""

    __slots__ = ("_tape", "_code", "_kind", "dtype", "shape")

    def __init__(self, tape: _Tape, code: str, kind: str):
        self._tape, self._code, self._kind = tape, code, kind
        self.dtype = _TORCH[kind]
        self.shape = ()

    # -- operands ----------------------------------------------------------
    def _operand(self, other):
        """``(kind, code, weak)`` of the other operand."""
        if isinstance(other, Expr):
            if other._tape is not self._tape:
                raise LoweringError("traced values of two functions mixed")
            return other._kind, other._code, False
        kind, code = _const(other)
        return kind, code, True

    def _promote(self, ok: str, weak: bool) -> str:
        """Result kind of ``self op other`` (PyTorch's promotion with weak
        Python scalars)."""
        a, b = _RANK[self._kind], _RANK[ok]
        if weak and b <= a:
            return self._kind
        return ok if b > a else self._kind

    def _binary(self, other, op: str, reflected: bool = False) -> "Expr":
        ok, ocode, weak = self._operand(other)
        kind = self._promote(ok, weak)
        lhs, rhs = (self._kind, self._code), (ok, ocode)
        if reflected:
            lhs, rhs = rhs, lhs
        if op in ("<", "<=", ">", ">=", "==", "!="):
            a, b = _cast(*lhs, kind), _cast(*rhs, kind)
            return self._tape.emit("b", f"({a} {op} {b})")
        if op in ("&", "|", "^"):
            if kind == "f":
                raise LoweringError(f"{self._tape.what}: {op} on float32")
            a, b = _cast(*lhs, kind), _cast(*rhs, kind)
            if kind == "b":
                c = {"&": "&&", "|": "||", "^": "!="}[op]
                return self._tape.emit("b", f"({a} {c} {b})")
            return self._tape.emit("i", f"({a} {op} {b})")
        if op == "/":
            a, b = _cast(*lhs, "f"), _cast(*rhs, "f")
            return self._tape.emit("f", f"({a} / {b})")
        if kind == "b":
            raise LoweringError(f"{self._tape.what}: arithmetic {op} on bools")
        a, b = _cast(*lhs, kind), _cast(*rhs, kind)
        if kind == "f":
            expr = {
                "+": f"({a} + {b})", "-": f"({a} - {b})", "*": f"({a} * {b})",
                "//": f"cep_floordiv_f({a}, {b})", "%": f"cep_mod_f({a}, {b})",
            }[op]
        else:
            fn = {"+": "cep_add", "-": "cep_sub", "*": "cep_mul",
                  "//": "cep_floordiv_i", "%": "cep_mod_i"}[op]
            expr = f"{fn}({a}, {b})"
        return self._tape.emit(kind, expr)

    __add__ = lambda s, o: s._binary(o, "+")  # noqa: E731
    __radd__ = lambda s, o: s._binary(o, "+", True)  # noqa: E731
    __sub__ = lambda s, o: s._binary(o, "-")  # noqa: E731
    __rsub__ = lambda s, o: s._binary(o, "-", True)  # noqa: E731
    __mul__ = lambda s, o: s._binary(o, "*")  # noqa: E731
    __rmul__ = lambda s, o: s._binary(o, "*", True)  # noqa: E731
    __truediv__ = lambda s, o: s._binary(o, "/")  # noqa: E731
    __rtruediv__ = lambda s, o: s._binary(o, "/", True)  # noqa: E731
    __floordiv__ = lambda s, o: s._binary(o, "//")  # noqa: E731
    __rfloordiv__ = lambda s, o: s._binary(o, "//", True)  # noqa: E731
    __mod__ = lambda s, o: s._binary(o, "%")  # noqa: E731
    __rmod__ = lambda s, o: s._binary(o, "%", True)  # noqa: E731
    __and__ = lambda s, o: s._binary(o, "&")  # noqa: E731
    __rand__ = lambda s, o: s._binary(o, "&", True)  # noqa: E731
    __or__ = lambda s, o: s._binary(o, "|")  # noqa: E731
    __ror__ = lambda s, o: s._binary(o, "|", True)  # noqa: E731
    __xor__ = lambda s, o: s._binary(o, "^")  # noqa: E731
    __rxor__ = lambda s, o: s._binary(o, "^", True)  # noqa: E731
    __lt__ = lambda s, o: s._binary(o, "<")  # noqa: E731
    __le__ = lambda s, o: s._binary(o, "<=")  # noqa: E731
    __gt__ = lambda s, o: s._binary(o, ">")  # noqa: E731
    __ge__ = lambda s, o: s._binary(o, ">=")  # noqa: E731
    __eq__ = lambda s, o: s._binary(o, "==")  # noqa: E731
    __ne__ = lambda s, o: s._binary(o, "!=")  # noqa: E731
    __hash__ = None

    def __neg__(self):
        if self._kind == "b":
            raise LoweringError(f"{self._tape.what}: negation of a bool")
        if self._kind == "f":
            return self._tape.emit("f", f"(-{self._code})")
        return self._tape.emit("i", f"cep_neg({self._code})")

    def __pos__(self):
        return self

    def __abs__(self):
        if self._kind == "b":
            raise LoweringError(f"{self._tape.what}: abs of a bool")
        fn = "cep_abs_f" if self._kind == "f" else "cep_abs_i"
        return self._tape.emit(self._kind, f"{fn}({self._code})")

    def __invert__(self):
        if self._kind == "f":
            raise LoweringError(f"{self._tape.what}: ~ on float32")
        if self._kind == "b":
            return self._tape.emit("b", f"(!{self._code})")
        return self._tape.emit("i", f"(~{self._code})")

    # -- everything else refuses -------------------------------------------
    for _name in (
        "__bool__", "__int__", "__float__", "__index__", "__len__",
        "__iter__", "__contains__", "__getitem__", "__setitem__", "__pow__",
        "__rpow__", "__matmul__", "__rmatmul__", "__lshift__", "__rlshift__",
        "__rshift__", "__rrshift__", "__round__", "__trunc__", "__floor__",
        "__ceil__", "__divmod__", "__rdivmod__", "__array__", "__complex__",
        "__call__",
    ):
        locals()[_name] = _refuse(_name)
    del _name

    def __getattr__(self, name):
        raise LoweringError(
            f"{self._tape.what}: attribute or method {name!r} of a traced "
            "value is not supported"
        )

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise LoweringError(
            f"call of {getattr(func, '__name__', func)!r} on a traced value: "
            "torch functions are not supported in the whole-scan kernel"
        )

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        raise LoweringError(
            f"numpy {ufunc.__name__} on a traced value is not supported"
        )


class _States:
    """The fold-state view handed to traced predicates (``ArrayStates``'s
    interface over one run's decoded states)."""

    def __init__(self, tape: _Tape, tables: TransitionTables):
        self._tape = tape
        self._tables = tables
        self._cache = {}

    def get(self, name: str):
        if name not in self._cache:
            if name not in self._tables.state_names:
                raise KeyError(name)
            i = self._tables.state_names.index(name)
            if self._tables.state_dtypes[i] == "float32":
                self._cache[name] = self._tape.emit("f", f"cep_bits_f(agg[{i}])")
            else:
                self._cache[name] = Expr(self._tape, f"agg[{i}]", "i")
        return self._cache[name]

    def get_or_else(self, name: str, default):
        if name in self._tables.state_names:
            return self.get(name)
        return default

    def __getitem__(self, name: str):
        return self.get(name)


# -- event value leaves ------------------------------------------------------

def value_leaves(value) -> List[Any]:
    """The leaves of an event-value pytree in the engine's traversal order
    (``engine/matcher.py: map_value``: dict insertion order, lists in
    order)."""
    if isinstance(value, dict):
        return [x for v in value.values() for x in value_leaves(v)]
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in value_leaves(v)]
    return [value]


def _rebuild(value, leaves):
    it = iter(leaves)

    def go(v):
        if isinstance(v, dict):
            return {k: go(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(go(x) for x in v)
        return next(it)

    return go(value)


def leaf_kinds(value) -> Tuple[str, ...]:
    """Each event leaf's kind (``b``/``i``/``f``); raises
    :class:`LoweringError` for a dtype the kernel does not read."""
    kinds = []
    for x in value_leaves(value):
        kind = _KIND_OF.get(getattr(x, "dtype", None))
        if kind is None:
            raise LoweringError(
                f"event leaf of dtype {getattr(x, 'dtype', type(x))}: the "
                "whole-scan kernel reads int32, float32 and bool leaves"
            )
        kinds.append(kind)
    return tuple(kinds)


# -- tracing -----------------------------------------------------------------

def _event_inputs(tape: _Tape, value, kinds):
    key = Expr(tape, "e.key", "i")
    ts = Expr(tape, "e.ts", "i")
    leaves = [Expr(tape, f"e.v{i}", k) for i, k in enumerate(kinds)]
    return key, _rebuild(value, leaves), ts


def _result(tape: _Tape, r, to: str) -> str:
    """The traced result cast to kind ``to``, as C++."""
    if isinstance(r, Expr):
        if r._tape is not tape:
            raise LoweringError(f"{tape.what}: returned a value of another function")
        return _cast(r._kind, r._code, to)
    if isinstance(r, (bool, int, float, np.bool_, np.integer, np.floating)):
        kind, code = _const(r)
        return _cast(kind, code, to)
    raise LoweringError(
        f"{tape.what}: returned {type(r).__name__}, not a traced scalar"
    )


def _trace_pred(g: int, pred, tables, value, kinds) -> str:
    tape = _Tape(f"predicate {g} ({getattr(pred, 'label', pred)})")
    key, v, ts = _event_inputs(tape, value, kinds)
    out = _result(tape, pred(key, v, ts, _States(tape, tables)), "b")
    body = "\n".join(tape.lines)
    return (
        f"CEP_HD bool cep_pred_{g}(const CepEvent& e, const int32_t* agg) {{\n"
        f"  (void)e; (void)agg;\n{body}\n  return {out};\n}}\n"
    )


def _trace_fold(a: int, slot, tables, value, kinds) -> str:
    tape = _Tape(f"fold {a} ({slot.name})")
    key, v, _ = _event_inputs(tape, value, kinds)
    flt = tables.state_dtypes[slot.state] == "float32"
    curr = tape.emit("f", "cep_bits_f(cur)") if flt else Expr(tape, "cur", "i")
    out = _result(tape, slot.fn(key, v, curr), "f" if flt else "i")
    enc = f"cep_f_bits({out})" if flt else out
    body = "\n".join(tape.lines)
    return (
        f"CEP_HD int32_t cep_fold_{a}(const CepEvent& e, int32_t cur) {{\n"
        f"  (void)e; (void)cur;\n{body}\n  return {enc};\n}}\n"
    )


@dataclasses.dataclass(frozen=True)
class ScanSource:
    """One pattern's generated header for the events' leaf kinds."""

    header: str
    kinds: Tuple[str, ...]
    num_preds: int
    num_aggs: int
    hops: int  #: frames a run evaluates per event (``CEP_H``)

    @property
    def tag(self) -> str:
        return hashlib.sha256(self.header.encode()).hexdigest()[:16]


def _table(name: str, values: Sequence[int]) -> str:
    vals = [int(v) for v in values] or [0]
    return f"CEP_TABLE int32_t {name}[{len(vals)}] = {{{', '.join(map(str, vals))}}};"


def _enc_init(x, flt: bool) -> int:
    return int(np.float32(x).view(np.int32)) if flt else int(np.int32(x))


def generate(tables: TransitionTables, value) -> ScanSource:
    """Trace ``tables``' predicates and folds over event values shaped like
    ``value`` (a pytree of tensors, e.g. an ``EventBatch.value``) and emit
    the header ``csrc/scan_pass.cu`` includes.  Raises
    :class:`LoweringError` for what C++ cannot express."""
    kinds = leaf_kinds(value)
    NS = max(tables.num_states, 1)
    flts = [d == "float32" for d in tables.state_dtypes] + [False] * (
        NS - tables.num_states
    )
    inits = [
        _enc_init(x, f)
        for x, f in zip(list(tables.state_inits) + [0] * (NS - tables.num_states), flts)
    ]
    if tables.window_ms.max(initial=-1) > _I32_MAX:
        raise LoweringError("a window longer than int32 milliseconds")
    if len(tables.predicates) > 64:
        raise LoweringError(
            f"{len(tables.predicates)} predicates: the kernel holds one run's "
            "predicate results in a 64-bit mask"
        )
    preds = [
        _trace_pred(g, p, tables, value, kinds)
        for g, p in enumerate(tables.predicates)
    ]
    folds = [
        _trace_fold(a, slot, tables, value, kinds)
        for a, slot in enumerate(tables.aggs)
    ]
    G, A = len(preds), len(folds)
    fields = "".join(f" {_CTYPE[k]} v{i};" for i, k in enumerate(kinds))
    loads = "".join(
        (f"  e.v{i} = static_cast<const uint8_t*>(leaves[{i}])[i] != 0;\n"
         if k == "b" else
         f"  e.v{i} = static_cast<const {_CTYPE[k]}*>(leaves[{i}])[i];\n")
        for i, k in enumerate(kinds)
    )
    pred_cases = "".join(
        f"    case {g}: return cep_pred_{g}(e, agg);\n" for g in range(G)
    )
    fold_cases = "".join(
        f"    case {a}: return cep_fold_{a}(e, cur);\n" for a in range(A)
    )
    lines = [
        "// Generated by kafkastreams_cep_tpu_torch/ops/scan_codegen.py from one",
        "// pattern's predicates, folds and transition tables; included by",
        "// csrc/scan_pass.cu.  Do not edit.",
        "#pragma once",
        '#include "scan_expr.cuh"',
        "",
        f"#define CEP_S {tables.num_stages}",
        f"#define CEP_H {tables.max_hops}",
        f"#define CEP_G {G}",
        f"#define CEP_NS {NS}",
        f"#define CEP_A {A}",
        f"#define CEP_NUM_LEAVES {len(kinds)}",
        f"#define CEP_BEGIN_POS {int(tables.begin_pos)}",
        f"#define CEP_FINAL_POS {int(tables.final_pos)}",
        f"#define CEP_OP_BEGIN {OP_BEGIN}",
        f"#define CEP_OP_TAKE {OP_TAKE}",
        f"#define CEP_TYPE_BEGIN {TYPE_BEGIN}",
        "",
        _table("cep_types", tables.types),
        _table("cep_ident", tables.ident),
        _table("cep_window_ms", tables.window_ms),
        _table("cep_consume_op", tables.consume_op),
        _table("cep_consume_pred", tables.consume_pred),
        _table("cep_consume_target", tables.consume_target),
        _table("cep_ignore_pred", tables.ignore_pred),
        _table("cep_proceed_pred", tables.proceed_pred),
        _table("cep_proceed_target", tables.proceed_target),
        _table("cep_agg_stage", [s.stage for s in tables.aggs]),
        _table("cep_agg_state", [s.state for s in tables.aggs]),
        _table("cep_state_init", inits),
        "",
        f"struct CepEvent {{ int32_t key; int32_t ts;{fields} }};",
        "",
        "CEP_HD CepEvent cep_load_event(const void* const* leaves, size_t i,",
        "                               int32_t key, int32_t ts) {",
        "  CepEvent e;",
        "  e.key = key;",
        "  e.ts = ts;",
        loads + "  (void)leaves; (void)i;",
        "  return e;",
        "}",
        "",
        *preds,
        *folds,
        "CEP_HD bool cep_pred(int g, const CepEvent& e, const int32_t* agg) {",
        "  switch (g) {",
        pred_cases + "    default: return false;",
        "  }",
        "}",
        "",
        "CEP_HD int32_t cep_fold(int a, const CepEvent& e, int32_t cur) {",
        "  switch (a) {",
        fold_cases + "    default: return cur;",
        "  }",
        "}",
        "",
    ]
    return ScanSource("\n".join(lines), kinds, G, A, int(tables.max_hops))
