"""numpy <-> torch bridges for engine states, so a state of this package and
one of the JAX package (pulled to the host as numpy arrays) can be compared
leaf by leaf, or handed from one to the other.

States are NamedTuples with the same class and field names in both
packages; the bridges work on names, so neither package imports the other.
They also carry the plain tuples of a tenant bank's engines, the dicts and
host scalars of a sizing report, and ``EngineConfig`` (a dataclass of the
same fields on both sides).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from kafkastreams_cep_tpu_torch.engine.matcher import EngineConfig, EngineState
from kafkastreams_cep_tpu_torch.engine.sizing import EscalationPolicy, ProbeReport
from kafkastreams_cep_tpu_torch.engine.stencil import (
    PrefixCarry, PromoOutput, StencilOutput, StencilState,
)
from kafkastreams_cep_tpu_torch.engine.tiered import TieredState
from kafkastreams_cep_tpu_torch.ops.slab import PutOps, SlabState
from kafkastreams_cep_tpu_torch.parallel.tenantbank import TenantState

#: This package's state and record classes, by name.
CLASSES = {c.__name__: c for c in (EngineState, SlabState, PutOps, TieredState,
                                   PrefixCarry, PromoOutput, StencilState,
                                   StencilOutput, TenantState, ProbeReport,
                                   EscalationPolicy, EngineConfig)}


def _host_scalar(x) -> bool:
    return x is None or (isinstance(x, (bool, int, float, str))
                         and not isinstance(x, np.generic))


def _config(x, classes):
    """A dataclass config of either package -> the class of its name in
    ``classes`` (the same fields)."""
    cls = classes.get(type(x).__name__, type(x))
    return cls(**dataclasses.asdict(x))


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _is_plain_seq(x) -> bool:
    return isinstance(x, (tuple, list)) and not hasattr(x, "_fields")


def state_arrays(state, prefix: str = "") -> Dict[str, np.ndarray]:
    """Any state NamedTuple (either package's) -> ``{name: ndarray}`` with
    the checkpoint's leaf names: fields by name (``alive``, ...,
    ``slab/stage``), the elements of a plain tuple by index (a tenant
    bank's ``engine/0/alive``, ``carry/1/...``), as JAX's
    ``tree_flatten_with_path`` names them."""
    out: Dict[str, np.ndarray] = {}
    items = (enumerate(state) if _is_plain_seq(state)
             else ((f, getattr(state, f)) for f in state._fields))
    for f, v in items:
        if hasattr(v, "_fields") or _is_plain_seq(v):
            out.update(state_arrays(v, f"{prefix}{f}/"))
        else:
            out[prefix + str(f)] = _numpy(v)
    return out


def state_from_arrays(arrays: Mapping[str, np.ndarray], template, prefix: str = ""):
    """Rebuild ``template``'s structure from ``state_arrays`` output, on
    ``template``'s device.  Shapes and dtypes must match exactly: a cast
    could turn float fold states' bit patterns into other values."""
    if _is_plain_seq(template):
        return type(template)(state_from_arrays(arrays, t, f"{prefix}{i}/")
                              for i, t in enumerate(template))
    leaves = {}
    for f in template._fields:
        t = getattr(template, f)
        name = prefix + f
        if hasattr(t, "_fields") or _is_plain_seq(t):
            leaves[f] = state_from_arrays(arrays, t, name + "/")
            continue
        if name not in arrays:
            raise ValueError(f"checkpoint missing state array {name!r}")
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(
                f"state array {name!r} has shape {a.shape}, engine expects "
                f"{tuple(t.shape)} (EngineConfig mismatch?)"
            )
        if torch.from_numpy(np.zeros((), a.dtype)).dtype != t.dtype:
            raise ValueError(
                f"state array {name!r} has dtype {a.dtype}, engine expects "
                f"{t.dtype} — refusing the silent cast"
            )
        leaves[f] = torch.as_tensor(np.array(a), device=t.device)
    return type(template)(**leaves)


def to_torch(x, device="cpu"):
    """A NamedTuple of numpy (or JAX) leaves -> this package's class of
    the same name with tensor leaves (or one array -> one tensor); plain
    tuples, dicts, host scalars and configs are carried through."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return _config(x, CLASSES)
    if _host_scalar(x):
        return x
    if isinstance(x, dict):
        return {k: to_torch(v, device) for k, v in x.items()}
    if hasattr(x, "_fields"):
        cls = CLASSES.get(type(x).__name__, type(x))
        return cls(**{f: to_torch(getattr(x, f), device) for f in x._fields})
    if isinstance(x, (tuple, list)):
        return type(x)(to_torch(v, device) for v in x)
    return torch.as_tensor(np.array(_numpy(x)), device=device)


def to_numpy(x, classes: Optional[Mapping[str, Any]] = None):
    """A NamedTuple of tensors -> the class of the same name in ``classes``
    (default: its own class) with numpy leaves; plain tuples, dicts, host
    scalars and configs (mapped by name too) are carried through."""
    classes = classes or {}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return _config(x, classes)
    if _host_scalar(x):
        return x
    if isinstance(x, dict):
        return {k: to_numpy(v, classes) for k, v in x.items()}
    if hasattr(x, "_fields"):
        cls = classes.get(type(x).__name__, type(x))
        return cls(**{f: to_numpy(getattr(x, f), classes) for f in x._fields})
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v, classes) for v in x)
    return _numpy(x)
