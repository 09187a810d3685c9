"""numpy <-> torch bridges for engine states, so a state of this package and
one of the JAX package (pulled to the host as numpy arrays) can be compared
leaf by leaf, or handed from one to the other.

States are NamedTuples with the same class and field names in both
packages; the bridges work on names, so neither package imports the other.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from kafkastreams_cep_tpu_torch.engine.matcher import EngineState
from kafkastreams_cep_tpu_torch.engine.stencil import PrefixCarry, PromoOutput
from kafkastreams_cep_tpu_torch.engine.tiered import TieredState
from kafkastreams_cep_tpu_torch.ops.slab import PutOps, SlabState

#: This package's state classes, by name.
CLASSES = {c.__name__: c for c in (EngineState, SlabState, PutOps, TieredState,
                                   PrefixCarry, PromoOutput)}


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def state_arrays(state, prefix: str = "") -> Dict[str, np.ndarray]:
    """Any state NamedTuple (either package's) -> ``{name: ndarray}`` with
    the checkpoint's leaf names (``alive``, ..., ``slab/stage``, ...)."""
    out: Dict[str, np.ndarray] = {}
    for f in state._fields:
        v = getattr(state, f)
        if hasattr(v, "_fields"):
            out.update(state_arrays(v, f"{prefix}{f}/"))
        else:
            out[prefix + f] = _numpy(v)
    return out


def state_from_arrays(arrays: Mapping[str, np.ndarray], template, prefix: str = ""):
    """Rebuild ``template``'s structure from ``state_arrays`` output, on
    ``template``'s device.  Shapes and dtypes must match exactly: a cast
    could turn float fold states' bit patterns into other values."""
    leaves = {}
    for f in template._fields:
        t = getattr(template, f)
        name = prefix + f
        if hasattr(t, "_fields"):
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
    the same name with tensor leaves (or one array -> one tensor)."""
    if hasattr(x, "_fields"):
        cls = CLASSES.get(type(x).__name__, type(x))
        return cls(**{f: to_torch(getattr(x, f), device) for f in x._fields})
    return torch.as_tensor(np.array(_numpy(x)), device=device)


def to_numpy(x, classes: Optional[Mapping[str, Any]] = None):
    """A NamedTuple of tensors -> the class of the same name in ``classes``
    (default: its own class) with numpy leaves."""
    if hasattr(x, "_fields"):
        cls = (classes or {}).get(type(x).__name__, type(x))
        return cls(**{f: to_numpy(getattr(x, f), classes) for f in x._fields})
    return _numpy(x)
