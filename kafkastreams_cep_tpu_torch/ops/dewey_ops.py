"""Fixed-width Dewey versions as tensors.

A version is a ``[..., D]`` int32 tensor plus an int32 length ``[...]``;
every function broadcasts over the leading axes (lanes, runs, pointers).
Semantics match the reference's ``nfa/DeweyVersion.java``:

* ``add_run``   increments the last live component (``DeweyVersion.java:51-56``);
* ``add_stage`` appends a ``0`` component (``DeweyVersion.java:84-86``) and
  reports an ``overflow`` flag when the version is already ``D`` wide (the
  component is dropped; the engine counts the flag in ``ver_overflows``);
* ``is_compatible(q, p)`` is true when ``p`` is a proper prefix of ``q``, or
  both have equal length with an equal prefix and ``last(q) >= last(p)``
  (``DeweyVersion.java:62-82``).
"""

from __future__ import annotations

import numpy as np
import torch


def make(components, depth: int):
    """Host helper: a numpy ``(version, length)`` pair from an int tuple."""
    components = tuple(int(c) for c in components)
    if len(components) > depth:
        raise ValueError(f"version {components} deeper than D={depth}")
    vec = np.zeros((depth,), dtype=np.int32)
    vec[: len(components)] = components
    return vec, np.int32(len(components))


def to_tuple(ver, vlen):
    """Host helper: back to the tuple form of a version."""
    return tuple(int(c) for c in ver[: int(vlen)])


def _positions(ver: torch.Tensor) -> torch.Tensor:
    return torch.arange(ver.shape[-1], dtype=torch.int32, device=ver.device)


def add_run(ver: torch.Tensor, vlen: torch.Tensor) -> torch.Tensor:
    """Increment the last live component (length is unchanged)."""
    bump = _positions(ver) == (vlen - 1).unsqueeze(-1)
    return ver + bump.to(ver.dtype)


def add_stage(ver: torch.Tensor, vlen: torch.Tensor):
    """Append a ``0`` component; returns ``(ver, vlen, overflow)``.

    Slots at index ``>= vlen`` are already zero, so only the length moves.
    On overflow (``vlen == D``) the length stays and the flag is set.
    """
    overflow = vlen >= ver.shape[-1]
    return ver, torch.where(overflow, vlen, vlen + 1), overflow


def is_compatible(qver, qlen, pver, plen):
    """``DeweyVersion.isCompatible`` of query ``q`` against pointer ``p``
    (the argument order of ``qv.isCompatible(pv)``,
    ``TimedKeyValue.java:91``), broadcast over leading axes."""
    idx = _positions(qver)
    plen_ = plen.unsqueeze(-1)
    eq = qver == pver
    prefix_full = torch.all(eq | (idx >= plen_), dim=-1)
    prefix_butlast = torch.all(eq | (idx >= plen_ - 1), dim=-1)
    at_last = idx == plen_ - 1
    last_q = torch.sum(torch.where(at_last, qver, 0), dim=-1)
    last_p = torch.sum(torch.where(at_last, pver, 0), dim=-1)
    longer = (qlen > plen) & prefix_full
    equal = (qlen == plen) & prefix_butlast & (last_q >= last_p)
    return longer | equal
