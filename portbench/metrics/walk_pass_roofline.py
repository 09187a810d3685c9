"""The walk pass's (B1's) share of its roofline in the traced batches: the
least time its work could take on this card (``roofline.py``: bytes of
every call counted from the configuration's shapes, operations from the
hops the traced batches made) over the time its kernels took.  In-step
calls and drain calls are told apart by the instance's name (the drain
instances are ``walk_pass<..., true, ...>`` with ``kDrain`` set)."""

import re

from portbench import roofline
from portbench.metrics import kernels

#: ``walk_pass<kTwoTier, kAttr, kDrain, kWide>``: the third flag.
_DRAIN = re.compile(r"walk_pass<\s*\w+\s*,\s*\w+\s*,\s*true")


def read(view):
    t = view.trace
    if t is None or roofline.peaks(view.kind) is None:
        return None
    drains = t.count(lambda n: kernels.is_walk_pass(n) and bool(_DRAIN.search(n)))
    steps = t.count(kernels.is_walk_pass) - drains
    seconds = t.seconds(kernels.is_walk_pass)
    if seconds <= 0 or steps + drains == 0:
        return None
    eng, H, S = view.config["engine"], view.config["work"]["chain_frames"], view.config["work"]["stages"]
    n_bytes = steps * roofline.walk_step_bytes(view.keys, eng, H, S)
    if drains:
        n_bytes += drains * roofline.walk_drain_bytes(view.keys, eng, S)
    n_ops = view.trace_hops * roofline.ops_per_hop(eng)
    return 100.0 * roofline.least_seconds(n_bytes, n_ops, view.kind) / seconds
