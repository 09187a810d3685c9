"""Device milliseconds a batch in the walk pass (B1, ``csrc/walk_pass.cu``:
every instance, in-step and drain), from the trace's kernels by name."""

from portbench.metrics import kernels


def read(view):
    if view.trace is None or not view.trace.count(kernels.is_walk_pass):
        return None
    return view.trace.seconds(kernels.is_walk_pass) / view.trace_batches * 1e3
