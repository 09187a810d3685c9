"""Device milliseconds a batch in every kernel but the port's own CUDA
libraries (the eager engine step's phases: ``engine/matcher.py``,
``ops/slab.py``, ``ops/decode.py``'s compaction), from the trace."""

from portbench.metrics import kernels


def read(view):
    if view.trace is None or not view.trace.count(kernels.is_library):
        return None
    return view.trace.seconds(kernels.is_library) / view.trace_batches * 1e3
