"""Kernels the traced batches launched an engine step: the trace's
kernels over those batches' steps, taken as the run's steps a batch (the
processor's ``layers["counters"]["steps"]`` over its ``batches``, from its
snapshot once the window closed) times the traced batches.  None without
kernels in the trace (the CPU) or where the program has no step count."""


def read(view):
    steps = view.snapshot.get("layers", {}).get("counters", {}).get("steps")
    batches = view.snapshot.get("batches")
    if view.trace is None or not steps or not batches or view.trace_batches <= 0:
        return None
    kernels = view.trace.count(lambda name: True)
    if not kernels:
        return None
    return kernels / (view.trace_batches * steps / batches)
