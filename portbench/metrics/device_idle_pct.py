"""The share of the traced batches' wall time in which no operation ran on
the card: 100 (1 - busy / window), busy the union of the trace's kernels,
copies and fills."""


def read(view):
    if view.trace is None or view.trace_window_s <= 0 or view.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - view.trace.busy_s / view.trace_window_s)
