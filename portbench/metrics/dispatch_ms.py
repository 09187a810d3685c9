"""Host milliseconds a batch in the processor's dispatch phase (the scan
loop's launches of every step: ``parallel/batch.py: scan``, and the sweep
when due), from its ``dispatch_seconds``, over the window's untraced
batches."""


def read(view):
    if view.host_batches <= 0:
        return None
    return view.host_phase_s["dispatch_seconds"] / view.host_batches * 1e3
