"""Host milliseconds a batch in the processor's event GC (the read of the
device state and the loop over every lane: ``runtime/processor.py:
_gc_events``), from its ``gc_seconds``, over the window's untraced
batches: one GC in ``gc_events_interval`` batches, averaged over all."""


def read(view):
    if view.host_batches <= 0:
        return None
    return view.host_phase_s["gc_seconds"] / view.host_batches * 1e3
