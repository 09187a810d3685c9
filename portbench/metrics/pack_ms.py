"""Host milliseconds a batch in the processor's pack phase (lane mapping
and column packing: ``runtime/processor.py: process_columns``,
``native/``), from its ``pack_seconds``, over the window's untraced
batches."""


def read(view):
    if view.host_batches <= 0:
        return None
    return view.host_phase_s["pack_seconds"] / view.host_batches * 1e3
