"""Host milliseconds a batch in the processor's decode phase (a batch's
wait on the card for its hit count, the pull of its match rows and the
making of their Events: ``runtime/processor.py: _decode``), from its
``decode_seconds``, over the window's untraced batches."""


def read(view):
    if view.host_batches <= 0:
        return None
    return view.host_phase_s["decode_seconds"] / view.host_batches * 1e3
