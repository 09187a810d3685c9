"""The share of the processor's decode phase in its ``decode.wait`` span
(from a batch's decode to its hit count on the host: its wait on the
card), over the whole run: ``layers["spans"]["decode.wait"]`` over
``phases["decode"]`` of the processor's snapshot once the window closed,
so warm-up and traced batches weigh alike in both.  None where the
program has no such span."""


def read(view):
    wait = view.snapshot.get("layers", {}).get("spans", {}).get("decode.wait")
    decode = view.snapshot.get("phases", {}).get("decode")
    if wait is None or decode is None or decode["sum"] <= 0:
        return None
    return 100.0 * wait["sum"] / decode["sum"]
