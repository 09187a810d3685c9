"""Device-side match compaction — shrink the decode transfer.

A scan's raw outputs are ``[K, T, R, W]``, nearly all empty.  The hit rows
(``count > 0``) move to the front of a fixed budget of rows, in
``(k, t, r)`` order, with the ``(k, t, r, count)`` metadata the host
decode needs for arrival-order emission, so the host pulls rows in
proportion to the match count.
"""

from __future__ import annotations

import torch

I32 = torch.int32


def compact_matches(out, budget: int):
    """``StepOutput [K, T, R, ...]`` -> globally compacted match rows.

    Returns ``(stage [G, W], off [G, W], count [G], k [G], t [G], r [G],
    n_hits [], overflow [] bool)``: hit rows first in ``(k, t, r)`` order,
    ``count == 0`` rows past the hit count; ``G = min(budget, K*T*R)``.
    Hits past ``G`` are dropped and ``overflow`` is set, so the caller
    falls back to the full pull.
    """
    K, T, R = out.count.shape
    W = out.stage.shape[-1]
    N = K * T * R
    G = min(budget, N)
    dev = out.count.device
    count = out.count.reshape(N)
    hit = count > 0
    n_hits = hit.sum(dtype=I32)
    # Exclusive rank of each hit; non-hits and hits past G land in the
    # dump row G, cut off below.
    rank = torch.cumsum(hit.to(I32), dim=0) - 1
    dst = torch.where(hit & (rank < G), rank, G).long()

    def scat(flat):
        buf = torch.zeros((G + 1,) + flat.shape[1:], dtype=flat.dtype, device=dev)
        idx = dst.reshape((N,) + (1,) * (flat.dim() - 1)).expand(flat.shape)
        return buf.scatter_(0, idx, flat)[:G]

    n = torch.arange(N, dtype=I32, device=dev)
    return (
        scat(out.stage.reshape(N, W)),
        scat(out.off.reshape(N, W)),
        scat(count),
        scat(n // (T * R)),
        scat((n // R) % T),
        scat(n % R),
        n_hits,
        n_hits > G,
    )
