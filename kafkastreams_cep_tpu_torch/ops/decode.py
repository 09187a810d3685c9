"""Device-side match compaction — shrink the decode transfer.

A scan's raw outputs are ``[K, T, R, W]`` (a drain's ``[K, HB, W]``),
nearly all empty.  The hit rows (``count > 0``) move to the front of a
fixed budget of rows, in ``(k, t, r)`` (``(k, h)``) order, with the
metadata the host decode needs for arrival-order emission, so the host
pulls rows in proportion to the match count.
"""

from __future__ import annotations

import torch

I32 = torch.int32


def _compact(count, budget: int):
    """The hit mask's compaction: ``(scat, n_hits, G)``, where ``scat``
    moves each row of a ``[N, ...]`` tensor to its hit rank (non-hits and
    hits past ``G`` to a dump row that is cut off)."""
    N = count.shape[0]
    G = min(budget, N)
    hit = count > 0
    n_hits = hit.sum(dtype=I32)
    rank = torch.cumsum(hit.to(I32), dim=0) - 1
    dst = torch.where(hit & (rank < G), rank, G).long()

    def scat(flat):
        buf = torch.zeros((G + 1,) + flat.shape[1:], dtype=flat.dtype,
                          device=flat.device)
        idx = dst.reshape((N,) + (1,) * (flat.dim() - 1)).expand(flat.shape)
        return buf.scatter_(0, idx, flat)[:G]

    return scat, n_hits, G


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
    count = out.count.reshape(N)
    scat, n_hits, G = _compact(count, budget)
    n = torch.arange(N, dtype=I32, device=count.device)
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


def compact_drained(dout, budget: int):
    """``DrainOutput [K, HB, ...]`` -> globally compacted match rows, the
    drain's analog of :func:`compact_matches`.

    Returns ``(stage [G, W], off [G, W], count [G], seq [G], row [G],
    k [G], n_hits [], overflow [] bool)`` with hit rows first in ``(k, h)``
    order; ``G = min(budget, K*HB)``."""
    K, HB = dout.count.shape
    W = dout.stage.shape[-1]
    N = K * HB
    count = dout.count.reshape(N)
    scat, n_hits, G = _compact(count, budget)
    n = torch.arange(N, dtype=I32, device=count.device)
    return (
        scat(dout.stage.reshape(N, W)),
        scat(dout.off.reshape(N, W)),
        scat(count),
        scat(dout.seq.reshape(N)),
        scat(dout.row.reshape(N)),
        scat(n // HB),
        n_hits,
        n_hits > G,
    )
