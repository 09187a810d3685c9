"""Dewey version renormalization — bounded-width versions on unbounded
streams, per lane.

The PyTorch counterpart of ``kafkastreams_cep_tpu/ops/renorm.py``, whose
module note carries the argument: between scans, interior positions that
are provably ``0`` in *every* version crossing them are deleted from all of
a lane's run and pointer versions at once, which leaves every
``is_compatible`` outcome unchanged.  A position ``k`` is deletable when

1. every live pointer version ``p`` has ``len(p) <= k``, or
   ``p[k] == 0 and len(p) >= k + 2``;
2. every alive non-seed run version has ``len(v) >= k + 2 and v[k] == 0``;
3. no crossing version shares an alive seed run's first digit.
"""

from __future__ import annotations

import torch

from kafkastreams_cep_tpu_torch.ops.slab import SlabState

I32 = torch.int32


def safe_positions(
    run_ver, run_vlen, run_alive, run_seed, pver, pvlen, ptr_live
):
    """The ``[K, D]`` bool mask of deletable positions.

    ``run_ver [K, R, D]``, ``run_vlen [K, R]``, ``run_alive [K, R]``,
    ``run_seed [K, R]`` (alive & never consumed), ``pver [K, N, D]``,
    ``pvlen [K, N]``, ``ptr_live [K, N]`` (entry live & slot < npreds).
    """
    D = run_ver.shape[-1]
    idx = torch.arange(D, dtype=I32, device=run_ver.device)
    nonseed = run_alive & ~run_seed

    def cross_ok(ver, vlen, mask):
        # Versions in ``mask`` crossing k: digit 0 at k and len >= k + 2.
        crossing = mask[..., None] & (vlen[..., None] > idx)
        ok = (ver == 0) & (vlen[..., None] >= idx + 2)
        return ~(crossing & ~ok).any(dim=1)  # [K, D]

    run_short = (nonseed[..., None] & (run_vlen[..., None] <= idx)).any(dim=1)
    run_ok = cross_ok(run_ver, run_vlen, nonseed) & ~run_short
    ptr_ok = cross_ok(pver, pvlen, ptr_live)

    # (3): a crossing version whose first digit equals some alive seed's.
    seed_d0 = run_ver[..., 0]  # [K, R]

    def shares_seed_digit(ver):  # [K, M, D] -> [K, M]
        return (
            run_seed[:, :, None] & (seed_d0[:, :, None] == ver[:, None, :, 0])
        ).any(dim=1)

    def clash(ver, vlen, mask):
        crossing = mask[..., None] & (vlen[..., None] > idx)  # [K, M, D]
        return (shares_seed_digit(ver)[..., None] & crossing).any(dim=1)

    return (
        run_ok
        & ptr_ok
        & ~clash(run_ver, run_vlen, run_alive)
        & ~clash(pver, pvlen, ptr_live)
    )


def delete_positions(ver, vlen, safe):
    """Stable-compact the ``safe [K, D]`` positions out of ``ver [K, ..., D]``.

    Positions ``k`` with ``safe[k] and k < vlen`` are removed; later digits
    shift down, the tail zero-fills and ``vlen`` shrinks by the count."""
    D = ver.shape[-1]
    idx = torch.arange(D, dtype=I32, device=ver.device)
    safe = safe.reshape((safe.shape[0],) + (1,) * (ver.dim() - 2) + (D,))
    drop = safe & (idx < vlen[..., None])
    keep = ~drop
    tgt = torch.where(keep, torch.cumsum(keep.to(I32), dim=-1) - 1, D).long()
    buf = torch.zeros(ver.shape[:-1] + (D + 1,), dtype=ver.dtype, device=ver.device)
    buf.scatter_(-1, tgt, ver)
    return buf[..., :D], vlen - drop.sum(dim=-1, dtype=I32)


def renorm_lane(run_ver, run_vlen, alive, id_pos, slab: SlabState):
    """Renormalize every lane's run and pointer versions; returns
    ``(run_ver, run_vlen, slab, n_deleted [K])``."""
    K, E, MP, D = slab.pver.shape
    seed = alive & (id_pos < 0)
    slot_live = (slab.stage >= 0)[:, :, None] & (
        torch.arange(MP, device=slab.stage.device) < slab.npreds[:, :, None]
    )
    safe = safe_positions(
        run_ver, run_vlen, alive, seed,
        slab.pver.reshape(K, E * MP, D), slab.pvlen.reshape(K, E * MP),
        slot_live.reshape(K, E * MP),
    )
    new_rv, new_rl = delete_positions(run_ver, run_vlen, safe)
    new_pv, new_pl = delete_positions(slab.pver, slab.pvlen, safe)
    # Only live rows move; dead rows stay byte-identical.
    rv = torch.where(alive[..., None], new_rv, run_ver)
    rl = torch.where(alive, new_rl, run_vlen)
    slab = slab._replace(
        pver=torch.where(slot_live[..., None], new_pv, slab.pver),
        pvlen=torch.where(slot_live, new_pl, slab.pvlen),
    )
    return rv, rl, slab, safe.sum(dim=-1, dtype=I32)
