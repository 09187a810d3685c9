"""The yardstick's peaks and the walk pass's (B1's) work, counted from
shapes.

The rule is ``chip_smoke.py: bound`` (chip_smoke.py:1072-1085, with its
constants at :236-237), copied: every tensor a call reads crosses device
memory once and every tensor it writes once, over the card's memory rate,
against its hops' compares (``2 E + 3 MP D`` a hop) over the 32-bit rate;
the least time is the larger of the two.  Here the tensors are counted
from the configuration's shapes, not read off the program, so the same
work is counted whatever implements it: the slab leaves the instance reads
and writes (``ops/walk_kernel.py: mode_fields``), its walker queue
(``R H`` branch frames, ``R`` removals and ``R`` extractions a lane, ``H``
the query's chain frames), its puts (``R H`` a lane) and its outputs.
"""

from __future__ import annotations

from typing import Dict, Optional

#: Published peaks of the cards the benchmark runs on (NVIDIA's H100 SXM
#: data sheet, dense, at the full 700 W power limit): device memory bytes/s
#: and 32-bit operations/s outside the tensor cores.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "int32_ops_per_s": 67e12},
}

I32, BOOL = 4, 1


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named ``kind``, or None for a card not in the
    table (its roofline shares are then not reported)."""
    return PEAKS.get(kind)


def slab_bytes(K: int, E: int, MP: int, D: int, two_tier: bool, attribution_stages: int,
               drain: bool) -> int:
    """One copy of the slab leaves a walk-pass instance reads and writes."""
    n = 4 * K * E + 3 * K * E * MP + K * E * MP * D  # stage off refs npreds; pstage poff pvlen; pver
    n += 6 * K  # missing trunc full_drops pred_drops walk_hops extract_hops
    if two_tier:
        n += 4 * K  # hot_hits hot_misses overflow_walks demotions
    if drain:
        n += K  # drain_hops
    n += K * attribution_stages  # stage_hops
    return I32 * n


def walk_step_bytes(K: int, eng: Dict, H: int, stages: int) -> int:
    """Bytes one in-step walk-pass call moves: the slab in and out, the
    walker queue, the puts, the event offsets and the extraction rows."""
    R, E, MP, D, W = (eng[k] for k in ("max_runs", "slab_entries", "slab_preds",
                                       "dewey_depth", "max_walk"))
    S = stages if eng.get("stage_attribution") else 0
    slab = slab_bytes(K, E, MP, D, bool(eng.get("slab_hot_entries")), S, False)
    NW, P = R * H + 2 * R, R * H
    walkers = K * NW * (3 * BOOL + 3 * I32 + D * I32)  # en remove out; stage off vlen; ver
    puts = K * P * (2 * BOOL + 4 * I32 + D * I32)  # en first; cur prev prev_off vlen; ver
    outs = K * R * (2 * W + 1) * I32  # stage, off [K, R, W]; count [K, R]
    return 2 * slab + walkers + puts + K * I32 + outs


def walk_drain_bytes(K: int, eng: Dict, stages: int) -> int:
    """Bytes one drain-pass call moves: the slab in and out, the handle
    ring and the drained rows."""
    E, MP, D, W, HB = (eng[k] for k in ("slab_entries", "slab_preds", "dewey_depth",
                                        "max_walk", "handle_ring"))
    S = stages if eng.get("stage_attribution") else 0
    slab = slab_bytes(K, E, MP, D, bool(eng.get("slab_hot_entries")), S, True)
    ring = K * HB * (3 * BOOL + 3 * I32 + D * I32)  # pending ones ones; stage off vlen; ver
    outs = K * HB * (2 * W + 1) * I32
    return 2 * slab + ring + outs


def ops_per_hop(eng: Dict) -> int:
    """32-bit operations a walk hop needs: its key compares and the
    compatibility check of every pointer's version."""
    return 2 * eng["slab_entries"] + 3 * eng["slab_preds"] * eng["dewey_depth"]


def least_seconds(n_bytes: float, n_ops: float, kind: str) -> Optional[float]:
    """The least time the card ``kind`` could take for the work: the larger
    of its bytes over the memory rate and its operations over the 32-bit
    rate; None for a card not in the table."""
    pk = peaks(kind)
    if pk is None:
        return None
    return max(n_bytes / pk["hbm_bytes_per_s"], n_ops / pk["int32_ops_per_s"])
