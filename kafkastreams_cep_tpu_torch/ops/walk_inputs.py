"""Synthetic slab-phase inputs for holding the walk-pass kernel against its
plain version: random slabs, walker queues and put ops made by numpy from a
seed, in the engine's layout.

Each lane's slab is a DAG the engine could have built: live entries have
unique ``(stage, off)`` keys, pointers reach strictly older events (or are
null run origins, or dangle so lookups miss), versions are short Dewey
vectors over small digits so compatibility both holds and fails, and the
storage behind ``npreds`` holds garbage the passes must ignore.  Some lanes
are full, so allocations drop.  The walker queue has the engine's
segments: ``R*H`` branch walkers, ``R`` removals, ``R`` extractions
(``out_base = R*H + R``, ``out_rows = R``); the puts are ``R*H`` ops on the
current event.

With ``hot_entries > 0`` about half the lanes hold a full hot tier
(slots ``[0, hot_entries)``, the oldest offsets) beside free overflow
rows, and their current event's offset lies above every live offset (the
engine's invariant), so the step's creations demote hot entries.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from kafkastreams_cep_tpu_torch.ops.slab import COUNTERS, PutOps, SlabState

NUM_STAGES = 4


def _version(rng, D, n):
    """``n`` random versions ``[n, D]`` with lengths ``[n]`` in 1..3; above
    ``D = 32`` half of them are long instead (lengths ``D - 2`` to ``D``, one
    shared prefix and two random last digits), so that compatibility is
    decided by digits past the 32nd."""
    vlen = rng.integers(1, min(3, D) + 1, size=n).astype(np.int32)
    ver = rng.integers(0, 2, size=(n, D)).astype(np.int32)
    ver[:, 0] = 1
    if D > 32:
        long_ = rng.random(n) < 0.5
        vlen[long_] = rng.integers(D - 2, D + 1, size=int(long_.sum()))
        prefix = (np.arange(D) % 3 == 0).astype(np.int32)
        last = np.arange(D)[None, :] >= vlen[:, None] - 2
        ver[long_] = np.where(last[long_], ver[long_], prefix[None, :])
    ver[np.arange(D)[None, :] >= vlen[:, None]] = 0
    return ver, vlen


def random_inputs(seed: int, K: int, E: int, MP: int, D: int, R: int,
                  H: int, hot_entries: int = 0) -> Dict[str, np.ndarray]:
    """One step's slab-phase inputs for ``K`` lanes, as numpy arrays."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    PW, PP = R * (H + 2), R * H
    out: Dict[str, np.ndarray] = {
        "stage": np.full((K, E), -1, i32), "off": np.full((K, E), -1, i32),
        "refs": np.zeros((K, E), i32), "npreds": np.zeros((K, E), i32),
        "pstage": rng.integers(-1, NUM_STAGES, size=(K, E, MP)).astype(i32),
        "poff": rng.integers(-1, 8, size=(K, E, MP)).astype(i32),
        "pver": rng.integers(0, 3, size=(K, E, MP, D)).astype(i32),
        "pvlen": rng.integers(0, D + 1, size=(K, E, MP)).astype(i32),
    }
    ev_off = np.zeros(K, i32)
    for k in range(K):
        hot_full = bool(hot_entries) and rng.random() < 0.5
        if hot_full:
            EH = hot_entries
            n_live = EH + int(rng.integers(0, E - EH))  # overflow not full
            rows = np.r_[np.arange(EH), EH + rng.permutation(E - EH)[:n_live - EH]]
        else:
            n_live = E if rng.random() < 0.15 else int(rng.integers(E // 4, E))
            rows = rng.permutation(E)[:n_live]
        # Keys: two stages per offset, so offsets repeat but keys do not.
        offs = np.arange(n_live, dtype=i32) // 2
        stages = (np.arange(n_live, dtype=i32) % 2) + rng.integers(0, 2)
        out["stage"][k, rows] = stages
        out["off"][k, rows] = offs
        out["refs"][k, rows] = rng.integers(0, 4, size=n_live)
        for i, e in enumerate(rows):
            n = int(rng.integers(0, MP + 1)) if rng.random() < 0.3 else int(
                rng.integers(1, min(3, MP) + 1)
            )
            # Past 32 slots a row, some rows fill past the first group and
            # hide it behind versions no walker is compatible with, so that
            # walks take later groups' pointers.
            hide = MP > 32 and rng.random() < 0.3
            if hide:
                n = int(rng.integers(33, MP + 1))
            out["npreds"][k, e] = n
            older = np.flatnonzero(offs < offs[i])
            for s in range(n):
                r = rng.random()
                if r < 0.2 or older.size == 0:
                    ps, po = -1, -1  # run origin
                elif r < 0.25:
                    ps, po = NUM_STAGES + 1, int(offs[i]) - 1  # dangling
                else:
                    j = int(rng.choice(older))
                    ps, po = int(stages[j]), int(offs[j])
                out["pstage"][k, e, s] = ps
                out["poff"][k, e, s] = po
            ver, vlen = _version(rng, D, n)
            if hide:
                ver[:32], vlen[:32] = 2, 1
            out["pver"][k, e, :n] = ver
            out["pvlen"][k, e, :n] = vlen
        last = int(offs.max()) if n_live else 0
        ev_off[k] = last if not hot_full and rng.random() < 0.3 else last + 1

        def live_key():
            if n_live and rng.random() < 0.9:
                e = int(rng.choice(rows))
                return out["stage"][k, e], out["off"][k, e]
            return rng.integers(0, NUM_STAGES), rng.integers(0, 8)

        for name in ("w_stage", "w_off", "p_pstage", "p_poff"):
            out.setdefault(name, np.zeros((K, PW if name[0] == "w" else PP), i32))
        for p in range(PW):
            out["w_stage"][k, p], out["w_off"][k, p] = live_key()
        for p in range(PP):
            out["p_pstage"][k, p], out["p_poff"][k, p] = live_key()
    out["w_en"] = rng.random((K, PW)) < 0.5
    w_ver, w_vlen = _version(rng, D, K * PW)
    out["w_ver"] = w_ver.reshape(K, PW, D)
    out["w_vlen"] = w_vlen.reshape(K, PW)
    out["w_remove"] = np.broadcast_to(np.arange(PW) >= PP, (K, PW)).copy()
    out["w_out"] = np.broadcast_to(np.arange(PW) >= PP + R, (K, PW)).copy()
    out["p_en"] = rng.random((K, PP)) < 0.3
    out["p_first"] = rng.random((K, PP)) < 0.3
    out["p_cur"] = rng.integers(0, NUM_STAGES, size=(K, PP)).astype(i32)
    p_ver, p_vlen = _version(rng, D, K * PP)
    out["p_ver"] = p_ver.reshape(K, PP, D)
    out["p_vlen"] = p_vlen.reshape(K, PP)
    out["ev_off"] = ev_off
    for c in COUNTERS:
        out[c] = rng.integers(0, 5, size=K).astype(i32)
    return out


def as_tensors(arrs: Dict[str, np.ndarray], device, stage_hops: int = 0):
    """``(slab, walkers, put_ops, ev_off)`` on ``device``: ``walkers`` is the
    ``(en, stage, off, ver, vlen, is_remove, want_out)`` queue."""
    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    K = arrs["stage"].shape[0]
    slab = SlabState(
        **{f: t(arrs[f]) for f in SlabState._fields if f != "stage_hops"},
        stage_hops=torch.zeros((K, stage_hops), dtype=torch.int32, device=device),
    )
    walkers = tuple(
        t(arrs[f]) for f in
        ("w_en", "w_stage", "w_off", "w_ver", "w_vlen", "w_remove", "w_out")
    )
    puts = PutOps(
        en=t(arrs["p_en"]), first=t(arrs["p_first"]), cur_stage=t(arrs["p_cur"]),
        prev_stage=t(arrs["p_pstage"]), prev_off=t(arrs["p_poff"]),
        ver=t(arrs["p_ver"]), vlen=t(arrs["p_vlen"]),
    )
    return slab, walkers, puts, t(arrs["ev_off"])
