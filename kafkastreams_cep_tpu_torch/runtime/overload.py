"""Overload control: the SLO-burn-driven brownout ladder.

The counterpart of ``kafkastreams_cep_tpu/runtime/overload.py``, a copy
over this package's logger: the policy, the ladder table, the shed stride
and the controller are the same, and :meth:`OverloadController.to_state`
keeps the JAX package's format, so a checkpoint's ``extra["overload"]``
cross-loads both ways.

Sustained offered load above device capacity has no controlled failure
mode by itself: the reorder buffer and handle ring grow until eviction and
overflow counters trip, the SLO burn rate rises, and nothing acts on it.
This module closes the loop between the sensors the runtime already has
(``SLOTracker`` burn rate, reorder hold depth/age, queue-segment latency,
deferred drain backlog) and the actuators it already has (drain cadence,
telemetry depth, per-tenant admission buckets, ingest-door shedding)
through a small deterministic state machine:

=====  =============================================================
level  degradation
=====  =============================================================
L0     healthy — no intervention
L1     widen drain cadence; defer non-essential telemetry reads
       (per-lane/per-key device gathers)
L2     tighten per-tenant admission token buckets proportionally to
       each tenant's measured cost share (heavy hitters squeezed
       hardest, zero-share tenants untouched)
L3     shed admissible records at ingest with the typed
       ``overload_shed`` dead-letter reason — every drop stays in the
       loss ledger, so ``offered == admitted + shed + dead_lettered``
       reconciles exactly
L4     emergency — checkpoint, flush pinned drains, refuse all new
       admissions while the backlog clears
=====  =============================================================

**Determinism.**  The controller itself is pure host state: the pressure
scalar is the max of the normalized signals, levels move one step per
tick, and entry/exit each require a streak of consecutive agreeing ticks
(with ``exit_at < enter_at`` hysteresis so the ladder never flaps on a
boundary).  Shedding at L3+ uses a within-batch Bresenham stride over
the *admissible* records (validation and replay dedup run first), so the
same batch always sheds the same records — a replayed crash admits the
identical subset.

**Durability.**  The supervisor owns every transition: it fires the
``overload.enter`` / ``overload.exit`` failpoints, applies the
actuators, then pins the new level with an immediate checkpoint.  A pin
failure reverts the level and actuators (counted in
``overload_transition_failures``), preserving the invariant that the
in-memory level always equals the last-pinned level — so restore,
migration, and evacuation rewire the actuators from
:meth:`OverloadController.to_state` and a replayed crash lands in the
same level.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("runtime.overload")

#: Number of brownout levels above L0.
MAX_LEVEL = 4


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """Thresholds, hysteresis, and per-level actuator settings.

    Signal references (a raw signal at its reference reads as pressure
    1.0):

    ``burn_ref``      — SLO burn rate (1.0 = burning exactly at budget).
    ``hold_ref``      — reorder-buffer occupancy as a fraction of
                        ``reorder_depth``.
    ``hold_age_ref``  — oldest-held-record event-time age as a multiple
                        of the grace window.
    ``queue_ref``     — ingest-queue segment p99, seconds.
    ``ring_ref``      — deferred drain bundles outstanding (the host
                        proxy for handle-ring occupancy; lazy extraction
                        parks match handles until the drain).  Keep this
                        comfortably above ``max(drain_widen)`` — the
                        widened cadence *creates* deferred bundles, and a
                        tight reference would let the L1 actuator feed
                        its own escalation.

    The ladder: pressure ``>= enter_at[L]`` for ``enter_streak``
    consecutive ticks enters level L+1 from L; pressure ``<=
    exit_at[L-1]`` for ``exit_streak`` ticks drops back to L-1.
    ``exit_at`` sits below ``enter_at`` (hysteresis) and the exit streak
    is longer than the entry streak, so recovery is deliberate and the
    ladder cannot oscillate on a noisy boundary.

    Actuators, indexed by level 0..4:

    ``drain_widen``      — multiplier on the processor's base
                           ``drain_interval``.
    ``admission_scale``  — per-tenant token-bucket squeeze handed to
                           :meth:`AdmissionLimiter.set_pressure` (1.0 =
                           open).
    ``shed_fraction``    — fraction of admissible records shed at the
                           ingest door (1.0 at L4 = refuse everything).
    """

    burn_ref: float = 1.0
    hold_ref: float = 0.5
    hold_age_ref: float = 4.0
    queue_ref: float = 1.0
    ring_ref: float = 16.0
    enter_at: Tuple[float, ...] = (1.0, 2.0, 4.0, 8.0)
    exit_at: Tuple[float, ...] = (0.5, 1.0, 2.0, 4.0)
    enter_streak: int = 2
    exit_streak: int = 4
    drain_widen: Tuple[int, ...] = (1, 4, 4, 8, 8)
    admission_scale: Tuple[float, ...] = (1.0, 1.0, 0.5, 0.25, 0.0)
    shed_fraction: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.5, 1.0)

    def __post_init__(self):
        n = MAX_LEVEL
        if len(self.enter_at) != n or len(self.exit_at) != n:
            raise ValueError(
                f"enter_at/exit_at need {n} thresholds (L1..L{n}), got "
                f"{self.enter_at!r} / {self.exit_at!r}"
            )
        for lvl in range(n):
            if self.exit_at[lvl] >= self.enter_at[lvl]:
                raise ValueError(
                    "hysteresis requires exit_at < enter_at at every "
                    f"level, got exit {self.exit_at[lvl]} >= enter "
                    f"{self.enter_at[lvl]} at L{lvl + 1}"
                )
        for name in ("drain_widen", "admission_scale", "shed_fraction"):
            if len(getattr(self, name)) != n + 1:
                raise ValueError(
                    f"{name} needs {n + 1} entries (L0..L{n}), got "
                    f"{getattr(self, name)!r}"
                )
        if self.enter_streak < 1 or self.exit_streak < 1:
            raise ValueError("streaks must be >= 1")


#: level -> (trigger, action, blast radius, exit condition) — drives the
#: README "Overload & backpressure" ladder table; the README embeds
#: :func:`ladder_table_markdown` output verbatim (pinned by
#: tests/test_overload.py).
LADDER_DOCS: Tuple[Tuple[str, str, str, str, str], ...] = (
    (
        "L0",
        "—",
        "none (healthy)",
        "none",
        "—",
    ),
    (
        "L1",
        "pressure >= `enter_at[0]` for `enter_streak` ticks",
        "widen drain cadence (`drain_widen`); defer per-lane/per-key "
        "telemetry gathers",
        "emit latency only — no record is dropped or reordered",
        "pressure <= `exit_at[0]` for `exit_streak` ticks",
    ),
    (
        "L2",
        "pressure >= `enter_at[1]` for `enter_streak` ticks",
        "tighten per-tenant admission buckets by `admission_scale`, "
        "proportional to measured cost share",
        "heavy-hitter tenants throttled (typed `tenant_quota` sheds); "
        "compliant tenants untouched",
        "pressure <= `exit_at[1]` for `exit_streak` ticks",
    ),
    (
        "L3",
        "pressure >= `enter_at[2]` for `enter_streak` ticks",
        "shed `shed_fraction` of admissible records at ingest "
        "(deterministic within-batch stride), typed `overload_shed`; "
        "flight-recorder dump on entry",
        "all tenants lose a bounded, fully-accounted fraction",
        "pressure <= `exit_at[2]` for `exit_streak` ticks",
    ),
    (
        "L4",
        "pressure >= `enter_at[3]` for `enter_streak` ticks",
        "emergency: checkpoint + flush pinned drains on entry, refuse "
        "all new admissions (typed `overload_shed`)",
        "total admission stop — backlog drains, nothing new enters",
        "pressure <= `exit_at[3]` for `exit_streak` ticks",
    ),
)


def ladder_table_markdown() -> str:
    """Render the brownout ladder table (README "Overload &
    backpressure") from :data:`LADDER_DOCS` — the one place the ladder
    is documented.  The README embeds this output verbatim."""
    rows = [
        ("level", "trigger", "action", "blast radius", "exit condition"),
        ("---", "---", "---", "---", "---"),
    ]
    for level, trigger, action, blast, exit_cond in LADDER_DOCS:
        rows.append((f"**{level}**", trigger, action, blast, exit_cond))
    return "\n".join("| " + " | ".join(r) + " |" for r in rows)


def shed_keep(index: int, admit_fraction: float) -> bool:
    """Whether the ``index``-th admissible record of a batch survives a
    Bresenham stride at ``admit_fraction`` (0.0 = refuse all, 1.0 =
    admit all).  Pure integer-order arithmetic on the within-batch
    index, so replaying the same batch sheds the same records."""
    if admit_fraction >= 1.0:
        return True
    if admit_fraction <= 0.0:
        return False
    return math.floor((index + 1) * admit_fraction) > math.floor(
        index * admit_fraction
    )


class OverloadController:
    """The deterministic ladder state machine.

    The controller never touches the processor: the supervisor gathers
    the signals, calls :meth:`tick` for a proposal, runs the transition
    protocol (failpoints, actuators, pin checkpoint), and then either
    :meth:`commit`\\ s or :meth:`abort`\\ s.  Everything here is plain
    host state that rides the checkpoint header
    (:meth:`to_state`/:meth:`from_state`).
    """

    def __init__(self, policy: Optional[OverloadPolicy] = None):
        self.policy = policy or OverloadPolicy()
        self.level = 0
        self.transitions = 0
        self.transition_failures = 0
        self.shed_total = 0  # records shed while at L3+ (telemetry)
        #: The processor's un-widened drain_interval — ``drain_widen``
        #: multiplies this, and it must be durable: a checkpoint taken
        #: while browned out records the *widened* interval, so a restore
        #: cannot recover the base from the processor.
        self.base_drain = 1
        #: (scale, shares) applied to the admission limiter at the last
        #: L2+ commit — replayed onto the limiter after restore so the
        #: squeeze survives crashes.
        self.admission_pressure: Tuple[float, Dict[str, float]] = (1.0, {})
        self.last_pressure = 0.0
        self._enter_streak = 0
        self._exit_streak = 0
        # In-flight transition: (level, admission_pressure) to restore on
        # abort.  Transient — never serialized (a transition is pinned or
        # it never happened).
        self._prev: Optional[Tuple[int, Tuple[float, Dict[str, float]]]] = (
            None
        )

    # -- pressure -----------------------------------------------------------

    def pressure(self, signals: Dict[str, float]) -> float:
        """Collapse the raw signal dict to the pressure scalar: the max
        of each signal normalized by its policy reference.  Missing
        signals read 0 (a processor without a guard or ledger simply
        contributes no pressure)."""
        p = self.policy

        def norm(key: str, ref: float) -> float:
            v = float(signals.get(key, 0.0) or 0.0)
            return v / ref if ref > 0 else 0.0

        return max(
            norm("burn_rate", p.burn_ref),
            norm("hold_frac", p.hold_ref),
            norm("hold_age_frac", p.hold_age_ref),
            norm("queue_p99_s", p.queue_ref),
            norm("ring_depth", p.ring_ref),
        )

    # -- ladder -------------------------------------------------------------

    def tick(self, signals: Dict[str, float]) -> Optional[Tuple[int, int]]:
        """One observation: update streaks and return a one-step
        transition proposal ``(from_level, to_level)``, or None.  Does
        NOT move the level — the supervisor commits (or reverts) after
        running the transition protocol, so a crash mid-transition
        leaves the previous level authoritative."""
        p = self.policy
        pressure = self.pressure(signals)
        self.last_pressure = pressure
        lvl = self.level
        if lvl < MAX_LEVEL and pressure >= p.enter_at[lvl]:
            self._enter_streak += 1
        else:
            self._enter_streak = 0
        if lvl > 0 and pressure <= p.exit_at[lvl - 1]:
            self._exit_streak += 1
        else:
            self._exit_streak = 0
        if self._enter_streak >= p.enter_streak:
            return (lvl, lvl + 1)
        if self._exit_streak >= p.exit_streak:
            return (lvl, lvl - 1)
        return None

    def begin(self, to_level: int) -> None:
        """Tentatively adopt ``to_level`` so the supervisor's pin
        checkpoint serializes the NEW level (the invariant: the
        in-memory level always equals the last-pinned level).  Must be
        followed by :meth:`commit` (pin succeeded) or :meth:`abort`
        (failpoint or pin failure)."""
        if not 0 <= to_level <= MAX_LEVEL:
            raise ValueError(f"level out of range: {to_level}")
        self._prev = (
            self.level, self.admission_pressure, self._enter_streak,
            self._exit_streak,
        )
        self.level = int(to_level)
        # Streaks reset HERE (not in commit) so the pin checkpoint that
        # runs between begin and commit serializes the post-commit
        # state: a crash right after the pin resumes with the same
        # streaks a crash-free run would carry — the next transition
        # fires on the same tick either way.
        self._enter_streak = 0
        self._exit_streak = 0

    def commit(self) -> None:
        """The transition protocol succeeded (actuators applied, level
        pinned): keep the new level and reset both streaks."""
        frm = self._prev[0] if self._prev is not None else self.level
        logger.info(
            "overload transition L%d -> L%d (pressure %.3f)", frm,
            self.level, self.last_pressure,
        )
        self._prev = None
        self.transitions += 1

    def abort(self) -> None:
        """The transition protocol failed (failpoint or pin-checkpoint
        failure): the previous level stays authoritative.  Streaks are
        restored at threshold, so the next tick re-proposes while the
        pressure condition still holds."""
        if self._prev is not None:
            (
                self.level, self.admission_pressure, self._enter_streak,
                self._exit_streak,
            ) = self._prev
            self._prev = None
        self.transition_failures += 1

    # -- actuator settings --------------------------------------------------

    def drain_widen(self, level: Optional[int] = None) -> int:
        lvl = self.level if level is None else level
        return int(self.policy.drain_widen[lvl])

    def telemetry_defer(self, level: Optional[int] = None) -> bool:
        lvl = self.level if level is None else level
        return lvl >= 1

    def admission_scale(self, level: Optional[int] = None) -> float:
        lvl = self.level if level is None else level
        return float(self.policy.admission_scale[lvl])

    def admit_fraction(self, level: Optional[int] = None) -> Optional[float]:
        """Ingest-door admit fraction, or None when the door is open
        (the processor skips the shed path entirely)."""
        lvl = self.level if level is None else level
        shed = float(self.policy.shed_fraction[lvl])
        return None if shed <= 0.0 else 1.0 - shed

    # -- durability ---------------------------------------------------------

    def to_state(self) -> Dict[str, Any]:
        scale, shares = self.admission_pressure
        return {
            "level": self.level,
            "transitions": self.transitions,
            "transition_failures": self.transition_failures,
            "shed_total": self.shed_total,
            "base_drain": self.base_drain,
            "admission_scale": scale,
            "admission_shares": dict(shares),
            "enter_streak": self._enter_streak,
            "exit_streak": self._exit_streak,
        }

    def load_state(self, state: Dict[str, Any]) -> None:
        self.level = int(state["level"])
        self.transitions = int(state["transitions"])
        self.transition_failures = int(state.get("transition_failures", 0))
        self.shed_total = int(state.get("shed_total", 0))
        self.base_drain = int(state.get("base_drain", 1))
        self.admission_pressure = (
            float(state.get("admission_scale", 1.0)),
            {
                str(k): float(v)
                for k, v in state.get("admission_shares", {}).items()
            },
        )
        self._enter_streak = int(state.get("enter_streak", 0))
        self._exit_streak = int(state.get("exit_streak", 0))

    @classmethod
    def from_state(
        cls, state: Dict[str, Any], policy: Optional[OverloadPolicy] = None
    ) -> "OverloadController":
        ctl = cls(policy)
        ctl.load_state(state)
        return ctl

    # -- telemetry ----------------------------------------------------------

    def metrics(self) -> Dict[str, Any]:
        """Snapshot keys merged into the supervisor's metrics snapshot —
        rendered by utils/telemetry.py as the ``cep_overload_*``
        Prometheus families."""
        return {
            "overload_level": self.level,
            "overload_pressure": round(self.last_pressure, 6),
            "overload_transitions": self.transitions,
            "overload_transition_failures": self.transition_failures,
        }
