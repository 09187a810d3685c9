"""Deterministic fault injection — named failure sites, seed-schedulable.

The supervisor's whole value is code that never runs in a happy path:
checkpoint-save failures, journal append/fsync failures, device faults
mid-stream, crashes between a snapshot and the journal truncation.  This
module makes those paths *drivable*: production code declares a named
**failpoint site** (``fire("journal.append")``) at each place a real
fault could surface, and a test arms a deterministic schedule of which
hit indices of which sites raise which exception.  Disarmed sites cost
one attribute read — no schedule, no counting, no overhead in
production.

Design rules:

* **Sites are named, not positional.**  A schedule written against
  ``device.dispatch`` keeps meaning across refactors; adding a site never
  perturbs existing schedules.
* **Determinism.**  Hit counters start at the moment a session is
  activated, so ``{"journal.append": [2]}`` always means "the third
  append after arming" — and :func:`random_schedule` derives a full
  schedule from one integer seed, making every chaos run exactly
  reproducible.
* **Faults are exceptions**, matching how every real fault in this stack
  surfaces (device loss, ENOSPC, EIO).  Crash simulation — abandoning the
  process mid-write — cannot be an exception (the crashed process runs no
  ``except`` clause); the torn-write helpers below forge the on-disk
  aftermath instead, and the chaos harness abandons the live objects.

Sites currently threaded through the runtime:

=====================  ====================================================
``device.dispatch``    entry of ``CEPProcessor._dispatch`` — the fault hits
                       *before* the scan, device state untouched
``device.result``      after the scan replaced ``self.state``, before the
                       decode — the adversarial case: state advanced, the
                       batch's matches never reached the caller
``journal.append``     entry of ``Journal.append`` — nothing written
``journal.fsync``      after the frame bytes reached the OS, at the
                       durability barrier — ``append`` rolls the frame back
                       so the journal stays a clean prefix
``checkpoint.save``    entry of ``save_checkpoint`` — snapshot never forms
``checkpoint.rename``  between the tmp-file write and the atomic
                       ``os.replace`` — the crash window the ``.tmp``
                       protocol exists for
``ingest.admit``       entry of ``CEPProcessor._ingest`` — before any
                       guard or lane bookkeeping mutates; the batch is
                       rejected wholesale, nothing half-admitted
``ingest.release``     after the reorder buffer moved (records admitted,
                       releases popped) but before the engine dispatch —
                       the adversarial window: the held set advanced
                       while device state did not, so recovery must
                       restore the buffer from the snapshot + journal
``shard.dispatch``     meshed branch of ``CEPProcessor._dispatch``, at the
                       host→mesh transfer — where a lost device first
                       surfaces on the sharded path; arm with
                       ``parallel.sharding.ShardLost`` to drive the
                       supervisor's shard-evacuation path
``rebalance.move``     entry of ``runtime.migrate.move_lanes``, before any
                       state moves — a fault here must leave the old
                       processor (and lane assignment) fully intact
``tenant.misbehave``   entry of ``runtime.tenant.TenantCEP.process``,
                       before admission, packing, or any state mutation —
                       arm with ``runtime.tenant.TenantMisbehave`` to flag
                       a tenant for supervisor quarantine
``quota.shed``         the admission shed path of ``runtime.tenant.
                       TenantAdmission`` (token bucket empty or traffic
                       for a quarantined tenant), before the dead letter
                       and shed ledger entries are recorded
``quarantine.enter``   entry of ``parallel.tenantbank.TenantBankMatcher.
                       quarantine``, before any enforcement state flips —
                       a fault here must leave the bank un-quarantined
                       and fully live
``overload.enter``     the brownout ladder's level-up protocol
                       (``runtime/supervisor.py _overload_transition``),
                       before actuators apply or the level pins — a fault
                       here must leave the previous level authoritative
``overload.exit``      the same protocol stepping down — identical
                       contract on the recovery direction
``overload.shed``      the ingest-door shed path at L3+
                       (``CEPProcessor._ingest``), after the Bresenham
                       keep/shed decision but before the dead letter is
                       recorded — recovery replays the batch and re-sheds
                       deterministically
=====================  ====================================================
"""

from __future__ import annotations

import contextlib
import os
import struct
import zlib
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np


class InjectedFault(RuntimeError):
    """Default exception for device-ish sites (supervisor recovery path)."""


class InjectedIOError(OSError):
    """Default exception for disk-ish sites (journal/checkpoint paths)."""


# Which exception a site raises when the arming does not say otherwise:
# device sites surface like a device loss (generic Exception -> recovery),
# disk sites like an errno failure (the counters/suspension paths).
_DEFAULT_EXC: Dict[str, Callable[[str], BaseException]] = {}


def _default_exc(site: str) -> BaseException:
    # ``shard.*`` models a lost mesh device — device family, not disk.
    if site.startswith(("device.", "shard.")):
        return InjectedFault(f"injected fault at {site}")
    return InjectedIOError(f"injected I/O failure at {site}")


class _Plan:
    """Armed behavior of one site: which hit indices raise what."""

    __slots__ = ("hits", "times", "exc")

    def __init__(
        self,
        hits: Optional[Iterable[int]] = None,
        times: int = 0,
        exc: Optional[Callable[[], BaseException]] = None,
    ):
        self.hits = frozenset(int(h) for h in hits) if hits is not None else None
        self.times = int(times)  # fire on the first N hits (hits is None)
        self.exc = exc

    def should(self, n: int) -> bool:
        if self.hits is not None:
            return n in self.hits
        return n < self.times


class Failpoints:
    """A registry of armed failure sites; one global instance drives all
    production sites (module-level :func:`fire`)."""

    def __init__(self):
        self._plans: Dict[str, _Plan] = {}
        self._hits: Dict[str, int] = {}
        self._enabled = False

    # -- arming (test side) -------------------------------------------------

    def arm(
        self,
        site: str,
        hits: Optional[Iterable[int]] = None,
        times: int = 1,
        exc: Optional[Callable[[], BaseException]] = None,
    ) -> None:
        """Arm ``site``: raise on the hit indices in ``hits`` (0-based,
        counted from activation), or on the first ``times`` hits when
        ``hits`` is None.  ``exc`` builds the exception to raise (default
        per site family)."""
        self._plans[site] = _Plan(hits=hits, times=times, exc=exc)
        self._enabled = True

    def arm_schedule(
        self,
        schedule: Dict[str, Sequence[int]],
        exc: Optional[Callable[[], BaseException]] = None,
    ) -> None:
        for site, hit_list in schedule.items():
            self.arm(site, hits=hit_list, exc=exc)

    def clear(self) -> None:
        """Disarm everything and reset all hit counters."""
        self._plans.clear()
        self._hits.clear()
        self._enabled = False

    @contextlib.contextmanager
    def session(
        self,
        schedule: Optional[Dict[str, Sequence[int]]] = None,
        exc: Optional[Callable[[], BaseException]] = None,
    ):
        """Context manager: arm ``schedule``, always clear on exit."""
        self.clear()
        if schedule:
            self.arm_schedule(schedule, exc=exc)
        else:
            self._enabled = True  # count hits even with nothing armed
        try:
            yield self
        finally:
            self.clear()

    def hits(self, site: str) -> int:
        """How many times ``site`` fired since activation."""
        return self._hits.get(site, 0)

    # -- firing (production side) -------------------------------------------

    def fire(self, site: str) -> None:
        """Called by production code at a failure site.  No-op (one
        attribute read) unless a session is active."""
        if not self._enabled:
            return
        n = self._hits.get(site, 0)
        self._hits[site] = n + 1
        plan = self._plans.get(site)
        if plan is None:
            return
        raising = plan.should(n)
        # Armed-site hits land in the trace stream (utils/telemetry.py)
        # when a default sink is installed, so a chaos JSONL shows the
        # injected fault right next to the recovery span it provoked.
        # Only armed sites pay the lookup; disarmed cost is unchanged.
        from kafkastreams_cep_tpu_torch.utils.telemetry import get_default_sink

        sink = get_default_sink()
        if sink is not None:
            sink.event("failpoint", site=site, hit=n, raised=raising)
        if raising:
            raise (plan.exc() if plan.exc is not None else _default_exc(site))


#: The process-wide registry every production site reports to.
FAILPOINTS = Failpoints()


def fire(site: str) -> None:
    """Module-level convenience for production call sites."""
    FAILPOINTS.fire(site)


# -- seeded schedules --------------------------------------------------------

#: All sites threaded through the runtime, in a stable order (schedules
#: index into this; keep append-only so seeds stay meaningful).
SITES = (
    "device.dispatch",
    "device.result",
    "journal.append",
    "journal.fsync",
    "checkpoint.save",
    "checkpoint.rename",
    # Ingestion-guard sites (append-only: schedules index by site name,
    # and random_schedule seeds by position — see the docstring table).
    "ingest.admit",
    "ingest.release",
    # Reporter cadence write: between serializing the metrics JSONL
    # record and its single-write append — a crash here must leave the
    # stream without any partial line (utils/telemetry.py Reporter.flush).
    "report.write",
    # Mesh fault-tolerance sites (runtime/supervisor.py shard evacuation
    # and hot-key rebalancing; see the docstring table).
    "shard.dispatch",
    "rebalance.move",
    # Adaptive replan swap (runtime/supervisor.py _maybe_replan): between
    # deriving the new plan and committing the rebuilt processor — a
    # crash here must leave the old plan fully live (replan_failures).
    "replan.swap",
    # Per-tenant isolation sites (runtime/tenant.py admission shedding +
    # supervisor quarantine, parallel/tenantbank.py enforcement; see the
    # docstring table).
    "tenant.misbehave",
    "quota.shed",
    "quarantine.enter",
    # Brownout ladder sites (runtime/supervisor.py transition protocol +
    # the processor's ingest-door shed; see the docstring table).
    "overload.enter",
    "overload.exit",
    "overload.shed",
)


def random_schedule(
    seed: int,
    horizon: int,
    rate: float = 0.15,
    sites: Sequence[str] = SITES,
) -> Dict[str, List[int]]:
    """A reproducible fault schedule from one integer seed.

    Each site independently fires on each of its first ``horizon`` hits
    with probability ``rate``.  The same seed always produces the same
    schedule; distinct seeds decorrelate quickly (``default_rng`` is
    seeded with ``(seed, site_index)``).
    """
    out: Dict[str, List[int]] = {}
    for i, site in enumerate(sites):
        rng = np.random.default_rng((int(seed), i))
        picks = np.nonzero(rng.random(int(horizon)) < rate)[0]
        if picks.size:
            out[site] = [int(p) for p in picks]
    return out


# -- crash-aftermath forgery -------------------------------------------------

_MAGIC = 0x43455031  # keep in sync with native/journal.py
_HEADER = struct.Struct("<III")


def tear_journal_tail(path: str, payload: bytes = b"torn-frame-payload",
                      keep: int = 6) -> None:
    """Forge the on-disk aftermath of a process dying mid-append: a frame
    whose header promises more bytes than follow.  ``Journal.replay``
    must treat everything before it as intact and truncate the rest."""
    frame = _HEADER.pack(_MAGIC, len(payload), zlib.crc32(payload)) + payload
    with open(path, "ab") as f:
        f.write(frame[: max(int(keep), 1)])


def corrupt_journal_tail(path: str, nbytes: int = 16, seed: int = 0) -> None:
    """Forge a tail of non-frame garbage (a crash after the filesystem
    wrote metadata but garbage data, or a partial overwrite)."""
    rng = np.random.default_rng(seed)
    junk = rng.integers(0, 256, size=int(nbytes), dtype=np.uint8).tobytes()
    # Avoid accidentally forging a valid magic at the boundary.
    if junk[:4] == struct.pack("<I", _MAGIC):
        junk = b"\x00" + junk[1:]
    with open(path, "ab") as f:
        f.write(junk)


def drop_checkpoint_rename(checkpoint_path: str) -> None:
    """Forge a crash between ``save_checkpoint(tmp)`` and ``os.replace``:
    the ``.tmp`` file exists, the real path still holds the old snapshot
    (or nothing).  Callers that already produced a tmp file can simply
    leave it; this helper removes a completed rename's destination to
    re-create the pre-rename world in tests that need it explicitly."""
    tmp = checkpoint_path + ".tmp"
    if os.path.exists(checkpoint_path) and not os.path.exists(tmp):
        os.replace(checkpoint_path, tmp)
