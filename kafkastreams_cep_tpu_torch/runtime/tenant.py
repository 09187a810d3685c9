"""Multi-tenant runtime: N queries, one record stream, one bank dispatch.

The serial bank (``runtime/bank.py: CEPBank``) runs one ``CEPProcessor`` a
pattern, N dispatches a batch.  This module is the shared-execution analog
over :class:`~kafkastreams_cep_tpu_torch.parallel.tenantbank.
TenantBankMatcher`: one key-to-lane routing table, one packed ``[K, T]``
batch, one screened bank scan, and per-query decode with that query's stage
names.  Emission per query matches ``CEPProcessor``: by arrival of the
completing record, then run-queue order; queries report in declaration
order (the ``CEPBank.process`` contract).

Durability follows ``runtime/checkpoint.py``: a checkpoint carries arrays
and names, never code, and restore recompiles the bank from user patterns
and refuses a topology whose per-query stage names differ.  The file is the
JAX package's format (``kafkastreams_cep_tpu/runtime/tenant.py``): the
state leaves under the same names (``engine/0/alive``, ``carry/0/...``) and
the same header, so a snapshot written by either package restores into the
other.  :class:`TenantSupervisor` adds checkpoint-every-N and
restore-replay-retry, with the replayed batches' matches suppressed (the
pre-fault incarnation emitted them), so a recovered stream is exactly
once.

Per-tenant isolation, outermost first:

* **Admission shedding** — :class:`AdmissionPolicy` puts a per-tenant token
  bucket (``runtime/ingest.py: AdmissionLimiter``) at the front door: a
  flooding tenant's records are shed before packing, dead-lettered under
  the typed ``tenant_quota`` reason, and ledgered so ``offered == admitted
  + shed + quarantined_dropped`` per tenant at any point of the stream.
* **Quota enforcement** — declared :class:`~kafkastreams_cep_tpu_torch.
  compiler.multitenant.TenantQuota` budgets are enforced inside the bank
  (``parallel/tenantbank.py: TenantIsolation``).
* **Quarantine** — a tenant whose predicate raises, that keeps tripping
  capacity, or that is flagged :class:`TenantMisbehave` is circuit-broken
  out of the bank; the rest of the bank equals a bank that never held it.
* **Isolated escalation** — capacity trips are attributed per query;
  :class:`TenantSupervisor` refuses a bank-wide widening charged to a
  tenant over its declared quota (``tenant_escalation_denied``).

``device`` is where the bank runs: ``"cuda"`` by default (raises when there
is no GPU), ``"cpu"`` for the plain PyTorch path.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from kafkastreams_cep_tpu_torch.convert import state_arrays, state_from_arrays
from kafkastreams_cep_tpu_torch.engine.matcher import ArrayStates, EngineConfig, EventBatch
from kafkastreams_cep_tpu_torch.engine.predmatrix import owner_states
from kafkastreams_cep_tpu_torch.engine.sizing import (
    EscalationPolicy,
    capacity_counters,
    escalate,
)
from kafkastreams_cep_tpu_torch.parallel.tenantbank import TenantBankMatcher, TenantState
from kafkastreams_cep_tpu_torch.runtime.checkpoint import CheckpointCorrupt, _Unpickler
from kafkastreams_cep_tpu_torch.runtime.ingest import (
    REASON_TENANT_QUOTA,
    AdmissionLimiter,
    DeadLetter,
)
from kafkastreams_cep_tpu_torch.runtime.migrate import widen_state
from kafkastreams_cep_tpu_torch.runtime.processor import (
    InputRejected,
    Record,
    _bucket,
    tree_flatten,
    tree_unflatten,
    treedef_str,
)
from kafkastreams_cep_tpu_torch.utils.events import Event, Sequence
from kafkastreams_cep_tpu_torch.utils.failpoints import fire as _failpoint
from kafkastreams_cep_tpu_torch.utils.latency import LatencyLedger
from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("runtime.tenant")

TENANT_FORMAT_VERSION = 1

_I32 = np.iinfo(np.int32)


class TenantMisbehave(RuntimeError):
    """A fault attributable to one named tenant (query).

    Raised (or injected through the ``tenant.misbehave`` failpoint) when a
    fault can be pinned on one tenant; ``query`` names the offender, so
    :class:`TenantSupervisor` quarantines exactly that tenant and recovers
    instead of recovering blind and faulting again."""

    def __init__(self, query: Optional[str] = None, message: Optional[str] = None):
        super().__init__(message or f"tenant {query!r} misbehaving")
        self.query = query


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Record-admission rate limiting at the tenant runtime's front door.

    ``rate_per_batch``    — token-bucket refill per processed batch and
                            tenant; a tenant offering more than this
                            sustained is shed before packing.
    ``burst``             — bucket capacity (default ``max(1, 2*rate)``);
                            0 sheds a tenant's every record.
    ``key_tenant``        — record key -> tenant id (default ``str(key)``).
    ``shed_quarantined``  — also drop records whose tenant is quarantined
                            (``quarantined_dropped``).  Only correct when
                            the key space is partitioned per tenant: a
                            shared key's records feed other tenants too.
    ``dead_letter_cap``   — retained shed records (FIFO), each tagged with
                            the typed ``tenant_quota`` reason.
    """

    rate_per_batch: float
    burst: Optional[float] = None
    key_tenant: Optional[Callable[[Hashable], str]] = None
    shed_quarantined: bool = False
    dead_letter_cap: int = 1024

    def __post_init__(self):
        if self.rate_per_batch < 0:
            raise ValueError(f"rate_per_batch must be >= 0, got {self.rate_per_batch}")
        if self.dead_letter_cap < 0:
            raise ValueError("dead_letter_cap must be >= 0")


class TenantAdmission:
    """The admission front door: token buckets and the per-tenant ledger.

    Deterministic host state.  Per tenant, ``offered == admitted + shed +
    quarantined_dropped`` after every :meth:`filter`; :meth:`to_state`
    round-trips through the checkpoint header (the policy never does:
    callables come from code, like predicates), so the ledger survives a
    crash and a journal replay reproduces it exactly."""

    def __init__(self, policy: AdmissionPolicy):
        self.policy = policy
        self.limiter = AdmissionLimiter(policy.rate_per_batch, policy.burst)
        self.offered: Dict[str, int] = {}
        self.admitted: Dict[str, int] = {}
        self.shed: Dict[str, int] = {}
        self.quarantined_dropped: Dict[str, int] = {}
        self.dead_letters: List[DeadLetter] = []
        self.batch_seq = 0

    def tenant_of(self, key: Hashable) -> str:
        fn = self.policy.key_tenant
        return str(key) if fn is None else str(fn(key))

    def _dead_letter(self, record: Record, detail: str, corr: str) -> None:
        if self.policy.dead_letter_cap <= 0:
            return
        if len(self.dead_letters) >= self.policy.dead_letter_cap:
            self.dead_letters.pop(0)
        self.dead_letters.append(DeadLetter(record, REASON_TENANT_QUOTA, detail, corr))

    def filter(self, records: Seq[Record], quarantined: frozenset) -> List[Record]:
        """One batch through the front door: the admitted records in
        arrival order; the rest ledgered and dead-lettered.  The buckets
        refill at the batch's end (consume, then refill), so a rolled-back
        batch replays against the same buckets."""
        corr = f"admit-{self.batch_seq}"
        self.batch_seq += 1
        out: List[Record] = []
        for rec in records:
            t = self.tenant_of(rec.key)
            self.offered[t] = self.offered.get(t, 0) + 1
            if self.policy.shed_quarantined and t in quarantined:
                # Fault site: the drop is decided but not yet ledgered.
                _failpoint("quota.shed")
                self.quarantined_dropped[t] = self.quarantined_dropped.get(t, 0) + 1
                self._dead_letter(rec, f"tenant {t!r} quarantined", corr)
                continue
            if not self.limiter.admit(t):
                # Fault site: the shed is decided but not yet ledgered.
                _failpoint("quota.shed")
                self.shed[t] = self.shed.get(t, 0) + 1
                self._dead_letter(rec, f"tenant {t!r} admission bucket empty", corr)
                continue
            self.admitted[t] = self.admitted.get(t, 0) + 1
            out.append(rec)
        self.limiter.refill()
        return out

    def ledger(self) -> Dict[str, Dict[str, int]]:
        tenants = sorted(set(self.offered) | set(self.admitted) | set(self.shed)
                         | set(self.quarantined_dropped))
        return {
            t: {
                "offered": self.offered.get(t, 0),
                "admitted": self.admitted.get(t, 0),
                "shed": self.shed.get(t, 0),
                "quarantined_dropped": self.quarantined_dropped.get(t, 0),
            }
            for t in tenants
        }

    def to_state(self) -> Dict[str, Any]:
        return {
            "limiter": self.limiter.to_state(),
            "offered": dict(self.offered),
            "admitted": dict(self.admitted),
            "shed": dict(self.shed),
            "quarantined_dropped": dict(self.quarantined_dropped),
            "dead_letters": [tuple(d) for d in self.dead_letters],
            "batch_seq": self.batch_seq,
        }

    def load_state(self, state: Dict[str, Any]) -> None:
        self.limiter = AdmissionLimiter.from_state(state["limiter"])
        self.offered = dict(state["offered"])
        self.admitted = dict(state["admitted"])
        self.shed = dict(state["shed"])
        self.quarantined_dropped = dict(state["quarantined_dropped"])
        self.dead_letters = [DeadLetter(*d) for d in state["dead_letters"]]
        self.batch_seq = int(state["batch_seq"])


def _leaf_dtype(proto) -> torch.dtype:
    """A value leaf's device dtype, as the JAX package's tenant packer types
    it: float32 for a Python float, int32 otherwise."""
    return torch.float32 if isinstance(proto, float) else torch.int32


class TenantCEP:
    """N named queries over one stream, one bank dispatch a batch.

    ``patterns`` maps query name -> built pattern (declaration order is
    emission order, like :class:`~kafkastreams_cep_tpu_torch.runtime.bank.
    CEPBank`).  Keys claim lanes first-seen like ``CEPProcessor`` (one more
    key than lanes raises); every query sees every record.  Values share
    one numeric structure, fixed by the first record.

    ``quotas`` (name -> ``TenantQuota``) declares per-tenant budgets the
    bank enforces; ``admission`` puts an :class:`AdmissionPolicy` token
    bucket ahead of packing; ``latency`` (``True`` or a ``LatencyLedger``)
    stamps every batch on ``clock`` and observes each emitted match's
    end-to-end time under its query's name.  ``device`` is where the bank
    runs (``"cuda"`` by default; ``"cpu"`` for the plain PyTorch path).
    """

    def __init__(
        self,
        patterns: Dict[str, object],
        num_lanes: int,
        config: Optional[EngineConfig] = None,
        topic: str = "stream",
        profile: Optional[Dict] = None,
        reorder: bool = True,
        quotas: Optional[Dict] = None,
        admission: Optional[AdmissionPolicy] = None,
        clock=None,
        latency=None,
        device="cuda",
    ):
        if not patterns:
            raise ValueError("a tenant bank needs at least one pattern")
        self.query_names = list(patterns)
        self.batch = TenantBankMatcher(
            list(patterns.values()), num_lanes, config, profile=profile,
            reorder=reorder, names=self.query_names, quotas=quotas, device=device,
        )
        self.device = self.batch.device
        self.num_lanes = int(num_lanes)
        self.topic = topic
        self.admission = TenantAdmission(admission) if admission is not None else None
        self.quarantine_reasons: Dict[str, str] = {}
        self.state: TenantState = self.batch.init_state()
        self._lane_of: Dict[Hashable, int] = {}
        self._key_of: Dict[int, Hashable] = {}
        self._next_offset = np.zeros(self.num_lanes, np.int64)
        self._events: List[Dict[int, Event]] = [{} for _ in range(self.num_lanes)]
        self._value_proto: Any = None
        self.batches = 0
        # The latency ledger (utils/latency.py): the tenant path has no
        # reorder buffer, so reorder_hold is 0, queue is the pack, device the
        # bank scan and the outputs' host copy, drain_defer the emit loop.
        self._clock = clock if clock is not None else time.time
        if latency is True:
            self.ledger: Optional[LatencyLedger] = LatencyLedger(clock=self._clock)
        else:
            self.ledger = latency or None
        # Event-time watermark (the largest packed record timestamp), for the
        # watermark and event-time-lag gauges CEPProcessor reports too.
        self._watermark: Optional[int] = None

    # -- routing --------------------------------------------------------------

    def lane(self, key: Hashable) -> int:
        existing = self._lane_of.get(key)
        if existing is not None:
            return existing
        lane = len(self._lane_of)
        if lane >= self.num_lanes:
            raise InputRejected(
                f"key {key!r}: more than num_lanes={self.num_lanes} distinct keys; "
                "size the tenant runtime for the key cardinality it serves"
            )
        self._lane_of[key] = lane
        self._key_of[lane] = key
        return lane

    def _key_code(self, key: Hashable, lane: int) -> int:
        if isinstance(key, (int, np.integer)) and _I32.min <= key <= _I32.max:
            return int(key)
        return lane

    # -- the per-batch path ---------------------------------------------------

    def process(self, records: Seq[Record]) -> List[Tuple[str, Hashable, Sequence]]:
        """One micro-batch through the whole bank: ``(query_name, key,
        Sequence)`` triples, queries in declaration order, each query's
        matches in arrival-then-queue order."""
        # Fault site: a fault pinned on one tenant (armed with an exception
        # factory raising TenantMisbehave(name)).
        _failpoint("tenant.misbehave")
        records = list(records)
        if not records:
            return []
        if self.admission is None:
            return self._process_admitted(records)
        # Admission is atomic per batch: any raise rolls the ledger back, so
        # a retried or replayed batch meets the same buckets.
        snap = self.admission.to_state()
        try:
            admitted = self.admission.filter(records, frozenset(self.quarantined_names()))
            if not admitted:
                self.batches += 1
                return []
            return self._process_admitted(admitted)
        except BaseException:
            self.admission.load_state(snap)
            raise

    def _process_admitted(self, records: List[Record]) -> List[Tuple[str, Hashable, Sequence]]:
        lat = None
        if self.ledger is not None:
            lat = self.ledger.start_batch(f"{self.topic}-{self.batches + 1}", len(records))
        events, rank_of = self._pack(records)
        # Fault sites: before the scan (state untouched) and after it (state
        # advanced, matches not yet returned).
        _failpoint("device.dispatch")
        if lat is not None:
            lat.dispatch = self._clock()
        self.state, out = self.batch.scan(self.state, events)
        _failpoint("device.result")
        self.batches += 1
        # One host copy per output ([N, K, T, R(, W)]); each waits for the
        # bank's kernels, so the complete stamp after them is the card's.
        count = out.count.cpu().numpy()
        stage = out.stage.cpu().numpy()
        off = out.off.cpu().numpy()
        if lat is not None:
            lat.complete = self._clock()
        matches: List[Tuple[str, Hashable, Sequence]] = []
        for q, qname in enumerate(self.query_names):
            names = self.batch.names_of(q)
            ks, ts, rs = np.nonzero(count[q])
            if ks.size == 0:
                continue
            order = np.lexsort((rs, rank_of[ks, ts]))
            ks, ts, rs = ks[order], ts[order], rs[order]
            for i in range(ks.size):
                k = int(ks[i])
                seq = Sequence()
                for w in range(int(count[q, k, ts[i], rs[i]])):
                    seq.add(names[int(stage[q, k, ts[i], rs[i], w])],
                            self._events[k][int(off[q, k, ts[i], rs[i], w])])
                matches.append((qname, self._key_of[k], seq))
        if lat is not None:
            emit = self._clock()
            self.ledger.commit(lat, emit)
            # Per-query e2e: one observation per emitted match, under the
            # query's name.
            e2e = max(emit - lat.release, 0.0)
            for qname, _k, _s in matches:
                self.ledger.observe_query(qname, e2e)
        return matches

    def _pack(self, records: List[Record]):
        """Per-lane queues -> a right-padded ``[K, T]`` batch on the bank's
        device, and the ``[K, T]`` arrival-rank table the emitter sorts
        by."""
        per_lane: List[List[Tuple[int, Record]]] = [[] for _ in range(self.num_lanes)]
        for rank, rec in enumerate(records):
            if not (_I32.min <= int(rec.timestamp) <= _I32.max):
                raise InputRejected(
                    f"record {rank} (key {rec.key!r}): timestamp {rec.timestamp} "
                    "outside int32 device time"
                )
            per_lane[self.lane(rec.key)].append((rank, rec))
        if self._value_proto is None:
            self._value_proto = records[0].value
        protos, treedef = tree_flatten(self._value_proto)
        K = self.num_lanes
        T = _bucket(max(len(q) for q in per_lane))
        key_arr = np.zeros((K, T), np.int32)
        ts_arr = np.zeros((K, T), np.int32)
        off_arr = np.full((K, T), -1, np.int32)
        valid = np.zeros((K, T), bool)
        rank_of = np.full((K, T), np.iinfo(np.int64).max, np.int64)
        leaves = [np.zeros((K, T), np.float32 if isinstance(p, float) else np.int32)
                  for p in protos]
        for k, queue in enumerate(per_lane):
            for t, (rank, rec) in enumerate(queue):
                rec_leaves, rec_def = tree_flatten(rec.value)
                if rec_def != treedef:
                    raise InputRejected(
                        f"record {rank} (key {rec.key!r}): value structure "
                        f"{treedef_str(rec_def)} does not match the stream schema "
                        f"{treedef_str(treedef)}"
                    )
                o = int(self._next_offset[k])
                self._next_offset[k] = o + 1
                key_arr[k, t] = self._key_code(rec.key, k)
                ts_arr[k, t] = int(rec.timestamp)
                if self._watermark is None or rec.timestamp > self._watermark:
                    self._watermark = int(rec.timestamp)
                off_arr[k, t] = o
                valid[k, t] = True
                rank_of[k, t] = rank
                for leaf, v in zip(leaves, rec_leaves):
                    leaf[k, t] = v
                self._events[k][o] = Event(rec.key, rec.value, int(rec.timestamp),
                                           self.topic, k, o)

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        value = tree_unflatten(treedef, [dev(l) for l in leaves])
        return (EventBatch(key=dev(key_arr), value=value, ts=dev(ts_arr), off=dev(off_arr),
                           valid=dev(valid)),
                rank_of)

    # -- quarantine / poison probing ------------------------------------------

    def _qid(self, name: str) -> int:
        try:
            return self.query_names.index(name)
        except ValueError:
            raise KeyError(f"no query named {name!r}") from None

    def quarantine(self, name: str, reason: str = "manual") -> None:
        """Circuit-break query ``name`` out of the bank
        (``TenantBankMatcher.quarantine``); ``reason`` is kept for the
        checkpoint header and telemetry."""
        self.batch.quarantine(self._qid(name))
        self.quarantine_reasons[name] = str(reason)

    def reinstate(self, name: str) -> None:
        """Lift ``name``'s quarantine; its frozen state resumes."""
        self.batch.reinstate(self._qid(name))
        self.quarantine_reasons.pop(name, None)

    def quarantined_names(self) -> List[str]:
        return [self.query_names[q] for q in self.batch.quarantined_qids]

    def find_poison(self) -> List[str]:
        """Probe every live screen column's predicate on a one-event batch
        and return the names of the queries that use a raising column.

        A poisoned tenant predicate raises inside the scan before any state
        moves; this attributes it to its tenants, so the supervisor can
        quarantine the offender instead of retrying into the same raise.
        Columns dark under quarantine are skipped; a runtime that has seen
        no record has no value schema and reports nothing."""
        if self._value_proto is None:
            return []
        protos, treedef = tree_flatten(self._value_proto)
        dev = self.device
        value = tree_unflatten(
            treedef, [torch.zeros((1, 1), dtype=_leaf_dtype(p), device=dev) for p in protos])
        key = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        ts = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        bad: set = set()
        tables = [qp.tables for qp in self.batch.bank.queries]
        for ci, col in enumerate(self.batch.bank.columns):
            if ci in self.batch._disabled_cols:
                continue
            env = ArrayStates({}) if col.shared else owner_states(tables[col.owner], dev)
            try:
                col.pred(key, value, ts, env)
            except Exception:
                bad |= self.batch._col_users.get(ci, set())
        return sorted(self.query_names[q] for q in bad)

    # -- telemetry ------------------------------------------------------------

    def counters(self) -> Dict[str, int]:
        return self.batch.counters(self.state)

    def tier_counters(self) -> Dict[str, int]:
        return self.batch.tier_counters(self.state)

    def per_query_counters(self) -> Dict[str, Dict[str, int]]:
        return self.batch.per_query_counters(self.state)

    def admission_ledger(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant ``offered/admitted/shed/quarantined_dropped`` (empty
        without an :class:`AdmissionPolicy`)."""
        return {} if self.admission is None else self.admission.ledger()

    def metrics_snapshot(self) -> Dict[str, object]:
        """The bank's snapshot (``per_query`` and the isolation counters),
        the ``watermark`` and ``event_time_lag_ms`` gauges on the runtime's
        clock, ``latency`` (with a ledger) and the admission totals and
        dead letters by reason (with an admission policy)."""
        out = self.batch.metrics_snapshot(self.state)
        out["watermark"] = self._watermark
        out["event_time_lag_ms"] = (
            int(self._clock() * 1000) - self._watermark if self._watermark is not None else None
        )
        if self.ledger is not None:
            out["latency"] = self.ledger.snapshot()
        if self.admission is not None:
            ledger = self.admission.ledger()
            for name in ("offered", "admitted", "shed", "quarantined_dropped"):
                out[f"admission_{name}_total"] = sum(row[name] for row in ledger.values())
            # Rendered as ``dead_letters_total{reason=...}``, the ingest
            # guard's contract.
            reasons: Dict[str, int] = {}
            for d in self.admission.dead_letters:
                reasons[d.reason] = reasons.get(d.reason, 0) + 1
            out["dead_letters"] = reasons
            out["dead_letter_depth"] = len(self.admission.dead_letters)
        return out


# ---------------------------------------------------------------------------
# Checkpoint / restore (the changelog-store analog for the whole bank)
# ---------------------------------------------------------------------------


def save_tenant_checkpoint(tenant: TenantCEP, path: str,
                           extra: Optional[Dict[str, Any]] = None) -> None:
    """Snapshot a tenant runtime to one file: arrays and names, no code.

    The array payload is the :class:`TenantState` tree (the residual
    groups' engines, the prefix-length groups' carries) under the JAX
    package's leaf names; the header records every query's stage names, so
    restore holds the whole bank to the lookup-by-name contract at once."""
    _failpoint("checkpoint.save")
    header = {
        "format_version": TENANT_FORMAT_VERSION,
        "extra": dict(extra or {}),
        "query_names": list(tenant.query_names),
        "stage_names": {name: list(tenant.batch.names_of(q))
                        for q, name in enumerate(tenant.query_names)},
        "config": dataclasses.asdict(tenant.batch.config),
        "num_lanes": tenant.num_lanes,
        "topic": tenant.topic,
        "lane_of": dict(tenant._lane_of),
        "next_offset": tenant._next_offset.copy(),
        "events": [dict(d) for d in tenant._events],
        "value_proto": tenant._value_proto,
        "batches": tenant.batches,
        # Isolation bookkeeping; the admission policy is never pickled
        # (callables come from code), only its ledger and buckets.
        "isolation": tenant.batch.iso_state(),
        "quarantine_reasons": dict(tenant.quarantine_reasons),
        "watermark": tenant._watermark,
        "latency": tenant.ledger.to_state() if tenant.ledger is not None else None,
        "admission": tenant.admission.to_state() if tenant.admission is not None else None,
    }
    buf = io.BytesIO()
    np.savez(buf, **state_arrays(tenant.state))
    header["arrays_sha256"] = hashlib.sha256(buf.getvalue()).hexdigest()
    with open(path, "wb") as f:
        pickle.dump({"header": header, "arrays": buf.getvalue()}, f)
    logger.info("tenant checkpoint saved to %s: %d queries, %d lanes",
                path, len(tenant.query_names), tenant.num_lanes)


def load_tenant_checkpoint(path: str) -> Dict[str, Any]:
    """Read a tenant checkpoint into ``{header, arrays}`` (the JAX package's
    classes in its header map to this package's); raises
    :class:`CheckpointCorrupt` when it cannot be parsed or fails its
    digest."""
    try:
        with open(path, "rb") as f:
            blob = _Unpickler(f).load()
        header = blob["header"]
    except OSError:
        raise
    except Exception as e:
        raise CheckpointCorrupt(
            f"checkpoint {path} is unreadable ({type(e).__name__}: {e})") from e
    if header["format_version"] != TENANT_FORMAT_VERSION:
        raise ValueError(f"tenant checkpoint format {header['format_version']} unsupported")
    got = hashlib.sha256(blob["arrays"]).hexdigest()
    if got != header["arrays_sha256"]:
        raise CheckpointCorrupt(
            f"checkpoint {path} failed integrity check: array payload sha256 {got} != "
            f"header digest {header['arrays_sha256']}")
    try:
        with np.load(io.BytesIO(blob["arrays"])) as z:
            arrays = {k: z[k] for k in z.files}
    except Exception as e:
        raise CheckpointCorrupt(
            f"checkpoint {path} array payload is unreadable ({type(e).__name__}: {e})") from e
    return {"header": header, "arrays": arrays}


def restore_tenant(patterns: Dict[str, object], path: str,
                   ckpt: Optional[Dict[str, Any]] = None, **tenant_kwargs) -> TenantCEP:
    """Rebuild a tenant runtime from user code and a checkpoint.

    Patterns are compiled fresh; the checkpoint supplies state only, and a
    bank whose query names or stage names differ is refused.
    ``tenant_kwargs`` (quotas, admission policy, clock, ``device``, ...) are
    the code-side configuration; the snapshot's isolation ledger, admission
    state and latency ledger (on the runtime's clock) are applied on top."""
    if ckpt is None:
        ckpt = load_tenant_checkpoint(path)
    header = ckpt["header"]
    if list(patterns) != list(header["query_names"]):
        raise ValueError(
            f"query names do not match checkpoint: {list(patterns)} vs "
            f"{header['query_names']}")
    kwargs = dict(tenant_kwargs)
    kwargs.setdefault("topic", header["topic"])
    tenant = TenantCEP(patterns, header["num_lanes"], EngineConfig(**header["config"]),
                       **kwargs)
    for q, name in enumerate(tenant.query_names):
        want = list(header["stage_names"][name])
        got = list(tenant.batch.names_of(q))
        if got != want:
            raise ValueError(
                f"query {name!r} topology does not match checkpoint: stages {got} vs "
                f"checkpoint {want}")
    tenant.state = state_from_arrays(ckpt["arrays"], tenant.state)
    tenant._lane_of = dict(header["lane_of"])
    tenant._key_of = {v: k for k, v in tenant._lane_of.items()}
    tenant._next_offset = np.asarray(header["next_offset"]).copy()
    tenant._events = [dict(d) for d in header["events"]]
    tenant._value_proto = header["value_proto"]
    tenant.batches = int(header["batches"])
    tenant._watermark = header.get("watermark")
    if header.get("latency") is not None:
        # The clock stays as constructed: clocks are wiring, not state.
        tenant.ledger = LatencyLedger.from_state(header["latency"], clock=tenant._clock)
    iso = header.get("isolation")
    if iso is not None:
        tenant.batch.load_iso_state(iso)
    tenant.quarantine_reasons = dict(header.get("quarantine_reasons", {}))
    adm = header.get("admission")
    if adm is not None and tenant.admission is not None:
        tenant.admission.load_state(adm)
    logger.info("restored tenant runtime from %s: %d queries, %d keys assigned",
                path, len(tenant.query_names), len(tenant._lane_of))
    return tenant


# ---------------------------------------------------------------------------
# Supervisor: checkpoint-every-N + restore / replay / retry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuarantinePolicy:
    """When repeated per-tenant misbehaviour hardens into quarantine.

    ``trip_streak`` — consecutive denied escalations (capacity trips by a
    tenant over its declared quota) before that tenant is quarantined; the
    streak resets whenever the tenant trips nothing."""

    trip_streak: int = 3

    def __post_init__(self):
        if self.trip_streak < 1:
            raise ValueError("trip_streak must be >= 1")


class TenantSupervisor:
    """Auto-recovering wrapper for a tenant runtime.

    Every ``checkpoint_every`` batches the whole bank is snapshot (atomic
    rename: a crash mid-write keeps the previous file).  When a batch
    raises, the supervisor restores the latest snapshot (or a fresh bank
    before the first), replays the batches journaled since it with their
    matches suppressed, and retries the batch up to ``max_retries`` times;
    :class:`InputRejected` (a bad batch, not a bad device) is raised at
    once.

    A :class:`TenantMisbehave` fault quarantines the named tenant before
    recovery; any other fault is first probed with
    :meth:`TenantCEP.find_poison`, so a raising tenant predicate
    quarantines its owner instead of faulting every retry.  Quarantine
    decisions live here (``quarantines``) and are re-applied after every
    restore.  Retries and recovery attempts back off exponentially with
    deterministic jitter (``retry_backoff_ms=0`` retries at once).

    With ``auto_escalate`` (an ``EscalationPolicy``), capacity trips are
    attributed per query from counter deltas: a widening whose tripping
    tenants are all within quota proceeds (the state migrated live by
    ``runtime/migrate.py: widen_state``, then pinned by a checkpoint);
    one charged to an over-quota tenant is refused
    (``tenant_escalation_denied``), and after ``quarantine_policy.
    trip_streak`` denials in a row the offender is quarantined."""

    def __init__(
        self,
        patterns: Dict[str, object],
        num_lanes: int,
        config: Optional[EngineConfig] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 16,
        max_retries: int = 1,
        retry_backoff_ms: float = 50.0,
        retry_backoff_cap_ms: float = 5000.0,
        auto_escalate: Optional[EscalationPolicy] = None,
        quarantine_policy: QuarantinePolicy = QuarantinePolicy(),
        **tenant_kwargs,
    ):
        self._patterns = dict(patterns)
        self._tenant_kwargs = dict(tenant_kwargs)
        self.tenant = TenantCEP(patterns, num_lanes, config, **tenant_kwargs)
        self.checkpoint_path = checkpoint_path or os.path.join(
            tempfile.gettempdir(), f"cep_tenant_{os.getpid()}_{id(self):x}.ckpt")
        self.checkpoint_every = int(checkpoint_every)
        self.max_retries = int(max_retries)
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.retry_backoff_cap_ms = float(retry_backoff_cap_ms)
        self.retry_backoff_ms_total = 0.0
        self._sleep = time.sleep  # tests patch this
        self.auto_escalate = auto_escalate
        self.quarantine_policy = quarantine_policy
        self.quarantines: Dict[str, str] = {}
        self._denial_streak: Dict[str, int] = {}
        self._pq_base: Optional[Dict[str, Dict[str, int]]] = None
        self._journal: List[List[Record]] = []
        self._has_checkpoint = False
        self.recoveries = 0
        self.checkpoints = 0
        self.checkpoint_failures = 0
        self.escalations = 0
        self.tenant_escalation_denied = 0
        self.tenant_quarantines = 0

    def process(self, records: Seq[Record]) -> List[Tuple[str, Hashable, Sequence]]:
        records = list(records)
        last_err: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            try:
                matches = self.tenant.process(records)
                break
            except InputRejected:
                raise
            except TenantMisbehave as e:
                # Attributed: isolate exactly the offender, then recover.
                last_err = e
                logger.warning("tenant misbehaving (%s); quarantining and recovering "
                               "(attempt %d/%d)", e, attempt + 1, self.max_retries)
                self._quarantine_for(e.query, "misbehave")
                if attempt < self.max_retries:
                    self._backoff(attempt)
                self._recover()
            except Exception as e:  # a device fault: recover and retry
                last_err = e
                logger.warning("batch failed (%s: %s); recovering (attempt %d/%d)",
                               type(e).__name__, e, attempt + 1, self.max_retries)
                # A raising tenant predicate would fault every retry: probe
                # and quarantine its owner first.
                try:
                    poisoned = self.tenant.find_poison()
                except Exception:
                    poisoned = []
                for name in poisoned:
                    self._quarantine_for(name, "predicate_raise")
                if attempt < self.max_retries:
                    self._backoff(attempt)
                self._recover()
        else:
            raise last_err  # retries exhausted
        self._journal.append(records)
        self._maybe_escalate()
        if len(self._journal) >= self.checkpoint_every:
            self.checkpoint()
        return matches

    def _backoff(self, attempt: int) -> None:
        """Exponential in the attempt, capped, with jitter seeded by
        ``(batches + 1, attempt)`` so a replayed schedule waits the same."""
        if self.retry_backoff_ms <= 0:
            return
        delay_ms = min(self.retry_backoff_cap_ms, self.retry_backoff_ms * (2.0 ** attempt))
        rng = np.random.default_rng((self.tenant.batches + 1, attempt))
        delay_ms *= 0.5 + 0.5 * float(rng.random())  # jitter in [0.5, 1.0)
        self.retry_backoff_ms_total += delay_ms
        logger.info("retry backoff: %.1f ms before attempt %d", delay_ms, attempt + 2)
        self._sleep(delay_ms / 1000.0)

    # -- quarantine bookkeeping ----------------------------------------------

    def _quarantine_for(self, name: Optional[str], reason: str) -> None:
        """Record a quarantine decision (re-applied after every restore)
        and apply it to the live bank.  An unattributed fault isolates
        nothing."""
        if name is None or name not in self._patterns or name in self.quarantines:
            return
        self.quarantines[name] = str(reason)
        self.tenant_quarantines += 1
        try:
            self.tenant.quarantine(name, reason)
        except Exception as e:
            # A fault entering quarantine leaves the bank live; the recorded
            # decision re-applies at the next recovery.
            logger.warning("quarantine of %r deferred (%s: %s); re-applied on recovery",
                           name, type(e).__name__, e)

    def reinstate(self, name: str) -> None:
        """Lift a quarantine: the decision (so recovery stops re-applying
        it) and the bank's enforcement."""
        self.quarantines.pop(name, None)
        self._denial_streak.pop(name, None)
        self.tenant.reinstate(name)

    # -- isolated escalation ---------------------------------------------------

    def _maybe_escalate(self) -> None:
        """Per-tenant-attributed widening after a clean batch: the whole
        bank widens when every tripping tenant is within its quota (knobs
        are bank-wide); otherwise the widening is denied and charged to the
        over-quota tenants, quarantining streak offenders."""
        if self.auto_escalate is None:
            return
        pq = self.tenant.per_query_counters()
        base = self._pq_base or {}
        self._pq_base = pq
        tripping: Dict[str, Dict[str, int]] = {}
        for name, counters in pq.items():
            prev = base.get(name, {})
            deltas = {c: v - prev.get(c, 0) for c, v in capacity_counters(counters).items()
                      if v - prev.get(c, 0) > 0}
            if deltas:
                tripping[name] = deltas
        if not tripping:
            self._denial_streak.clear()
            return
        iso = self.tenant.batch.iso
        over = [name for name in tripping if iso.over[self.tenant._qid(name)]]
        for name in list(self._denial_streak):
            if name not in over:
                self._denial_streak.pop(name)
        if over:
            self.tenant_escalation_denied += 1
            logger.warning("escalation denied: capacity trips %s attributed to over-quota "
                           "tenants %s", tripping, over)
            for name in over:
                streak = self._denial_streak.get(name, 0) + 1
                self._denial_streak[name] = streak
                if streak >= self.quarantine_policy.trip_streak:
                    self._quarantine_for(name, "capacity")
            return
        merged: Dict[str, int] = {}
        for deltas in tripping.values():
            for c, v in deltas.items():
                merged[c] = merged.get(c, 0) + v
        new_cfg = escalate(self.tenant.batch.config, merged, self.auto_escalate)
        if new_cfg is None:
            return  # every tripped dimension at its ceiling
        logger.warning("escalating bank config for compliant trips %s", merged)
        self._widen(new_cfg)
        self.escalations += 1

    def _widen(self, new_cfg: EngineConfig) -> None:
        """Migrate the whole bank live into ``new_cfg``'s shapes
        (``widen_state``: counters and live runs survive bit for bit, on the
        bank's device) and pin the widened incarnation with a checkpoint so
        recovery never narrows back."""
        old = self.tenant
        new = TenantCEP(self._patterns, old.num_lanes, new_cfg, **self._tenant_kwargs)
        new.state = state_from_arrays(
            state_arrays(widen_state(old.state, old.batch.config, new_cfg)), new.state)
        new._lane_of = dict(old._lane_of)
        new._key_of = dict(old._key_of)
        new._next_offset = old._next_offset.copy()
        new._events = [dict(d) for d in old._events]
        new._value_proto = old._value_proto
        new.batches = old.batches
        new.batch.load_iso_state(old.batch.iso_state())
        new.quarantine_reasons = dict(old.quarantine_reasons)
        if new.admission is not None and old.admission is not None:
            new.admission.load_state(old.admission.to_state())
        self.tenant = new
        self.checkpoint()

    def checkpoint(self) -> None:
        """Snapshot now (atomic rename) and truncate the journal; a failed
        save is counted and the journal kept."""
        tmp = self.checkpoint_path + ".tmp"
        try:
            save_tenant_checkpoint(self.tenant, tmp, extra={"batches": self.tenant.batches})
            os.replace(tmp, self.checkpoint_path)
        except Exception as e:
            self.checkpoint_failures += 1
            if os.path.exists(tmp):
                os.remove(tmp)
            logger.warning("checkpoint save failed (%s: %s); journal retained so recovery "
                           "replays from the previous snapshot", type(e).__name__, e)
            return
        self._has_checkpoint = True
        self.checkpoints += 1
        self._journal = []

    def _recover(self) -> None:
        """Restore the latest snapshot (or a fresh bank) on the bank's
        device and replay the journal since it, suppressing its matches.

        Replay runs through the same fault sites as live traffic, so a
        recovery can fault mid-replay; the recovered runtime is committed
        only once restore and replay succeed, and failed attempts back off
        as batch retries do.  Quarantine decisions are re-applied before
        the replay, so the replayed traffic is masked as the live traffic
        was."""
        self.recoveries += 1
        last_err: Optional[BaseException] = None
        for attempt in range(32):
            if attempt:
                self._backoff(attempt - 1)
            try:
                if self._has_checkpoint:
                    tenant = restore_tenant(self._patterns, self.checkpoint_path,
                                            **self._tenant_kwargs)
                else:
                    tenant = TenantCEP(self._patterns, self.tenant.num_lanes,
                                       self.tenant.batch.config, **self._tenant_kwargs)
                for name, reason in self.quarantines.items():
                    tenant.quarantine(name, reason)
                for batch in self._journal:
                    tenant.process(batch)  # matches already emitted
            except InputRejected:
                raise
            except Exception as e:
                last_err = e
                continue
            self.tenant = tenant
            return
        raise RuntimeError(f"tenant recovery failed repeatedly; last error: {last_err}")

    def counters(self) -> Dict[str, int]:
        return self.tenant.counters()

    def per_query_counters(self) -> Dict[str, Dict[str, int]]:
        return self.tenant.per_query_counters()

    def admission_ledger(self) -> Dict[str, Dict[str, int]]:
        return self.tenant.admission_ledger()

    def metrics_snapshot(self) -> Dict[str, object]:
        out = self.tenant.metrics_snapshot()
        out["recoveries"] = self.recoveries
        out["checkpoints"] = self.checkpoints
        out["checkpoint_failures"] = self.checkpoint_failures
        out["escalations"] = self.escalations
        out["tenant_escalation_denied"] = self.tenant_escalation_denied
        out["tenant_quarantines"] = self.tenant_quarantines
        out["retry_backoff_ms_total"] = round(self.retry_backoff_ms_total, 3)
        return out
