"""Multi-query bank: N patterns matched over the same stream.

The counterpart of ``kafkastreams_cep_tpu/runtime/bank.py``.  The reference
runs several queries by wiring one ``CEPProcessor`` per pattern onto the
same topic; :class:`CEPBank` keeps that shape: one port
:class:`CEPProcessor` per named query, each fed every record, its matches
tagged with the query's name.  Each query's device state is its own.  For
same-shape queries stepped as one lane batch see
``parallel/stacked.py``; for a bank sharing one prefix screen,
``parallel/tenantbank.py``.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence as Seq, Tuple

from kafkastreams_cep_tpu_torch.engine.matcher import EngineConfig
from kafkastreams_cep_tpu_torch.runtime.processor import CEPProcessor, Record
from kafkastreams_cep_tpu_torch.utils.events import Sequence
from kafkastreams_cep_tpu_torch.utils.logging import get_logger
from kafkastreams_cep_tpu_torch.utils.metrics import Metrics, merge_counter_dicts

logger = get_logger("runtime.bank")


class CEPBank:
    """N independent queries over one stream of records.

    ``patterns`` maps query name -> built pattern; every query sees every
    record.  ``process`` returns ``(query_name, key, Sequence)`` triples:
    per query in declaration order, each query's matches in its
    processor's emission order.  ``device`` is where every member runs
    (``"cuda"`` by default); every member shares ``trace_sink`` and is
    named after its query."""

    def __init__(self, patterns: Dict[str, object], num_lanes: int,
                 config: Optional[EngineConfig] = None, topic: str = "stream",
                 epoch: Optional[int] = None, trace_sink=None, device="cuda"):
        if not patterns:
            raise ValueError("a bank needs at least one pattern")
        self.processors: Dict[str, CEPProcessor] = {
            name: CEPProcessor(pattern, num_lanes, config, topic=topic, epoch=epoch,
                               trace_sink=trace_sink, name=name, device=device)
            for name, pattern in patterns.items()
        }
        logger.info("bank of %d queries: %s", len(patterns), list(patterns))

    def process(self, records: Seq[Record]) -> List[Tuple[str, Hashable, Sequence]]:
        out: List[Tuple[str, Hashable, Sequence]] = []
        for name, proc in self.processors.items():
            out.extend((name, key, seq) for key, seq in proc.process(records))
        return out

    def counters(self) -> Dict[str, Dict[str, int]]:
        return {name: p.counters() for name, p in self.processors.items()}

    def metrics_snapshot(self) -> Dict[str, object]:
        """Bank-wide telemetry: the members' registries merged (runtime
        counters summed, phase latency histograms aggregated exactly: the
        merge is associative, so this equals one registry that observed
        every member's batches) and snapshotted with the members' engine
        loss, hot-tier and walk counters summed; ``per_stage`` merged by
        stage name (selectivity re-derived from the merged tallies) and the
        un-merged ``per_pattern`` breakdown."""
        procs = list(self.processors.values())
        reg = procs[0].metrics.registry
        for p in procs[1:]:
            reg = reg.merge(p.metrics.registry)
        engine = merge_counter_dicts(
            [{**p.counters(), **p.hot_counters(), **p.walk_counters()} for p in procs]
        )
        snap: Dict[str, object] = Metrics(registry=reg).snapshot(engine)
        per_stage: Dict[str, Dict[str, object]] = {}
        for p in procs:
            for stage, row in p.batch.stage_counters(p.state).items():
                dst = per_stage.setdefault(stage, {})
                for metric, v in row.items():
                    if metric == "selectivity":
                        continue
                    if metric == "conjuncts":
                        cd = dst.setdefault("conjuncts", {})
                        for key, tallies in v.items():
                            slot = cd.setdefault(key, {"evals": 0, "accepts": 0})
                            slot["evals"] += tallies["evals"]
                            slot["accepts"] += tallies["accepts"]
                        continue
                    dst[metric] = dst.get(metric, 0) + v
        for row in per_stage.values():
            ev = row.get("stage_evals", 0)
            row["selectivity"] = round(row.get("stage_accepts", 0) / ev, 6) if ev else 0.0
            for slot in row.get("conjuncts", {}).values():
                slot["selectivity"] = (slot["accepts"] / slot["evals"]
                                       if slot["evals"] else None)
        if per_stage:
            snap["per_stage"] = per_stage
        snap["per_pattern"] = {
            name: {
                **p.counters(), **p.hot_counters(), **p.walk_counters(),
                "records_in": p.metrics.records_in,
                "matches_out": p.metrics.matches_out,
            }
            for name, p in self.processors.items()
        }
        return snap
