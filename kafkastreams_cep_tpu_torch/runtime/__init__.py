from kafkastreams_cep_tpu_torch.runtime.bank import CEPBank
from kafkastreams_cep_tpu_torch.runtime.checkpoint import (
    CheckpointCorrupt,
    load_checkpoint,
    restore_processor,
    save_checkpoint,
)
from kafkastreams_cep_tpu_torch.runtime.ingest import (
    DeadLetter,
    IngestGuard,
    IngestPolicy,
)
from kafkastreams_cep_tpu_torch.runtime.migrate import (
    migrate_processor,
    move_lanes,
    plan_rebalance,
    repartition_state,
    widen_state,
)
from kafkastreams_cep_tpu_torch.runtime.flight import FlightRecorder, read_dump
from kafkastreams_cep_tpu_torch.runtime.processor import (
    CEPProcessor,
    InputRejected,
    Record,
)
from kafkastreams_cep_tpu_torch.runtime.supervisor import (
    AdaptPolicy,
    HealthReport,
    Supervisor,
    check_health,
)

__all__ = [
    "AdaptPolicy",
    "CEPBank",
    "CEPProcessor",
    "CheckpointCorrupt",
    "DeadLetter",
    "FlightRecorder",
    "HealthReport",
    "IngestGuard",
    "IngestPolicy",
    "InputRejected",
    "Record",
    "Supervisor",
    "check_health",
    "load_checkpoint",
    "migrate_processor",
    "move_lanes",
    "plan_rebalance",
    "read_dump",
    "repartition_state",
    "restore_processor",
    "save_checkpoint",
    "widen_state",
]
