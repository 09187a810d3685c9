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
from kafkastreams_cep_tpu_torch.runtime.overload import OverloadController, OverloadPolicy
from kafkastreams_cep_tpu_torch.runtime.processor import (
    CEPProcessor,
    InputRejected,
    Record,
)
from kafkastreams_cep_tpu_torch.runtime.supervisor import (
    AdaptPolicy,
    HealthReport,
    ShardPolicy,
    Supervisor,
    check_health,
)
from kafkastreams_cep_tpu_torch.runtime.tenant import (
    AdmissionPolicy,
    QuarantinePolicy,
    TenantCEP,
    TenantMisbehave,
    TenantSupervisor,
    load_tenant_checkpoint,
    restore_tenant,
    save_tenant_checkpoint,
)

__all__ = [
    "AdaptPolicy",
    "AdmissionPolicy",
    "CEPBank",
    "CEPProcessor",
    "CheckpointCorrupt",
    "DeadLetter",
    "FlightRecorder",
    "HealthReport",
    "IngestGuard",
    "IngestPolicy",
    "InputRejected",
    "OverloadController",
    "OverloadPolicy",
    "Record",
    "QuarantinePolicy",
    "ShardPolicy",
    "Supervisor",
    "TenantCEP",
    "TenantMisbehave",
    "TenantSupervisor",
    "check_health",
    "load_checkpoint",
    "load_tenant_checkpoint",
    "migrate_processor",
    "move_lanes",
    "plan_rebalance",
    "read_dump",
    "repartition_state",
    "restore_processor",
    "restore_tenant",
    "save_checkpoint",
    "save_tenant_checkpoint",
    "widen_state",
]
