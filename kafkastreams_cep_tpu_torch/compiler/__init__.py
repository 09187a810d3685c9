from kafkastreams_cep_tpu_torch.compiler.stages import (
    Edge,
    EdgeOperation,
    Stage,
    StageType,
    compile_pattern,
)
from kafkastreams_cep_tpu_torch.compiler.tables import TransitionTables, lower

__all__ = [
    "Edge",
    "EdgeOperation",
    "Stage",
    "StageType",
    "TransitionTables",
    "compile_pattern",
    "lower",
]
