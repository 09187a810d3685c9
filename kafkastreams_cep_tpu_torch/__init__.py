"""kafkastreams-cep on PyTorch and CUDA: the SASE+ NFA engine of
``kafkastreams_cep_tpu`` ported to one NVIDIA GPU.

The same Query DSL goes in and the same ``Sequence`` matches come out, in
the same emission order, with the same loss counters.  Entry points run on
``device="cuda"`` by default and raise when there is no GPU;
``device="cpu"`` runs the plain PyTorch path.
"""

from kafkastreams_cep_tpu_torch.engine.matcher import (
    EngineConfig,
    MatcherSession,
    TPUMatcher,
)
from kafkastreams_cep_tpu_torch.nfa.oracle import OracleNFA
from kafkastreams_cep_tpu_torch.parallel import (
    BatchMatcher,
    ShardedMatcher,
    TimeShardedStencil,
    key_mesh,
)
from kafkastreams_cep_tpu_torch.pattern.query import Query
from kafkastreams_cep_tpu_torch.runtime.processor import CEPProcessor, Record
from kafkastreams_cep_tpu_torch.runtime.supervisor import Supervisor

__all__ = [
    "BatchMatcher",
    "CEPProcessor",
    "EngineConfig",
    "MatcherSession",
    "OracleNFA",
    "Query",
    "Record",
    "ShardedMatcher",
    "Supervisor",
    "TPUMatcher",
    "TimeShardedStencil",
    "key_mesh",
]
