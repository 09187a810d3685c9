from kafkastreams_cep_tpu_torch.parallel.batch import BatchMatcher, sweep_lanes
from kafkastreams_cep_tpu_torch.parallel.seqpar import TimeShardedStencil
from kafkastreams_cep_tpu_torch.parallel.sharding import (
    Mesh,
    ShardedMatcher,
    ShardedState,
    ShardLost,
    key_mesh,
    surviving_mesh,
)
from kafkastreams_cep_tpu_torch.parallel.stacked import StackedBankMatcher, choose_bank
from kafkastreams_cep_tpu_torch.parallel.tenantbank import TenantBankMatcher

__all__ = ["BatchMatcher", "Mesh", "ShardLost", "ShardedMatcher", "ShardedState",
           "StackedBankMatcher", "TenantBankMatcher", "TimeShardedStencil", "choose_bank",
           "key_mesh", "surviving_mesh", "sweep_lanes"]
