from kafkastreams_cep_tpu_torch.parallel.batch import BatchMatcher, sweep_lanes
from kafkastreams_cep_tpu_torch.parallel.stacked import StackedBankMatcher, choose_bank
from kafkastreams_cep_tpu_torch.parallel.tenantbank import TenantBankMatcher

__all__ = ["BatchMatcher", "StackedBankMatcher", "TenantBankMatcher", "choose_bank",
           "sweep_lanes"]
