from kafkastreams_cep_tpu_torch.parallel.batch import BatchMatcher, sweep_lanes

__all__ = ["BatchMatcher", "sweep_lanes"]
