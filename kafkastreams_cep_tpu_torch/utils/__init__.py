from kafkastreams_cep_tpu_torch.utils.events import Event, Sequence

__all__ = ["Event", "Sequence"]
