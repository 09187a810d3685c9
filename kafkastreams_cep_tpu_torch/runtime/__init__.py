from kafkastreams_cep_tpu_torch.runtime.processor import (
    CEPProcessor,
    InputRejected,
    Record,
)

__all__ = ["CEPProcessor", "InputRejected", "Record"]
