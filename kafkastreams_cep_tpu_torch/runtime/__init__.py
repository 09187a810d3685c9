from kafkastreams_cep_tpu_torch.runtime.bank import CEPBank
from kafkastreams_cep_tpu_torch.runtime.processor import (
    CEPProcessor,
    InputRejected,
    Record,
)

__all__ = ["CEPBank", "CEPProcessor", "InputRejected", "Record"]
