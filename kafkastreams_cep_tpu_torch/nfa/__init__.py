from kafkastreams_cep_tpu_torch.nfa.dewey import DeweyVersion
from kafkastreams_cep_tpu_torch.nfa.buffer import SharedVersionedBuffer
from kafkastreams_cep_tpu_torch.nfa.oracle import OracleNFA

__all__ = ["DeweyVersion", "SharedVersionedBuffer", "OracleNFA"]
