from kafkastreams_cep_tpu_torch.engine.matcher import (
    COUNTER_NAMES,
    EngineConfig,
    EngineState,
    EventBatch,
    MatcherSession,
    StepOutput,
    TPUMatcher,
)

__all__ = [
    "COUNTER_NAMES",
    "EngineConfig",
    "EngineState",
    "EventBatch",
    "MatcherSession",
    "StepOutput",
    "TPUMatcher",
]
