from kafkastreams_cep_tpu_torch.pattern.pattern import Pattern, Cardinality, SelectStrategy
from kafkastreams_cep_tpu_torch.pattern.predicate import Matcher, and_, or_, not_, true_
from kafkastreams_cep_tpu_torch.pattern.aggregator import StateAggregator
from kafkastreams_cep_tpu_torch.pattern.query import Query, QueryBuilder

__all__ = [
    "Pattern",
    "Cardinality",
    "SelectStrategy",
    "Matcher",
    "and_",
    "or_",
    "not_",
    "true_",
    "StateAggregator",
    "Query",
    "QueryBuilder",
]
