"""Core: the ERBIUM-style rule engine on the card + its host integration
(rules, compiler, encoder, workload, aggregator, engine, wrapper)."""
from repro_torch.core.compiler import CompiledRuleTable, compile_rules  # noqa
from repro_torch.core.encoder import encode_queries  # noqa
from repro_torch.core.engine import ErbiumEngine  # noqa
from repro_torch.core.rules import RuleSet, generate_queries, generate_rules  # noqa
