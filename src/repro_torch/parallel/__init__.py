"""Sharding rules, device placement and the model's collectives — the port
of :mod:`repro.parallel` onto ``torch.distributed``."""

from repro_torch.parallel.sharding import (
    DEFAULT_RULES, ShardingRules, activate, active_context, local_shard,
    logical_to_spec, param_shardings, placements,
    replicate_uneven_kv_heads, serve_cache_shardings, serve_rules_for,
    train_rules_for,
)

__all__ = [
    "ShardingRules", "DEFAULT_RULES", "activate", "active_context",
    "local_shard", "logical_to_spec", "param_shardings", "placements",
    "replicate_uneven_kv_heads", "serve_cache_shardings", "serve_rules_for",
    "train_rules_for",
]
