from repro_torch.distributed.sharding import (  # noqa: F401
    ShardingRules,
    current_rules,
    logical_constraint,
    logical_to_spec,
    set_rules,
)
