from repro_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES,
    Mesh,
    ShardingResolver,
    constrain,
    local_slice,
    shapes_of,
    shard_shape,
)
