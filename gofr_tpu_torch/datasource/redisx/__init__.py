"""Redis datasource (counterpart of ``gofr_tpu/datasource/redisx``)."""

from gofr_tpu_torch.datasource.redisx.client import (
    InMemoryRedis,
    RedisClient,
    RedisError,
    new_redis,
)

__all__ = ["InMemoryRedis", "RedisClient", "RedisError", "new_redis"]
