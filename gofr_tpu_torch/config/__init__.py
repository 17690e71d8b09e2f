"""Configuration (counterpart of ``gofr_tpu/config``)."""

from gofr_tpu_torch.config.config import (Config, EnvConfig, MapConfig,
                                          load_env_file)

__all__ = ["Config", "EnvConfig", "MapConfig", "load_env_file"]
