"""repro_torch.configs — architecture configs (one module per ported
arch), the port of :mod:`repro.configs`."""

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.configs.registry import (ARCH_IDS, PORTED_ARCH_IDS,
                                          all_configs, get, reduce_config)

__all__ = ["ARCH_IDS", "ArchConfig", "PORTED_ARCH_IDS", "SHAPES",
           "ShapeConfig", "all_configs", "get", "reduce_config"]
