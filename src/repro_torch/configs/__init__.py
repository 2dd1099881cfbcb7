"""Model configurations the serving path runs (the reference's schema)."""

from .base import (SHAPES, ArchConfig, MoEConfig, ShapeConfig, SSMConfig,
                   arch_ids, cells, get_config)

__all__ = ["SHAPES", "ArchConfig", "MoEConfig", "ShapeConfig", "SSMConfig",
           "arch_ids", "cells", "get_config"]
