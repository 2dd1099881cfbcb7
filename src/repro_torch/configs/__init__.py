"""Model configurations the serving path runs (the reference's schema)."""

from .base import (ArchConfig, MoEConfig, SSMConfig, arch_ids, get_config)

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "arch_ids", "get_config"]
