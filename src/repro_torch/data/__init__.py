"""The synthetic, grid-placed token pipeline of the training path."""

from .pipeline import (DataConfig, GridDataLoader, SyntheticShardedDataset,
                       shard_name)

__all__ = ["DataConfig", "GridDataLoader", "SyntheticShardedDataset",
           "shard_name"]
