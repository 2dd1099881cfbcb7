"""Sharded checkpoints in the reference's on-disk format, with HRS-selected
restore sources."""

from .ckpt import (Manifest, choose_restore_sources, latest_step,
                   reshard_for_mesh, restore_checkpoint, save_checkpoint)

__all__ = ["Manifest", "choose_restore_sources", "latest_step",
           "reshard_for_mesh", "restore_checkpoint", "save_checkpoint"]
