"""Checkpoint substrate: sharded npz save/restore in the JAX package's
layout."""

from .checkpoint import gather_tree, restore_checkpoint, save_checkpoint

__all__ = ["gather_tree", "restore_checkpoint", "save_checkpoint"]
