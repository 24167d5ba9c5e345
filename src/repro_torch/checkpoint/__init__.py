"""Checkpoint substrate: sharded npz save/restore in the JAX package's
layout."""

from .checkpoint import restore_checkpoint, save_checkpoint

__all__ = ["restore_checkpoint", "save_checkpoint"]
