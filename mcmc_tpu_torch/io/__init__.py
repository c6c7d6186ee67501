"""Checkpoint / resume of chain farms (single-process layout)."""

from .checkpoint import CheckpointManager, run_with_checkpointing

__all__ = ["CheckpointManager", "run_with_checkpointing"]
