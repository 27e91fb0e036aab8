"""Atomic, versioned snapshots of named numpy arrays."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
