"""Checkpointing (port of ``repro.checkpoint``): numpy arrays and a manifest
a step, written asynchronously and atomically."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
