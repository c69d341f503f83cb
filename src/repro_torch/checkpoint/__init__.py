"""Fault-tolerant checkpointing: step-atomic npz shards with JSON metadata,
resume from the newest verifiable step, bounded retention."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
