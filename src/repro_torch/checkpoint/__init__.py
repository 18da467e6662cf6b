from repro_torch.checkpoint.checkpointing import CheckpointManager  # noqa: F401
