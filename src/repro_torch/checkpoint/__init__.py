"""Training checkpoints in the reference's on-disk format."""
