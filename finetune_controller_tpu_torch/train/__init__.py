"""The training path: losses, optimizer, checkpoints, the trainer and its CLI."""
