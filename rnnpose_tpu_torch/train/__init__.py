"""Training: losses, optimizer, train step and loop, checkpoints, logs."""
