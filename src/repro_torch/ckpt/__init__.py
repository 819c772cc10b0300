"""Checkpoints of the training state."""
