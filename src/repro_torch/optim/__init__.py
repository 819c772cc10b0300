"""Optimizers and gradient transforms of the trainer."""
