"""Fault tolerance of the training driver."""
