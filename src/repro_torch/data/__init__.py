"""Surrogate corpora and the paper's query protocol, made on the device;
the LM token pipeline."""
