"""Launchers of the port: ``serve`` (model + engine + semantic planner) and
``train`` (the fault-tolerant training driver)."""
