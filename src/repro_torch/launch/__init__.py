"""Launchers of the port: ``serve`` (model + engine + semantic planner)."""
