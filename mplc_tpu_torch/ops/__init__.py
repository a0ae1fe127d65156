"""Aggregation, metrics and the reconstruction kernel."""
