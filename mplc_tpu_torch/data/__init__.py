"""Datasets, partners and partitioning."""
