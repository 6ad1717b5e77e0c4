"""Deterministic data pipelines of the port."""
