"""Deterministic synthetic data pipelines."""
