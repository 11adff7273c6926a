"""Synthetic LM data and the per-rank loader."""
