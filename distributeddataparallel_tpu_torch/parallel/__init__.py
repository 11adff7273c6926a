"""Sampler and data-parallel gradient synchronization."""
