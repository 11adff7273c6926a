"""Attention (plain and flash kernels) and losses."""
