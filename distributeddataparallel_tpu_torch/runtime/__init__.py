"""Process-group runtime."""
