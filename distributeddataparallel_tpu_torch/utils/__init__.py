"""Logging and step metrics of the port's trainer."""
