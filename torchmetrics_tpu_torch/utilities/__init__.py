"""Utilities shared by the port's metrics."""
