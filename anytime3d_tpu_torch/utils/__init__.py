"""Logging."""
