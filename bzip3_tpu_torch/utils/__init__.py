"""Helpers: per-stage wall-time accounting."""
