"""Timing, tracing and introspection helpers."""
