"""Observability of the port: the stdlib metrics registry."""
