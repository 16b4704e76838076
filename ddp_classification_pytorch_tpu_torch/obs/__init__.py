"""Observability of the port: the stdlib metrics registry and the event
plane (`events.jsonl`)."""
