"""Inference serving of the port: the micro-batching engine and its metrics.
Entry point: `cli/serve.py`."""
