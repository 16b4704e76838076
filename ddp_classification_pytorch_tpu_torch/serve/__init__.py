"""Inference serving of the port: the micro-batching engine and its
metrics, the HTTP front end, checkpoint hot reload, and the fleet and
admission layers. Entry point: `cli/serve.py`."""
