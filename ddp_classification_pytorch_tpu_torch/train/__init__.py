"""Step functions, model state and checkpoints of the port (serving's part
of them in slice 1)."""
