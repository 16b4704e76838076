"""Parallelism of the port over torch.distributed: data parallelism
(`ddp.py`), the (data, model, pipe) mesh (`mesh.py`) and the model and
pipe axes' collectives (`collectives.py`), the elastic fleet
(`fleet.py`)."""
