"""Parallelism of the port over torch.distributed: data parallelism
(`ddp.py`), the (data, model) mesh (`mesh.py`) and the model axis's
collectives (`collectives.py`), the elastic fleet (`fleet.py`)."""
