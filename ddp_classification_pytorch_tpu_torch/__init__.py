"""PyTorch + CUDA port of `ddp_classification_pytorch_tpu`, for an NVIDIA
H100, slice by slice.

The JAX package beside it is the reference and stays as it is; this package
imports torch, numpy and the standard library only — nothing of JAX and
nothing of the JAX package. Modules mirror the JAX package's layout and
names so each has an obvious counterpart there. Every TPU (Pallas) kernel on
a ported path is a hand-written Hopper kernel here, beside a plain PyTorch
version that the CPU tests run.

Ported so far (slice 1): serving TResNet-M — `cli/serve.py` →
`serve/engine.py` → `train/steps.py::make_topk_predict_step` → the model
(`models/tresnet.py`) whose activated ABN sites run K1
(`ops/fused_abn.py`, CUDA source in `ops/csrc/fused_abn.cu`).

Entry points run on `cuda` unless the caller asks for the CPU
(`device="cpu"` / `--device cpu`); with no card and no such request they
refuse (`utils/backend_probe.py`).
"""
