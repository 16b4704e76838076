"""`--debug_nans` in the torch port (`utils/debug_nans.py`), on the CPU.

- A NaN born in a forward op raises `FloatingPointError` naming the op;
  one born in the backward (sqrt's gradient at 0 times 0) is caught
  there, inside `loss.backward()`.
- `empty` hands back uninitialised memory and is not checked; an
  infinity passes (jax_debug_nans checks NaNs only); outside the mode
  nothing is checked, and a kernel wrapper's `check_outputs` is a no-op.
- The sentinel case: a clean TResNet-M step passes under the mode (its
  ABNs through the K1 family's plain versions, K1's wrapper included),
  and a `nan_loss` fault step raises instead of being skipped, as under
  `jax_debug_nans`; `cli/train.py --debug_nans` exits non-zero with the
  op named.
"""

import pytest
import torch

from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
from ddp_classification_pytorch_tpu_torch.config import get_preset
from ddp_classification_pytorch_tpu_torch.train import steps
from ddp_classification_pytorch_tpu_torch.train.state import create_train_state
from ddp_classification_pytorch_tpu_torch.utils import chaos
from ddp_classification_pytorch_tpu_torch.utils.debug_nans import (
    NanCheck,
    check_outputs,
)
from torch_port_threads import one_torch_thread  # noqa: F401


def test_a_forward_nan_raises_naming_the_op():
    x = torch.tensor([1.0, -1.0])
    with NanCheck(), pytest.raises(FloatingPointError, match="aten.sqrt"):
        torch.sqrt(x)
    torch.sqrt(x)  # outside the mode: no check


def test_a_backward_nan_is_caught_in_the_backward():
    x = torch.zeros(3, requires_grad=True)
    with NanCheck():
        y = (torch.sqrt(x) * 0.0).sum()  # a finite forward: 0
        assert float(y) == 0.0
        with pytest.raises(FloatingPointError, match="NaN in the output of"):
            y.backward()  # d/dx = 0 · (0.5 / sqrt(0)) = 0 · inf


def test_empty_and_infinities_are_not_flagged():
    nan = torch.tensor([float("nan")])  # made outside: its creation is an op
    with NanCheck():
        for _ in range(4):
            torch.empty(1024).fill_(1.0)
            torch.empty_like(torch.zeros(8, 8))
        assert torch.isinf(torch.tensor([1.0]) / 0.0).all()
        check_outputs("K1", torch.ones(2))
        with pytest.raises(FloatingPointError, match="kernel K1"):
            check_outputs("K1", nan)
    check_outputs("K1", nan)  # off: a no-op


def _cfg():
    cfg = get_preset("baseline")
    cfg.model.arch, cfg.model.dtype = "tresnet_m", "float32"
    cfg.data.dataset, cfg.data.input_dtype = "synthetic", "float32"
    cfg.data.image_size, cfg.data.num_classes = 32, 5
    return cfg


def test_a_clean_step_passes_and_a_nan_loss_step_raises(tmp_path):
    cfg = _cfg()
    state = create_train_state(cfg, torch.device("cpu"), 2)
    images = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([1, 3])
    plan = chaos.plan_for_run("nan_loss@step=1", str(tmp_path))
    step = steps.make_train_step(cfg, chaos=plan)
    with NanCheck():
        m = step(state, images, labels)
    assert float(m["step_ok"]) == 1.0 and state.opt_count == 1
    with NanCheck(), pytest.raises(FloatingPointError, match="full_like"):
        step(state, images, labels)
    m = step(state, images, labels)  # the same step without the mode:
    assert float(m["step_ok"]) == 0.0  # skipped, for the sentinel to count
    assert state.opt_count == 1


def test_cli_debug_nans_stops_a_nan_loss_run(tmp_path, capsys):
    argv = ["baseline", "--dataset", "synthetic", "--synthetic_size", "8",
            "--model", "vit_t16", "--image_size", "32", "--num_classes", "5",
            "--batchsize", "4", "--epochs", "1", "--dtype", "float32",
            "--device", "cpu", "--out", str(tmp_path / "r"), "--debug_nans",
            "--fault_spec", "nan_loss@step=1"]
    with pytest.raises(FloatingPointError, match="full_like"):
        train_cli.main(argv)
