"""The port's five workload presets against the JAX package's, field by
field, over every field the port's config has (the port's
`parallel.data_parallel` is the JAX `parallel.data_axis`: 0 = every
rank / device)."""

import dataclasses

import pytest

from ddp_classification_pytorch_tpu.config import PRESETS as JAX_PRESETS
from ddp_classification_pytorch_tpu_torch.config import PRESETS

RENAMED = {("parallel", "data_parallel"): "data_axis"}


@pytest.mark.parametrize("workload", sorted(JAX_PRESETS))
def test_preset_equals_jax_field_by_field(workload):
    assert sorted(PRESETS) == sorted(JAX_PRESETS)
    port, ref = PRESETS[workload](), JAX_PRESETS[workload]()
    assert port.workload == ref.workload == workload
    checked = 0
    for section in ("data", "model", "optim", "parallel", "run", "serve"):
        ours, theirs = getattr(port, section), getattr(ref, section)
        for f in dataclasses.fields(ours):
            name = RENAMED.get((section, f.name), f.name)
            a, b = getattr(ours, f.name), getattr(theirs, name)
            if isinstance(a, (list, tuple)):
                a, b = tuple(a), tuple(b)
            assert a == b, f"{workload}: {section}.{f.name} {a!r} != {b!r}"
            checked += 1
    assert checked >= 60
