"""Config tree for the port: the part of the JAX package's `config.py` that
serving reads, as the port's own copy (the port imports nothing of the JAX
package).

Field names, defaults and the five workload presets are the JAX package's,
so a command line means the same on both sides. Fields for the parts not
ported yet (training, optimizer, parallelism, the serve fleet, hot reload,
the HTTP front end, the AOT sidecar) are left out until their slice lands.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence


@dataclass
class DataConfig:
    """What a request looks like on the wire."""

    dataset: str = "imagefolder"  # imagefolder | synthetic | plc
    image_size: int = 224
    num_classes: int = 2173  # BASELINE/main.py:85
    # request wire format: "uint8" raw HWC pixels, normalized on the device
    # by train/steps.py::device_input_epilogue; "float32" host-normalized
    input_dtype: str = "uint8"


@dataclass
class ModelConfig:
    """Backbone + head selection (only tresnet_m / timm with head fc are
    ported; models/factory.py refuses the rest)."""

    arch: str = "resnet50"
    head: str = "fc"  # fc | arcface | nested
    dtype: str = "bfloat16"  # compute dtype; ABN math, pool and fc stay f32


@dataclass
class RunConfig:
    seed: int = 999  # set_seed(999), BASELINE/main.py:43-50
    out_dir: str = "./runs/default"


@dataclass
class ServeConfig:
    """Inference serving (serve/engine.py, cli/serve.py).

    The engine assembles micro-batches from a bounded request queue under a
    deadline and pads them to a small fixed set of bucket sizes:
    `batch_timeout_ms` bounds the latency a lone request pays waiting for
    company, `max_batch` bounds how much throughput a full queue can
    amortize into one device dispatch.
    """

    max_batch: int = 8  # largest micro-batch the batcher assembles
    # deadline from the FIRST queued request until a partial batch flushes;
    # 0 = never wait (every collect takes whatever is queued right now)
    batch_timeout_ms: float = 5.0
    queue_depth: int = 64  # bounded intake; submits beyond it are rejected
    # padded batch shapes (ascending). () = powers of two up to max_batch.
    buckets: Sequence[int] = ()
    topk: int = 5  # classes returned per request
    checkpoint: str = ""  # explicit checkpoint to serve (verified; rc 2 if corrupt)
    log_every_s: float = 10.0  # metrics console line cadence

    def resolve_buckets(self) -> tuple:
        """Validated ascending bucket tuple (ValueError = config-shaped, the
        serve CLI maps it to rc 2). The port serves on one device: the JAX
        package's data-parallel width is 1 here, so no bucket is rounded."""
        if self.max_batch < 1:
            raise ValueError(f"serve.max_batch must be >= 1, got {self.max_batch}")
        if self.batch_timeout_ms < 0:
            raise ValueError(
                f"serve.batch_timeout_ms must be >= 0, got {self.batch_timeout_ms}")
        if self.queue_depth < 1:
            raise ValueError(f"serve.queue_depth must be >= 1, got {self.queue_depth}")
        if self.topk < 1:
            raise ValueError(f"serve.topk must be >= 1, got {self.topk}")
        if self.buckets:
            buckets = tuple(int(b) for b in self.buckets)
        else:
            buckets, b = [], 1
            while b < self.max_batch:
                buckets.append(b)
                b *= 2
            buckets = tuple(buckets + [self.max_batch])
        if any(b < 1 for b in buckets) or list(buckets) != sorted(set(buckets)):
            raise ValueError(
                f"serve.buckets must be positive and strictly ascending, "
                f"got {buckets}")
        if self.max_batch > buckets[-1]:
            raise ValueError(
                f"serve.max_batch={self.max_batch} exceeds the largest bucket "
                f"{buckets[-1]} — a full batch would have no padded shape to "
                "run at")
        return buckets


@dataclass
class Config:
    workload: str = "baseline"  # baseline | arcface | cdr | nested | plc
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    run: RunConfig = field(default_factory=RunConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)


def baseline_preset() -> Config:
    """BASELINE/main.py defaults: ResNet-50, CE, 2173 classes."""
    return Config(workload="baseline")


def arcface_preset() -> Config:
    """ARCFACE/arc_main.py: ResNet-50 → 256-d embedding + ArcMarginProduct."""
    cfg = Config(workload="arcface")
    cfg.model.head = "arcface"
    return cfg


def cdr_preset() -> Config:
    """CDR/main.py: ResNet-50, first 100 classes."""
    cfg = Config(workload="cdr")
    cfg.data.num_classes = 100
    return cfg


def nested_preset() -> Config:
    """NESTED/train.py: ResNet-50 feat + bias-free linear cls (nested head)."""
    cfg = Config(workload="nested")
    cfg.model.head = "nested"
    return cfg


def plc_preset() -> Config:
    """PLC correction training on Clothing1M-scale data (14 classes)."""
    cfg = Config(workload="plc")
    cfg.data.num_classes = 14  # Clothing1M
    return cfg


PRESETS = {
    "baseline": baseline_preset,
    "arcface": arcface_preset,
    "cdr": cdr_preset,
    "nested": nested_preset,
    "plc": plc_preset,
}


def get_preset(name: str) -> Config:
    try:
        return PRESETS[name]()
    except KeyError:
        raise ValueError(f"unknown workload {name!r}; one of {sorted(PRESETS)}")
