"""Model state — the JAX package's `train/state.py`: the training state
(`create_train_state`) and the served model (`create_served_model`).

In PyTorch the module holds its own weights, so the "state" the engine
serves and swaps is the `nn.Module` itself; the training state bundles the
module (f32 master weights) with its optimizer, LR schedule and counters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ..config import Config
from ..models.factory import build_model, shard_params_
from ..models.heads import ArcMarginHead
from ..models.import_torch import import_state_dict, load_torch_checkpoint
from ..models.pipeline_vit import gpipe_vit
from ..models.resnet import DEPTHS as RESNET_DEPTHS
from ..models.resnet import ResNet
from ..models.tresnet import TResNet
from ..models.vgg import CFG_E, VGG
from ..models.vit import MOE_WEIGHTS, VIT_CONFIGS, xavier_uniform_
from ..parallel.collectives import all_gather, axis_index, axis_size
from ..parallel.mesh import Mesh
from .schedule import (
    Schedule,
    build_optimizer,
    build_schedule,
    head_config,
    is_zero,
    param_groups,
    two_groups,
    zero_enabled,
)

# jax.nn.initializers' truncated normal: the stddev of a standard normal cut
# at ±2, by which `variance_scaling(..., "truncated_normal")` divides
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_(w: torch.Tensor, scale: float, fan: int,
                      generator: torch.Generator) -> torch.Tensor:
    """flax's `variance_scaling(scale, mode, "truncated_normal")` in place:
    a normal of σ = sqrt(scale / fan) / _TRUNC_STD cut at ±2σ."""
    std = (scale / fan) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh weights from `generator`: biases zero; BN keeps its
    construction values (γ=1, β=0, mean 0, var 1), as flax's. A ResNet
    starts from the JAX ResNet's distribution: its convs take
    `variance_scaling(2.0, "fan_out", "truncated_normal")` with fan_out =
    O·kh·kw (JAX `models/resnet.py:132-133`), its fc and the heads' Dense
    layers LeCun normal (flax's Dense default, a truncated normal of
    fan_in), and the ArcFace margin's (C, D) weight flax's xavier-uniform,
    U(±sqrt(6 / (C + D))) (JAX `models/heads.py:68-73`). The other archs'
    conv and linear weights are N(0, 1/fan_in); a MoE ViT's router and
    expert banks flax's xavier-uniform with the expert count in both fans
    (JAX `models/vit.py:128-132`), its expert biases zero. A pipelined
    ViT's patch conv, Dense layers and fc (and its arcface embedding's)
    take flax's truncated normal of fan_in, as the ResNet's Dense layers
    (JAX `models/pipeline_vit.py:58-87`). `torch.Generator` and
    `jax.random` give different numbers from one seed; parity tests carry
    weights across with `models/convert.py`."""
    resnet = any(isinstance(m, ResNet) for m in model.modules())
    lecun = resnet or gpipe_vit(model) is not None
    with torch.no_grad():
        for m in model.modules():
            if not isinstance(m, (nn.Conv2d, nn.Linear)):
                continue
            fan_in = m.weight[0].numel()
            if resnet and isinstance(m, nn.Conv2d):
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                _variance_scaling_(m.weight, 2.0, fan_out, generator)
            elif lecun:
                _variance_scaling_(m.weight, 1.0, fan_in, generator)
            else:
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        for m in model.modules():
            if isinstance(m, ArcMarginHead):
                bound = (6.0 / sum(m.weight.shape)) ** 0.5
                m.weight.uniform_(-bound, bound, generator=generator)
        for name, p in model.named_parameters():
            if name.endswith("pos_embed"):  # the ViT's N(0, 0.02), as flax's
                p.normal_(0.0, 0.02, generator=generator)
            elif name.rsplit(".", 1)[-1] in MOE_WEIGHTS:
                xavier_uniform_(p, generator)  # the experts' banks
    return model


def load_pretrained_(backbone: nn.Module, path: str) -> nn.Module:
    """Overlay a torchvision or timm state dict onto `backbone` in place,
    the converter chosen by the backbone's arch as the JAX
    `_load_pretrained` chooses it (`train/state.py:108-146`): a ResNet or
    VGG19-BN takes torchvision's names, TResNet-M timm's
    (`models/import_torch.py`). The classifier loads only when its shape
    fits the model's head (the reference replaces a 1000-class head:
    otherwise it keeps its init); tensors the file lacks keep their init.
    A key the model does not have, a shape that does not fit, or a file
    with nothing to load is a ValueError."""
    fam = ("vgg" if isinstance(backbone, VGG) else
           "tresnet" if isinstance(backbone, TResNet) else
           "resnet" if isinstance(backbone, ResNet) else None)
    if fam is None:
        raise ValueError(f"no torchvision/timm import for a "
                         f"{type(backbone).__name__} backbone (ported: the "
                         "ResNets, vgg19_bn, tresnet_m)")
    load = import_state_dict(fam, load_torch_checkpoint(path),
                             backbone.state_dict(),
                             getattr(backbone, "cfg", CFG_E))
    backbone.load_state_dict(load, strict=False)
    return backbone


class _Stages(NamedTuple):
    """A stage-split pipelined ViT as its checkpoints see it: the stage
    group, the blocks' name prefix, the stage count, this stage and the
    blocks a stage."""

    group: Any
    prefix: str
    size: int
    index: int
    per_stage: int

    def is_block(self, name: str) -> bool:
        return name.startswith(self.prefix)

    def renamed(self, name: str, stage: int) -> str:
        """This stage's block param `name` as `stage`'s same block's."""
        i, rest = name[len(self.prefix):].split(".", 1)
        return (f"{self.prefix}{(stage - self.index) * self.per_stage + int(i)}"
                f".{rest}")


@dataclasses.dataclass
class TrainState:
    """Everything a train step reads and updates.

    `step` counts train steps (skipped ones too); `opt_count` counts the
    updates applied — the count optax keeps in its optimizer state, which
    the schedules read, so a skipped step does not advance the lr.
    `schedule` sets the base group's lr, `head_schedule` that of the head
    group (`train/schedule.py::param_groups`) where there is one."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0
    opt_count: int = 0
    # the DistributedDataParallel wrapper of `model` that the train step
    # runs the forward through (parallel/ddp.py), None without a process
    # group; `model` stays the unwrapped module whose state is saved
    ddp: Optional[nn.Module] = None
    head_schedule: Optional[Schedule] = None
    # the loader's steps an epoch (CDR's live clip schedule is per epoch)
    steps_per_epoch: int = 1
    # the (data, model) mesh (parallel/mesh.py), None for one rank; and
    # {name: dim} of the parameters that hold their model-axis shard
    mesh: Optional[Mesh] = None
    shard_dims: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the whole train state a model axis's `consolidate` gathered
    _gathered: Optional[Dict[str, Any]] = None

    @property
    def model_sharded(self) -> bool:
        return self.mesh is not None and self.mesh.mp > 1

    @property
    def stage_sharded(self) -> bool:
        """Whether a pipelined ViT's blocks are split over stages."""
        pipe = gpipe_vit(self.model)
        return pipe is not None and axis_size(pipe.group) > 1

    def _opt_names(self) -> List[str]:
        """The names of the optimizer's params in its index order."""
        name_of = {id(p): n for n, p in self.model.named_parameters()}
        return [name_of[id(p)] for p in self.params]

    def _stages(self) -> "_Stages":
        pipe = gpipe_vit(self.model)
        prefix = next(n for n, m in self.model.named_modules() if m is pipe)
        size = axis_size(pipe.group)
        return _Stages(pipe.group, f"{prefix}.blocks." if prefix else
                       "blocks.", size, axis_index(pipe.group),
                       pipe.depth // size)

    def _whole_names(self, names: List[str]) -> List[str]:
        """`names` (this stage's, in order) with the run of its blocks'
        names replaced by every stage's, block after block: the order of
        the one-rank model's."""
        st = self._stages()
        run = [i for i, nm in enumerate(names) if st.is_block(nm)]
        if not run:
            return list(names)
        lo, hi = run[0], run[-1] + 1
        return (names[:lo] + [st.renamed(nm, p) for p in range(st.size)
                              for nm in names[lo:hi]] + names[hi:])

    def _gather_stages(self, sd: Dict[str, Any]) -> Dict[str, Any]:
        """`sd` (this stage's, `state_dict`'s layout) with every stage's
        blocks and their optimizer state: one all-gather over the stage
        group a tensor, in the order every stage walks alike; the
        optimizer's indices those of the one-rank model."""
        st = self._stages()

        def gather(v: Any) -> List[Any]:
            if not isinstance(v, torch.Tensor):
                return [v] * st.size  # a block's non-tensor entry, alike
            return list(all_gather(v.detach()[None], st.group, 0).unbind(0))

        model: Dict[str, Any] = {}
        for k, v in sd["model"].items():
            if not st.is_block(k):
                model[k] = v
                continue
            for p, part in enumerate(gather(v)):
                model[st.renamed(k, p)] = part
        names = self._opt_names()
        whole = self._whole_names(names)
        index = {nm: i for i, nm in enumerate(whole)}
        osd = dict(sd["optimizer"])
        state: Dict[int, Any] = {}
        for i, nm in enumerate(names):
            entry = osd["state"].get(i)
            if entry is None:
                continue
            if not st.is_block(nm):
                state[index[nm]] = entry
                continue
            parts = {key: gather(v) for key, v in sorted(entry.items())}
            for p in range(st.size):
                state[index[st.renamed(nm, p)]] = {
                    key: v[p] for key, v in parts.items()}
        osd["state"] = dict(sorted(state.items()))
        osd["param_groups"] = self._index_groups(osd["param_groups"], names,
                                                 whole)
        return {**sd, "model": model, "optimizer": osd}

    def _index_groups(self, groups: List[Dict[str, Any]], names: List[str],
                      to: List[str]) -> List[Dict[str, Any]]:
        """`groups` (indices into `names`) re-indexed into `to`: a block's
        group is that of this stage's blocks."""
        st = self._stages()

        def key(nm: str) -> str:
            return st.prefix if st.is_block(nm) else nm

        of = {key(names[i]): g for g, group in enumerate(groups)
              for i in group["params"]}
        out = [{**group, "params": []} for group in groups]
        for j, nm in enumerate(to):
            out[of[key(nm)]]["params"].append(j)
        return out

    def _cut_stages(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        """A whole state (the one-rank model's) cut to this stage's
        blocks, its optimizer indices this model's."""
        st = self._stages()
        own = {k for k in self.model.state_dict() if st.is_block(k)}
        model = {k: v for k, v in sd["model"].items()
                 if not st.is_block(k) or k in own}
        names = self._opt_names()
        whole = self._whole_names(names)
        index = {nm: i for i, nm in enumerate(whole)}
        osd = dict(sd["optimizer"])
        if len(whole) != sum(len(g["params"]) for g in osd["param_groups"]):
            raise ValueError(
                f"checkpoint does not fit this model and optimizer: its "
                f"optimizer holds "
                f"{sum(len(g['params']) for g in osd['param_groups'])} "
                f"params, the model {len(whole)}")
        state = {i: osd["state"][index[nm]] for i, nm in enumerate(names)
                 if index[nm] in osd["state"]}
        osd["state"] = state
        osd["param_groups"] = self._index_groups(osd["param_groups"], whole,
                                                 names)
        return {**sd, "model": model, "optimizer": osd}

    def _opt_shard_dims(self) -> Dict[int, int]:
        """{index in the optimizer's state: shard dim} of the sharded
        params (the plain optimizer's index over its groups)."""
        name_of = {id(p): n for n, p in self.model.named_parameters()}
        return {i: self.shard_dims[name_of[id(p)]]
                for i, p in enumerate(self.params)
                if name_of.get(id(p)) in self.shard_dims}

    def _reshard(self, sd: Mapping[str, Any], gather: bool
                 ) -> Dict[str, Any]:
        """`sd` (`state_dict`'s layout) with every model-axis shard
        gathered whole over the model group (`gather`, a collective) or
        a whole tensor cut to this rank's shard."""
        mesh = self.mesh

        def fix(t: Any, dim: int) -> Any:
            if not isinstance(t, torch.Tensor) or t.dim() <= dim:
                return t
            if gather:
                return all_gather(t.detach(), mesh.model_group, dim)
            n = t.shape[dim] // mesh.mp
            return t.narrow(dim, mesh.model_index * n, n).clone()

        model = {k: fix(v, self.shard_dims[k]) if k in self.shard_dims else v
                 for k, v in sd["model"].items()}
        osd = dict(sd["optimizer"])
        dims = self._opt_shard_dims()
        osd["state"] = {i: ({k: fix(v, dims[i]) for k, v in st.items()}
                            if i in dims else st)
                        for i, st in osd["state"].items()}
        return {**sd, "model": model, "optimizer": osd}

    @property
    def params(self) -> List[nn.Parameter]:
        """The params the optimizer updates (freeze-BN's are not); under
        ZeRO-1 every rank's, from its global groups."""
        return [p for group in self.optimizer.param_groups
                for p in group["params"]]

    def consolidate(self) -> None:
        """Gather the train state where rank 0's `state_dict` reads it: a
        collective, every rank calls it. Under ZeRO-1 every rank's share
        of the optimizer state goes to the data group's first rank; over
        a model axis the ranks of data index 0 then gather each sharded
        tensor (weights and their optimizer state) whole over their model
        group, and a pipelined ViT's stages gather every stage's blocks
        (and their optimizer state) over their stage group, so the file
        holds the one-rank format with all L blocks; the async writer's
        host copy is taken after. A no-op otherwise."""
        if is_zero(self.optimizer):
            self.optimizer.consolidate_state_dict(to=0)
        if self._split and self.mesh.data_index == 0:
            sd = self._local_state_dict()
            if self.model_sharded:
                sd = self._reshard(sd, True)
            if self.stage_sharded:
                sd = self._gather_stages(sd)
            self._gathered = sd

    @property
    def _split(self) -> bool:
        """Whether this rank holds only part of the model."""
        return self.model_sharded or self.stage_sharded

    def optimizer_state_dict(self) -> Dict[str, Any]:
        """The optimizer's state in the plain optimizer's format (`state`
        keyed by the param's index over the groups, `param_groups` with
        index lists and every hyperparameter), which a run with or
        without ZeRO-1, at any world size, loads: JAX's "checkpoints hold
        the gathered full state". Under ZeRO-1, on rank 0 after
        `consolidate`."""
        opt = self.optimizer
        if not is_zero(opt):
            return opt.state_dict()
        sd = opt.state_dict()
        # ZeRO's own groups carry only the hyperparameters it was given;
        # its inner optimizer's carry the class's defaults too
        for group, inner in zip(sd["param_groups"], opt.optim.param_groups):
            for key, value in inner.items():
                if key != "params":
                    group.setdefault(key, value)
        return sd

    def set_lrs(self) -> None:
        """Each group's lr from its schedule at `opt_count`."""
        for group in self.optimizer.param_groups:
            sched = self.head_schedule if group.get("head") else self.schedule
            group["lr"] = sched(self.opt_count)

    def state_dict(self) -> Dict[str, Any]:
        """What resuming needs: the model's f32 master weights and buffers
        (BN running statistics), the optimizer's state (momentum buffers;
        `optimizer_state_dict`), `step` and `opt_count` (the count the
        schedule reads). The tensors are the live ones, not copies. Over
        a model axis or stages, the whole state `consolidate` gathered
        (once)."""
        if self._split:
            if self._gathered is None:
                raise RuntimeError("a model-sharded state is read whole "
                                   "after consolidate() on every rank")
            sd, self._gathered = self._gathered, None
            return sd
        return self._local_state_dict()

    def _local_state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer_state_dict(),
                "step": self.step, "opt_count": self.opt_count}

    def load_state_dict(self, sd: Mapping[str, Any]) -> None:
        """Restore `state_dict()`'s output in place: tensors are copied into
        the model's own, and the optimizer's state is moved to each
        parameter's device and dtype. Raises ValueError when `sd` is not
        a train state or does not fit the model. A whole state is cut to
        this rank's class shards and stage blocks, so a run resumes at any
        (dp, mp, pp)."""
        missing = [k for k in ("model", "optimizer", "step", "opt_count")
                   if k not in sd]
        if missing:
            raise ValueError(f"not a train-state checkpoint (no "
                             f"{', '.join(missing)}): it holds weights only "
                             "and cannot be resumed from")
        if self.stage_sharded:  # every block → this stage's
            sd = self._cut_stages(sd)
        if self.model_sharded:  # whole tensors → this rank's shards
            sd = self._reshard(sd, False)
        osd = sd["optimizer"]
        if is_zero(self.optimizer):  # it clears the other ranks' entries
            osd = {**osd, "state": dict(osd["state"])}
        try:
            self.model.load_state_dict(sd["model"])
            self.optimizer.load_state_dict(osd)
        except (RuntimeError, KeyError, IndexError) as e:  # keys, shapes
            raise ValueError(f"checkpoint does not fit this model and "
                             f"optimizer: {e}") from None
        self.step, self.opt_count = int(sd["step"]), int(sd["opt_count"])


TRESNET_ARCHS = ("tresnet_m", "timm")
# channels_last on the device
CONV_ARCHS = (*RESNET_DEPTHS, "vgg19_bn", *TRESNET_ARCHS)
TRAIN_ARCHS = (*CONV_ARCHS, *VIT_CONFIGS)


def create_train_state(cfg: Config, device: torch.device,
                       steps_per_epoch: int,
                       group: Optional[dist.ProcessGroup] = None,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """Model with fresh f32 master weights from `run.seed` (or, with
    `model.pretrained`, its backbone overlaid with `pretrained_path`'s
    torchvision or timm weights) on `device`, its optimizer
    (`param_groups`: the head group, freeze-BN) and LR schedules. Every
    ported arch trains under every head; anything else is a ValueError.
    `group` is the process group whose ranks share the ResNet and VGG BNs'
    batch statistics, and over which ZeRO-1 (`parallel.zero_opt`, on when
    it has more than one rank unless off) shards the optimizer state. The
    schedules count optimizer updates (`parallel.grad_accum`). The conv
    nets go to the device in channels_last, as K1 and its training passes
    take their activations (weights in NCHW could lead cuDNN to hand back
    NCHW outputs). A `mesh` with a model axis (`group` is then its data
    group) builds the model whole, draws its init, and keeps this rank's
    shards (`models/factory.py::shard_params_`); with
    `parallel.pipeline_microbatches` the pipelined ViT, whose stage keeps
    its own blocks the same way."""
    if cfg.model.arch not in TRAIN_ARCHS:
        raise ValueError(f"training arch {cfg.model.arch!r} not yet ported "
                         f"to the torch package (ported: "
                         f"{', '.join(TRAIN_ARCHS)}; ROADMAP.md)")
    model = build_model(cfg.model, cfg.data.num_classes, cfg.data.image_size,
                        group, mesh, cfg.parallel.pipeline_microbatches)
    init_weights_(model, torch.Generator().manual_seed(cfg.run.seed))
    if cfg.model.pretrained:
        if not cfg.model.pretrained_path:
            raise ValueError("model.pretrained needs model.pretrained_path: "
                             "nothing is downloaded; pass a local .pth "
                             "(a torchvision or timm state_dict, or the "
                             "reference's NESTED format) with "
                             "--pretrained_path")
        load_pretrained_(model.backbone, cfg.model.pretrained_path)
    shard_dims = shard_params_(model, mesh)
    if cfg.model.arch in CONV_ARCHS:
        model.to(device=device, memory_format=torch.channels_last)
    else:
        model.to(device)
    opt = cfg.optim
    world = dist.get_world_size(group) if group is not None else 1
    accum = max(int(cfg.parallel.grad_accum), 1)
    return TrainState(
        model=model,
        optimizer=build_optimizer(
            opt, param_groups(opt, model, cfg.model.freeze_bn),
            zero=zero_enabled(cfg.parallel.zero_opt, world), group=group),
        schedule=build_schedule(opt, steps_per_epoch, accum),
        head_schedule=(build_schedule(head_config(opt), steps_per_epoch,
                                      accum)
                       if two_groups(opt) else None),
        steps_per_epoch=steps_per_epoch, mesh=mesh, shard_dims=shard_dims)


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())


def create_served_model(cfg: Config, device: torch.device,
                        state_dict: Optional[Mapping[str, torch.Tensor]] = None
                        ) -> nn.Module:
    """Build the served model for `cfg` on `device`: init from `run.seed`
    (or load `state_dict`, e.g. a verified checkpoint), then apply the
    dtype policy once (the convolutional nets cast their weights to the
    compute dtype; a ViT keeps its f32 masters and casts per call, as in
    training), move to the device (channels_last for the convolutional
    nets), and set eval mode. A ViT built from a config with
    `model.flash_attention` runs the flash forward (K2) in every block at
    T ≥ `flash_min_tokens`. Raises ValueError for an arch or head not
    ported yet."""
    if cfg.model.arch not in TRAIN_ARCHS:
        raise ValueError(f"serving arch {cfg.model.arch!r} not yet ported to "
                         f"the torch package (ported: "
                         f"{', '.join(TRAIN_ARCHS)}; ROADMAP.md)")
    model = build_model(cfg.model, cfg.data.num_classes, cfg.data.image_size)
    if state_dict is None:
        init_weights_(model, torch.Generator().manual_seed(cfg.run.seed))
    else:
        try:
            model.load_state_dict(state_dict)
        except RuntimeError as e:  # missing/unexpected keys, wrong shapes
            raise ValueError(f"weights do not fit {cfg.model.arch} with "
                             f"{cfg.data.num_classes} classes: {e}") from None
    if cfg.model.arch in CONV_ARCHS:
        model.backbone.cast_to_compute_dtype()
        model.to(device=device, memory_format=torch.channels_last)
    else:
        model.to(device)
    return model.eval()
