"""The device mesh of the port — the counterpart of the JAX package's
`parallel/mesh.py`.

Training: the ranks of a torchrun world (one process a card) laid out as
a (data, model) mesh, or with `pipeline_parallel` above 1 a (data,
model, pipe) mesh (JAX `mesh.py:36-95`). `MeshSpec` resolves its axes
against the world with JAX's rule and text; `make_mesh` gives every rank
its data group (the ranks holding the same model shard: DDP, ZeRO-1, the
BN statistics, the metrics), its model group (the ranks of one data
shard: ring attention's token axis, expert parallelism, the
class-sharded heads) and its pipe group (the GPipe stages,
`ops/pipeline.py`). The pipe axis is innermost, as JAX's axis order
puts it: rank = (d·mp + m)·pp + p, so a stage ring is contiguous ranks
and the pp = 1 table is the (data, model) one. Model groups are then
contiguous too, so on a node they ride NVLink, as JAX keeps the model
axis on ICI neighbours; `make_hybrid_mesh` spans the data axis across
nodes and keeps every model group inside one (`:140-196`). `shard_dim`
is JAX's `_spec_for_param` (`:231-270`) in the port's parameter names,
and `block_stage` its stage rule.

Serving is pure data parallelism: a padded bucket splits into equal row
blocks, one a device, each device holding its own replica of the model
(`serve/engine.py`). There is no model axis to feed, so a list of devices
is the whole mesh (`serve_devices`).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """data_parallel=0 → every rank left over goes on the data axis;
    `pipeline_parallel` above 1 adds the pipe axis (`--pp_stages`)."""

    data_parallel: int = 0
    model_parallel: int = 1
    pipeline_parallel: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int]:
        mp = max(self.model_parallel, 1)
        pp = max(self.pipeline_parallel, 1)
        dp = self.data_parallel or n_devices // (mp * pp)
        if dp * mp * pp != n_devices:
            raise ValueError(
                f"mesh {dp}×{mp}×{pp} does not cover {n_devices} devices")
        return dp, mp, pp


def viable_world(spec: MeshSpec, n_devices: int) -> bool:
    """Whether `spec` resolves over `n_devices` (the elastic membership
    round's viability gate, `parallel/fleet.py::check_viable`)."""
    if n_devices < 1:
        return False
    try:
        spec.resolve(n_devices)
    except ValueError:
        return False
    return True


def mesh_coords(dp: int, mp: int, pp: int = 1) -> List[Tuple[int, int, int]]:
    """(data, model, pipe) index of each rank: rank = (d·mp + m)·pp + p,
    the pipe axis innermost (JAX's axis order), so a stage ring is
    contiguous ranks."""
    return [(r // (mp * pp), r // pp % mp, r % pp)
            for r in range(dp * mp * pp)]


def rank_table(dp: int, mp: int) -> List[Tuple[int, int]]:
    """(data index, model index) of each rank of a (data, model) mesh:
    rank = d·mp + m, so the ranks of one model group are contiguous."""
    return [(d, m) for d, m, _ in mesh_coords(dp, mp)]


@dataclasses.dataclass
class Mesh:
    """This rank's place in the mesh and its groups. A group is None where
    its axis is this rank alone (no collective)."""

    dp: int = 1
    mp: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None
    pp: int = 1
    pipe_index: int = 0
    pipe_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> Dict[str, int]:
        """JAX's `mesh.shape`: (data, model), and pipe when it is above 1."""
        out = {DATA_AXIS: self.dp, MODEL_AXIS: self.mp}
        if self.pp > 1:
            out[PIPE_AXIS] = self.pp
        return out

    @property
    def sharded(self) -> bool:
        """Whether any axis but data spans more than this rank."""
        return self.mp > 1 or self.pp > 1

    def stage_axis(self) -> Tuple[str, int, int, Optional[dist.ProcessGroup]]:
        """(axis, size, index, group) of the GPipe stages: the pipe axis
        when it is above 1, else the model axis (JAX's choice,
        `factory.py:158-163`, `mesh.py:245-253`)."""
        if self.pp > 1:
            return PIPE_AXIS, self.pp, self.pipe_index, self.pipe_group
        return MODEL_AXIS, self.mp, self.model_index, self.model_group

    def batch_shards(self) -> int:
        """The product of the axes above 1 other than the stages' (JAX's
        "data" in its pipeline's batch check, `ops/pipeline.py:75-80`)."""
        other = (self.dp, self.mp) if self.pp > 1 else (self.dp,)
        return math.prod(n for n in other if n > 1)


def _groups(dp: int, mp: int, pp: int, rank: int
            ) -> Tuple[Optional[dist.ProcessGroup], ...]:
    """This rank's data, model and pipe groups. Every rank creates every
    group, in one order (model groups, then data groups, then pipe
    groups), as `new_group` asks. A (data, model) mesh's data group is the
    world where the model axis is 1."""
    def ranks(d, m, p):
        return (d * mp + m) * pp + p

    me = mesh_coords(dp, mp, pp)[rank]
    data = model = pipe = None
    for d in range(dp):
        for p in range(pp):
            g = (dist.new_group([ranks(d, m, p) for m in range(mp)])
                 if mp > 1 else None)
            if (me[0], me[2]) == (d, p):
                model = g
    if mp == 1 and pp == 1:
        return dist.group.WORLD if dp > 1 else None, None, None
    for m in range(mp):
        for p in range(pp):
            g = (dist.new_group([ranks(d, m, p) for d in range(dp)])
                 if dp > 1 else None)
            if (me[1], me[2]) == (m, p):
                data = g
    for d in range(dp):
        for m in range(mp):
            g = (dist.new_group([ranks(d, m, p) for p in range(pp)])
                 if pp > 1 else None)
            if (me[0], me[1]) == (d, m):
                pipe = g
    return data, model, pipe


def make_mesh(spec: MeshSpec = MeshSpec(), world: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """The mesh over the process group's `world` ranks (the whole group by
    default; one rank without a group). ValueError with JAX's text when
    the spec does not cover the world."""
    up = dist.is_available() and dist.is_initialized()
    world = world if world is not None else (dist.get_world_size() if up else 1)
    rank = rank if rank is not None else (dist.get_rank() if up else 0)
    dp, mp, pp = spec.resolve(world)
    data, model, pipe = (_groups(dp, mp, pp, rank) if up
                         else (None, None, None))
    for g in (model, pipe):
        # the stages' first hop has only some ranks of the group taking
        # part, which NCCL allows only after a call all ranks made
        if g is not None:
            dist.barrier(group=g)
    d, m, p = mesh_coords(dp, mp, pp)[rank]
    return Mesh(dp, mp, d, m, data, model, pp, p, pipe)


def make_hybrid_mesh(spec: MeshSpec = MeshSpec(), *,
                     dcn_data_parallel: int = 0,
                     world: Optional[int] = None,
                     rank: Optional[int] = None) -> Mesh:
    """Several nodes: the data axis spans them, every model group stays
    inside one (its ranks on one node's NVLink), JAX's two-tier layout.
    `dcn_data_parallel` is the node count (0 = world / LOCAL_WORLD_SIZE).
    Rank r sits on node r // per_node, so the slice-major data axis of JAX
    is the plain rank order: model groups of contiguous ranks, each inside
    a node because the model axis divides the node's ranks. So this is a
    validation step over `make_mesh`'s own layout: it refuses a spec that
    one node cannot hold (JAX's texts), then builds `make_mesh`'s
    groups."""
    if max(spec.pipeline_parallel, 1) > 1:
        raise ValueError(
            "dcn_slices does not compose with pipeline_stages yet: the "
            "hybrid mesh is two-axis (data, model) — drop --pp_stages "
            "(stages ride the model axis) or --dcn_slices")
    up = dist.is_available() and dist.is_initialized()
    world = world if world is not None else (dist.get_world_size() if up else 1)
    n_slices = dcn_data_parallel
    if not n_slices:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world) or world)
        n_slices = max(world // max(local, 1), 1)
    if n_slices <= 1:
        return make_mesh(spec, world, rank)
    per_slice = world // n_slices
    dp_ici, mp, _ = MeshSpec(
        spec.data_parallel // n_slices if spec.data_parallel else 0,
        spec.model_parallel).resolve(per_slice)
    return make_mesh(MeshSpec(n_slices * dp_ici, mp), world, rank)


# --------------------------------------------------------------- parameters --

MOE_BANKS = ("moe_w_in", "moe_b_in", "moe_w_out", "moe_b_out")


def shard_dim(name: str, shape: Sequence[int], model_axis_size: int
              ) -> Optional[int]:
    """The dim on which the parameter `name` of `shape` shards over the
    model axis, None where it is replicated — JAX's `_spec_for_param` in
    the port's names. Above one model shard:

    - the ArcFace margin's `weight` (C, D) on C;
    - the MoE expert banks (E, ...), matched by exact name, on E where the
      axis divides E (the router stays replicated);
    - the class-dim classifiers on C: a backbone's `fc` and the nested
      head's `classifier.fc` — torch's (C, D) layout of JAX's (D, C)
      kernel; their biases stay replicated, as JAX's.
    """
    if model_axis_size <= 1:
        return None
    parts = name.split(".")
    if parts[-1] == "weight" and "margin" in parts[:-1] and len(shape) == 2:
        return 0
    if parts[-1] in MOE_BANKS and shape[0] % model_axis_size == 0:
        return 0
    if name.endswith("fc.weight") and parts[-2] == "fc" and len(shape) == 2:
        return 0
    return None


def check_stages(depth: int, stages: int) -> None:
    """A depth the stages do not divide is JAX's executor's ValueError
    (`ops/pipeline.py:72-73`)."""
    if depth % stages:
        raise ValueError(f"depth {depth} not divisible by {stages} stages")


def block_stage(index: int, depth: int, stages: int) -> int:
    """The stage that owns block `index` of a `depth`-block GPipe stack
    over `stages` stages: JAX's stage rule (`_spec_for_param`, the stacked
    blocks' dim 0 on the stage axis), stage i holding blocks
    [i·L/S, (i+1)·L/S)."""
    check_stages(depth, stages)
    return index // (depth // stages)


def visible_devices(device: torch.device) -> List[torch.device]:
    """Every device of `device`'s kind this process can serve on: each
    visible card for a CUDA device, `device`'s own first (so one serve
    device is the card the process was given), the one CPU for the CPU."""
    if device.type == "cuda":
        n = torch.cuda.device_count()
        first = device.index if device.index is not None else 0
        return [torch.device("cuda", (first + i) % n) for i in range(n)]
    return [device]


def serve_devices(n_devices: int = 0, device: Optional[torch.device] = None,
                  devices: Optional[Sequence[torch.device]] = None
                  ) -> List[torch.device]:
    """The first `n_devices` of `devices` (default: `visible_devices` of
    `device`); 0 takes them all. Raises ValueError (the serve CLI's rc 2)
    when the request exceeds what exists, with the JAX package's text."""
    if devices is None:
        devices = visible_devices(torch.device(device or "cpu"))
    devices = list(devices)
    if n_devices < 0:
        raise ValueError(f"serve_devices must be >= 0, got {n_devices}")
    if n_devices > len(devices):
        raise ValueError(
            f"serve_devices={n_devices} exceeds the {len(devices)} visible "
            "devices — lower --serve_devices or widen the deployment")
    return devices[:n_devices] if n_devices else devices
