"""Weights carried across from the JAX package: its flax TResNet variables
→ the port's TResNet `state_dict` (timm's key layout, models/tresnet.py),
its flax ResNet and VGG19-BN variables → the port's (torchvision's key
layout, models/resnet.py, models/vgg.py), its flax ViT params → the
port's ViT `state_dict` (models/vit.py), and its ArcFace and Nested
models (any of these backbones under the heads of models/heads.py) →
the port's `ArcFaceModel` / `NestedModel` `state_dict`s. `flax_path`
names the flax leaf of a port parameter (the freeze-BN matcher reads it,
`train/schedule.py`).

The inverse direction of the JAX package's
`models/import_torch.py::convert_tresnet_state_dict`, taking the flax trees
as nested dicts of numpy arrays (`jax.device_get` of `params` and
`batch_stats`), so this module needs neither jax nor flax:

- conv kernel HWIO → weight OIHW;
- Dense kernel (I, O) → Linear weight (O, I);
- SE Dense kernel (I, O) → 1×1 conv weight (O, I, 1, 1);
- flax `scale`/`bias` params and `mean`/`var` batch stats →
  `weight`/`bias`/`running_mean`/`running_var`;
- the anti-alias blur's fixed filter has no flax tensor (the JAX model builds
  it as a constant): its persistent `.filt` buffer is filled with the same
  binomial filter, so the result loads with `strict=True` like a timm
  checkpoint.

The tensors come back in f32 as stored; the served model casts its conv
weights to the compute dtype once, after loading.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from .tresnet import blur_filter
from .vgg import CFG_E, GRID

_BN_LEAVES = (("scale", "params", "weight"), ("bias", "params", "bias"),
              ("mean", "batch_stats", "running_mean"),
              ("var", "batch_stats", "running_var"))


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _conv(kernel: Any) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))  # HWIO → OIHW


def tresnet_from_jax(params: Mapping[str, Any],
                     batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax TResNet `params` + `batch_stats` (or a ClassifierModel's, with
    the single `backbone` level) → the port TResNet's `state_dict`."""
    if set(params) == {"backbone"}:
        params, batch_stats = params["backbone"], batch_stats["backbone"]
    sd: Dict[str, torch.Tensor] = {}

    def bn(prefix: str, p: Mapping, s: Mapping) -> None:
        for leaf, coll, name in _BN_LEAVES:
            sd[f"{prefix}.{name}"] = _t((p if coll == "params" else s)[leaf])

    def conv_bn(prefix: str, kernel: Any, p: Mapping, s: Mapping,
                aa: bool) -> None:
        inner = f"{prefix}.0" if aa else prefix
        sd[f"{inner}.0.weight"] = _conv(kernel)
        bn(f"{inner}.1", p, s)
        if aa:
            sd[f"{prefix}.1.filt"] = blur_filter(int(np.shape(kernel)[-1]))

    conv_bn("body.conv1", params["stem_conv"]["kernel"], params["stem_abn"],
            batch_stats["stem_abn"], aa=False)
    blocks = sorted(
        (tuple(int(g) for g in m.groups()), name) for name in params
        if (m := re.fullmatch(r"stage(\d+)_block(\d+)", name)))
    for (layer, b), name in blocks:
        p, s = params[name], batch_stats[name]
        pre = f"body.layer{layer}.{b}"
        aa = layer >= 2 and b == 0  # the stride-2 block of stages 2-4
        if layer <= 2:  # TBasicBlock: conv1+ABN (blurred), conv2+BN
            conv_bn(f"{pre}.conv1", p["conv1"]["kernel"], p["abn1"], s["abn1"], aa)
            conv_bn(f"{pre}.conv2", p["conv2"]["kernel"], p["bn2"], s["bn2"], False)
        else:  # TBottleneck: conv1+ABN, conv2+ABN (blurred), conv3+BN
            conv_bn(f"{pre}.conv1", p["conv1"]["kernel"], p["abn1"], s["abn1"], False)
            conv_bn(f"{pre}.conv2", p["conv2"]["kernel"], p["abn2"], s["abn2"], aa)
            conv_bn(f"{pre}.conv3", p["conv3"]["kernel"], p["bn3"], s["bn3"], False)
        if "se" in p:
            for fc in ("fc1", "fc2"):
                k = np.asarray(p["se"][fc]["kernel"])
                sd[f"{pre}.se.{fc}.weight"] = _t(k.T[:, :, None, None])
                sd[f"{pre}.se.{fc}.bias"] = _t(p["se"][fc]["bias"])
        if "downsample" in p:
            sd[f"{pre}.downsample.1.0.weight"] = _conv(p["downsample"]["kernel"])
            bn(f"{pre}.downsample.1.1", p["bn_down"], s["bn_down"])
    if "fc" in params:
        sd["head.fc.weight"] = _t(np.asarray(params["fc"]["kernel"]).T)
        sd["head.fc.bias"] = _t(params["fc"]["bias"])
    return sd


def _dense(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)  # (I, O) → (O, I)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def vit_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ViT `params` (or a ClassifierModel's, with the single
    `backbone` level) → the port ViT's `state_dict`: conv HWIO → OIHW, Dense
    (I, O) → Linear (O, I), LayerNorm `scale`/`bias` → `weight`/`bias`,
    `pos_embed` as it is. A ViT has no batch statistics."""
    if set(params) == {"backbone"}:
        params = params["backbone"]
    sd: Dict[str, torch.Tensor] = {
        "patch_embed.weight": _conv(params["patch_embed"]["kernel"]),
        "patch_embed.bias": _t(params["patch_embed"]["bias"]),
        "pos_embed": _t(params["pos_embed"]),
    }

    def ln(prefix: str, p: Mapping) -> None:
        sd[f"{prefix}.weight"] = _t(p["scale"])
        sd[f"{prefix}.bias"] = _t(p["bias"])

    blocks = sorted(int(m.group(1)) for name in params
                    if (m := re.fullmatch(r"block(\d+)", name)))
    for i in blocks:
        p, pre = params[f"block{i}"], f"blocks.{i}"
        ln(f"{pre}.ln1", p["ln1"])
        ln(f"{pre}.ln2", p["ln2"])
        _dense(sd, f"{pre}.attn.qkv", p["attn"]["qkv"])
        _dense(sd, f"{pre}.attn.proj", p["attn"]["proj"])
        _dense(sd, f"{pre}.mlp_in", p["mlp_in"])
        _dense(sd, f"{pre}.mlp_out", p["mlp_out"])
    ln("ln_final", params["ln_final"])
    if "fc" in params:
        _dense(sd, "fc", params["fc"])
    return sd


def resnet_from_jax(params: Mapping[str, Any],
                    batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ResNet `params` + `batch_stats` (or a ClassifierModel's, with
    the single `backbone` level) → the port ResNet's `state_dict`, for
    every depth and both stems. The JAX module names
    (`models/resnet.py:57-62,86-91,145-170` there) map to torchvision's:
    `conv_stem`/`bn_stem` → `conv1`/`bn1`; `layerX_blockY` → `layerX.Y`,
    in which `Conv_k`/`BatchNorm_k` → `conv{k+1}`/`bn{k+1}` and
    `downsample_conv`/`downsample_bn` → `downsample.0/1`; `fc` → `fc`."""
    if set(params) == {"backbone"}:
        params, batch_stats = params["backbone"], batch_stats["backbone"]
    sd: Dict[str, torch.Tensor] = {}

    def bn(prefix: str, name: str, p: Mapping, s: Mapping) -> None:
        for leaf, coll, out in _BN_LEAVES:
            sd[f"{prefix}.{out}"] = _t((p if coll == "params" else s)[name][leaf])

    sd["conv1.weight"] = _conv(params["conv_stem"]["kernel"])
    bn("bn1", "bn_stem", params, batch_stats)
    for name in params:
        m = re.fullmatch(r"layer(\d+)_block(\d+)", name)
        if m is None:
            continue
        p, s = params[name], batch_stats[name]
        pre = f"layer{m.group(1)}.{m.group(2)}"
        for sub in p:
            if (c := re.fullmatch(r"Conv_(\d+)", sub)):
                sd[f"{pre}.conv{int(c.group(1)) + 1}.weight"] = _conv(p[sub]["kernel"])
            elif (b := re.fullmatch(r"BatchNorm_(\d+)", sub)):
                bn(f"{pre}.bn{int(b.group(1)) + 1}", sub, p, s)
        if "downsample_conv" in p:
            sd[f"{pre}.downsample.0.weight"] = _conv(p["downsample_conv"]["kernel"])
            bn(f"{pre}.downsample.1", "downsample_bn", p, s)
    if "fc" in params:
        _dense(sd, "fc", params["fc"])
    return sd


def vgg_seq(cfg: Sequence[Any] = CFG_E) -> Dict[int, Tuple[str, bool]]:
    """`features.<i>` index → (the flax name, whether a conv): a conv entry
    takes three slots (conv, BN, ReLU), a max pool one (torchvision's
    `make_layers`)."""
    out, seq, i = {}, 0, 0
    for v in cfg:
        if v == "M":
            seq += 1
            continue
        out[seq], out[seq + 1] = (f"conv{i}", True), (f"bn{i}", False)
        seq, i = seq + 3, i + 1
    return out


_VGG_FC = {"fc1": 0, "fc2": 3, "fc3": 6}  # classifier.<i> of each Dense


def vgg_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                 cfg: Sequence[Any] = CFG_E) -> Dict[str, torch.Tensor]:
    """flax VGG `params` + `batch_stats` (or a ClassifierModel's, with the
    single `backbone` level) → the port VGG's `state_dict`: `conv{i}` /
    `bn{i}` → `features.<seq>`, `fc1`/`fc2`/`fc3` → `classifier.{0,3,6}`.
    fc1's inputs are permuted from the JAX model's (h, w, c) flatten to
    torchvision's (c, h, w)."""
    if set(params) == {"backbone"}:
        params, batch_stats = params["backbone"], batch_stats["backbone"]
    sd: Dict[str, torch.Tensor] = {}
    for seq, (name, is_conv) in vgg_seq(cfg).items():
        if is_conv:
            sd[f"features.{seq}.weight"] = _conv(params[name]["kernel"])
            sd[f"features.{seq}.bias"] = _t(params[name]["bias"])
            continue
        for leaf, coll, out in _BN_LEAVES:
            sd[f"features.{seq}.{out}"] = _t(
                (params if coll == "params" else batch_stats)[name][leaf])
    for name, i in _VGG_FC.items():
        if name not in params:
            continue
        k = np.asarray(params[name]["kernel"])
        if name == "fc1":  # (h·w·c, O) → (c·h·w, O)
            c = k.shape[0] // (GRID * GRID)
            k = k.reshape(GRID, GRID, c, -1).transpose(2, 0, 1, 3).reshape(
                k.shape[0], -1)
        sd[f"classifier.{i}.weight"] = _t(k.T)
        sd[f"classifier.{i}.bias"] = _t(params[name]["bias"])
    return sd


def backbone_from_jax(params: Mapping[str, Any],
                      batch_stats: Mapping[str, Any],
                      vgg_cfg: Sequence[Any] = CFG_E
                      ) -> Dict[str, torch.Tensor]:
    """A flax backbone's variables → the port backbone's `state_dict`, by
    the arch its top-level names give: a ResNet (`conv_stem`), TResNet-M
    (`stem_conv`), a ViT (`patch_embed`) or a VGG (`conv0`)."""
    if "conv_stem" in params:
        return resnet_from_jax(params, batch_stats)
    if "stem_conv" in params:
        return tresnet_from_jax(params, batch_stats)
    if "patch_embed" in params:
        return vit_from_jax(params)
    if "conv0" in params:
        return vgg_from_jax(params, batch_stats, vgg_cfg)
    raise ValueError(f"not a flax backbone of a ported arch (top-level "
                     f"names: {sorted(params)[:6]})")


def _backbone(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
              vgg_cfg: Sequence[Any]) -> Dict[str, torch.Tensor]:
    return {f"backbone.{k}": v for k, v in backbone_from_jax(
        params["backbone"], batch_stats.get("backbone", {}),
        vgg_cfg).items()}


def arcface_from_jax(params: Mapping[str, Any],
                     batch_stats: Mapping[str, Any],
                     vgg_cfg: Sequence[Any] = CFG_E
                     ) -> Dict[str, torch.Tensor]:
    """flax `ArcFaceModel` variables → the port `ArcFaceModel`'s
    `state_dict`: the backbone through `backbone_from_jax`, the
    embedding's Dense kernels (I, O) transposed, and the margin head's
    `weight`, which flax already holds as (C, D), as it is."""
    sd = _backbone(params, batch_stats, vgg_cfg)
    for fc in ("fc1", "fc2"):
        _dense(sd, f"embedding.{fc}", params["embedding"][fc])
    sd["margin.weight"] = _t(params["margin"]["weight"])
    return sd


def nested_from_jax(params: Mapping[str, Any],
                    batch_stats: Mapping[str, Any],
                    vgg_cfg: Sequence[Any] = CFG_E
                    ) -> Dict[str, torch.Tensor]:
    """flax `NestedModel` variables → the port `NestedModel`'s
    `state_dict`: the backbone through `backbone_from_jax`, the bias-free
    classifier's kernel (D, C) transposed."""
    sd = _backbone(params, batch_stats, vgg_cfg)
    sd["classifier.fc.weight"] = _t(np.asarray(
        params["classifier"]["fc"]["kernel"]).T)
    return sd


_LEAF = {"weight": "kernel", "bias": "bias"}
_BN_LEAF = {"weight": "scale", "bias": "bias"}  # LayerNorm's leaves too


def _resnet_path(rest: List[str], leaf: str) -> str:
    """torchvision ResNet names → the JAX ResNet's (`resnet_from_jax`)."""
    if rest == ["conv1"]:
        return "conv_stem/kernel"
    if rest == ["bn1"]:
        return f"bn_stem/{_BN_LEAF[leaf]}"
    if rest == ["fc"]:
        return f"fc/{_LEAF[leaf]}"
    block = f"{rest[0]}_block{rest[1]}"
    if rest[2] == "downsample":
        return (f"{block}/downsample_conv/kernel" if rest[3] == "0"
                else f"{block}/downsample_bn/{_BN_LEAF[leaf]}")
    kind, k = rest[2][:-1], int(rest[2][-1]) - 1  # conv3 → Conv_2
    if kind == "conv":
        return f"{block}/Conv_{k}/kernel"
    return f"{block}/BatchNorm_{k}/{_BN_LEAF[leaf]}"


def _tresnet_path(rest: List[str], leaf: str) -> str:
    """timm TResNet names → the JAX TResNet's (`tresnet_from_jax`)."""
    if rest[0] == "head":  # head.fc
        return f"fc/{_LEAF[leaf]}"
    rest = rest[1:]  # body.
    if rest[0] == "conv1":
        return ("stem_conv/kernel" if rest[1] == "0"
                else f"stem_abn/{_BN_LEAF[leaf]}")
    layer = int(rest[0][len("layer"):])
    block = f"stage{layer}_block{rest[1]}"
    sub, tail = rest[2], rest[3:]
    if sub == "se":
        return f"{block}/se/{tail[0]}/{_LEAF[leaf]}"
    if sub == "downsample":  # downsample.1.{0,1}
        return (f"{block}/downsample/kernel" if tail[1] == "0"
                else f"{block}/bn_down/{_BN_LEAF[leaf]}")
    j = int(sub[len("conv"):])
    if len(tail) == 2:  # blur-wrapped: convJ.0.{0,1}
        tail = tail[1:]
    if tail[0] == "0":
        return f"{block}/conv{j}/kernel"
    last = 2 if layer <= 2 else 3  # the identity BN ends the block
    return f"{block}/{f'bn{last}' if j == last else f'abn{j}'}/{_BN_LEAF[leaf]}"


def _vit_path(rest: List[str], leaf: str) -> str:
    """The port ViT's names → the JAX ViT's (`vit_from_jax`)."""
    if rest[0] == "blocks":
        mods = [f"block{rest[1]}", *rest[2:]]
    else:  # patch_embed, ln_final, fc
        mods = list(rest)
    ln = mods[-1].startswith("ln")
    return "/".join(mods + [(_BN_LEAF if ln else _LEAF)[leaf]])


def _vgg_path(rest: List[str], leaf: str, cfg: Sequence[Any]) -> str:
    """torchvision VGG names → the JAX VGG's (`vgg_from_jax`)."""
    if rest[0] == "classifier":
        fc = {str(i): n for n, i in _VGG_FC.items()}[rest[1]]
        return f"{fc}/{_LEAF[leaf]}"
    name, is_conv = vgg_seq(cfg)[int(rest[1])]
    return f"{name}/{(_LEAF if is_conv else _BN_LEAF)[leaf]}"


def flax_path(name: str, vgg_cfg: Sequence[Any] = CFG_E) -> str:
    """The flax param path ("/"-joined) of a port parameter of a
    `ClassifierModel`, `ArcFaceModel` or `NestedModel` over any ported
    backbone — the inverse of the maps above:
    `backbone.layer1.0.bn2.weight` → `backbone/layer1_block0/BatchNorm_1/scale`,
    `backbone.body.layer3.0.conv3.1.bias` → `backbone/stage3_block0/bn3/bias`,
    `backbone.features.1.weight` → `backbone/bn0/scale` (under `vgg_cfg`),
    `backbone.blocks.0.ln1.weight` → `backbone/block0/ln1/scale`,
    `margin.weight` → `margin/weight`."""
    parts = name.split(".")
    if parts[0] == "margin":
        return "margin/weight"
    if parts[0] != "backbone":  # embedding.fc1.weight, classifier.fc.weight
        return "/".join(parts[:-1] + [_LEAF[parts[-1]]])
    rest, leaf = parts[1:-1], parts[-1]
    if not rest:  # the ViT's pos_embed
        path = leaf
    elif rest[0] in ("body", "head"):
        path = _tresnet_path(rest, leaf)
    elif rest[0] in ("features", "classifier"):
        path = _vgg_path(rest, leaf, vgg_cfg)
    elif rest[0] in ("patch_embed", "blocks", "ln_final"):
        path = _vit_path(rest, leaf)
    else:  # a ResNet; a ViT's `fc` names the same leaves
        path = _resnet_path(rest, leaf)
    return f"backbone/{path}"
