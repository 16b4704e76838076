"""Weights carried across from the JAX package: its flax TResNet variables
→ the port's TResNet `state_dict` (timm's key layout, models/tresnet.py),
its flax ResNet variables → the port's ResNet `state_dict` (torchvision's
key layout, models/resnet.py), its flax ViT params → the port's ViT
`state_dict` (models/vit.py), and its ArcFace and Nested models (a ResNet
backbone and the heads of models/heads.py) → the port's
`ArcFaceModel` / `NestedModel` `state_dict`s. `flax_path` names the
flax leaf of a port parameter (the freeze-BN matcher reads it,
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
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .tresnet import blur_filter

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


def arcface_from_jax(params: Mapping[str, Any],
                     batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax `ArcFaceModel` variables → the port `ArcFaceModel`'s
    `state_dict`: the backbone through `resnet_from_jax`, the embedding's
    Dense kernels (I, O) transposed, and the margin head's `weight`, which
    flax already holds as (C, D), as it is."""
    sd = {f"backbone.{k}": v for k, v in resnet_from_jax(
        params["backbone"], batch_stats["backbone"]).items()}
    for fc in ("fc1", "fc2"):
        _dense(sd, f"embedding.{fc}", params["embedding"][fc])
    sd["margin.weight"] = _t(params["margin"]["weight"])
    return sd


def nested_from_jax(params: Mapping[str, Any],
                    batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax `NestedModel` variables → the port `NestedModel`'s
    `state_dict`: the backbone through `resnet_from_jax`, the bias-free
    classifier's kernel (D, C) transposed."""
    sd = {f"backbone.{k}": v for k, v in resnet_from_jax(
        params["backbone"], batch_stats["backbone"]).items()}
    sd["classifier.fc.weight"] = _t(np.asarray(
        params["classifier"]["fc"]["kernel"]).T)
    return sd


_LEAF = {"weight": "kernel", "bias": "bias"}
_BN_LEAF = {"weight": "scale", "bias": "bias"}


def flax_path(name: str) -> str:
    """The flax param path ("/"-joined) of a port parameter of a ResNet
    model — `ClassifierModel`, `ArcFaceModel` or `NestedModel` — the
    inverse of the maps above: `backbone.layer1.0.bn2.weight` →
    `backbone/layer1_block0/BatchNorm_1/scale`,
    `backbone.layer1.0.downsample.1.bias` →
    `backbone/layer1_block0/downsample_bn/bias`, `margin.weight` →
    `margin/weight`."""
    parts = name.split(".")
    if parts[0] == "margin":
        return "margin/weight"
    if parts[0] != "backbone":  # embedding.fc1.weight, classifier.fc.weight
        return "/".join(parts[:-1] + [_LEAF[parts[-1]]])
    rest, leaf = parts[1:-1], parts[-1]
    if rest == ["conv1"]:
        return "backbone/conv_stem/kernel"
    if rest == ["bn1"]:
        return f"backbone/bn_stem/{_BN_LEAF[leaf]}"
    if rest == ["fc"]:
        return f"backbone/fc/{_LEAF[leaf]}"
    block = f"backbone/{rest[0]}_block{rest[1]}"
    if rest[2] == "downsample":
        return (f"{block}/downsample_conv/kernel" if rest[3] == "0"
                else f"{block}/downsample_bn/{_BN_LEAF[leaf]}")
    kind, k = rest[2][:-1], int(rest[2][-1]) - 1  # conv3 → Conv_2
    if kind == "conv":
        return f"{block}/Conv_{k}/kernel"
    return f"{block}/BatchNorm_{k}/{_BN_LEAF[leaf]}"
