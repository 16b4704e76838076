"""torchvision / timm checkpoints → the port's backbones — the counterpart
of the JAX package's `models/import_torch.py`.

The reference starts every trainer from pretrained torchvision weights
(BASELINE/main.py:135, CDR/main.py:330, NESTED via
imagenet_resnet.py:195-203, torchvision `vgg19_bn` in
NESTED/model/vgg.py:13-17) or timm's `tresnet_m_miil_in21k`
(BASELINE/main.py:141-144). The port's modules carry the upstream names
(`models/resnet.py`: torchvision's; `models/vgg.py`: torchvision's
`features.<i>` / `classifier.{0,3,6}`; `models/tresnet.py`: timm's), so an
import is mostly the identity plus the normalisations the JAX converters
make:

- `load_torch_checkpoint`: a raw state dict, a `{'state_dict': ...}`
  wrapper, or the reference NESTED `{'feat', 'cls'}` file (its `feat`,
  whose `feat_net.<i>` keys become torchvision's, JAX `:77-92,345-356`);
- ResNet (JAX `convert_resnet_state_dict`, `:95-131`): the reference's
  vestigial `mean_vector` / `count_vector` / `label` buffers and
  `num_batches_tracked` are skipped;
- VGG19-BN (`convert_vgg_state_dict`, `:151-224`): `features.<i>` must fit
  the model's cfg, `classifier.<i>` must be 0, 3 or 6. The JAX model
  flattens (h, w, c) and permutes fc1's inputs; the port flattens
  torchvision's (c, h, w), so fc1 loads as it is;
- TResNet-M (`convert_tresnet_state_dict`, `:227-321`): keys without
  `body.` get it and a bare `fc.` becomes `head.fc.`, as JAX accepts
  both; the anti-alias blur's `.filt` is skipped (JAX `:254`; the port
  builds the same fixed filter); SE's 1×1 convs and the `.0.0` / `.0.1`
  blur wrapping are already the port's names.

The classifier (`fc`, `classifier.6`, `head.fc`) is imported only when
the model keeps a head of the same shape (JAX `train/state.py:122-133`:
the reference replaces a 1000-class head).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import torch

from .convert import vgg_seq
from .resnet import DEPTHS as RESNET_DEPTHS
from .vgg import CFG_E

# the reference NESTED NetFeat's Sequential indices → torchvision names
# (NESTED/model/model.py:37-40; JAX `models/import_torch.py:73-74`)
_NESTED_SEQ = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
               "6": "layer3", "7": "layer4"}
_VESTIGIAL = ("mean_vector", "count_vector", "label")
# each arch family's classifier weight, imported only at a matching shape
HEAD_KEYS = {"resnet": "fc.weight", "vgg": "classifier.6.weight",
             "tresnet": "head.fc.weight"}


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A .pth/.pt state dict as torchvision names: a raw state dict, a
    `{'state_dict': ...}` wrapper, or the reference's NESTED `{'feat',
    'cls'}` file (its `feat`, whose `feat_net.<i>` keys are renamed)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "feat" in obj and "cls" in obj:
        obj = obj["feat"]
    out = {}
    for key, value in obj.items():
        parts = key.split(".")
        if parts[0] == "feat_net":
            if parts[1] not in _NESTED_SEQ:
                continue  # relu / maxpool / avgpool carry no tensors
            key = ".".join([_NESTED_SEQ[parts[1]]] + parts[2:])
        out[key] = value
    return out


def family(arch: str) -> str:
    """The import format of `arch`: resnet, vgg or tresnet; a ValueError
    for an arch no torchvision/timm checkpoint exists for (the ViTs)."""
    if arch in RESNET_DEPTHS:
        return "resnet"
    if arch == "vgg19_bn":
        return "vgg"
    if arch in ("tresnet_m", "timm"):
        return "tresnet"
    raise ValueError(f"no torchvision/timm import for arch {arch!r} "
                     "(ported: the ResNets, vgg19_bn, tresnet_m)")


def _tresnet_key(key: str) -> str:
    """timm names as the JAX converter accepts them → the port's."""
    parts = key.split(".")
    if parts[0] == "fc":
        return "head." + key
    if parts[0] == "conv1" or parts[0].startswith("layer"):
        return "body." + key
    return key


def import_state_dict(fam: str, sd: Mapping[str, torch.Tensor],
                      own: Mapping[str, torch.Tensor],
                      vgg_cfg: Sequence[Any] = CFG_E
                      ) -> Dict[str, torch.Tensor]:
    """The tensors of the upstream state dict `sd` to overlay onto a
    backbone of import family `fam` (`family`) whose own `state_dict()`
    is `own`, under the port's names. Tensors the file lacks keep the
    model's values. A key the model does not have, a shape that does not
    fit, a VGG index off the layout, or nothing to load is a
    ValueError."""
    head = HEAD_KEYS[fam]
    if fam == "tresnet":
        sd = {_tresnet_key(k): v for k, v in sd.items()}
    w = sd.get(head)
    keep_head = (w is not None and head in own
                 and tuple(w.shape) == tuple(own[head].shape))
    head_prefix = head[:-len("weight")]
    seq = vgg_seq(vgg_cfg) if fam == "vgg" else {}
    load = {}
    for key, value in sd.items():
        parts = key.split(".")
        if (key.endswith("num_batches_tracked")
                or (fam == "resnet" and parts[0] in _VESTIGIAL)
                or (fam == "tresnet" and key.endswith(".filt"))
                or (key.startswith(head_prefix) and not keep_head)):
            continue
        if fam == "vgg" and not (
                (parts[0] == "features" and parts[1].isdigit()
                 and int(parts[1]) in seq)
                or (parts[0] == "classifier" and parts[1] in ("0", "3", "6"))):
            raise ValueError(f"torch VGG key {key!r} does not fit the "
                             "vgg19_bn layout (features.<conv or BN>, "
                             "classifier.{0,3,6})")
        if key not in own:
            raise ValueError(f"pretrained key {key!r} is not in the "
                             f"{fam} model")
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"pretrained {key!r} has shape "
                             f"{tuple(value.shape)}, the model "
                             f"{tuple(own[key].shape)}")
        load[key] = value
    if not load:
        raise ValueError(f"the checkpoint holds no {fam} weights (first "
                         f"keys: {list(sd)[:5]})")
    return load
