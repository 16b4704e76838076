"""Verify that a torchvision or timm checkpoint imports exactly into the
port — the counterpart of the JAX package's `cli/verify_import.py`.

    python -m ddp_classification_pytorch_tpu_torch.cli.verify_import \
        /path/to/resnet50-0676ba61.pth --arch resnet50

It (1) loads the state dict (`models/import_torch.py::load_torch_checkpoint`),
(2) strict-loads it into the matching oracle (`models/torch_oracle.py`,
upstream parameter names, so key coverage is checked), (3) imports it into
the port's model through the path `--pretrained_path` takes
(`train/state.py::load_pretrained_`), and (4) compares the two forwards
on random inputs in f32 eval mode, both on `--device` (default cuda) with
TF32 off for convolutions and matmuls (cuDNN's TF32 convolutions alone
move a ResNet-50's logits by more than the tolerance). The input is 64 px
for a ResNet and 224 px for VGG19-BN (its classifier's 7×7 grid) and
TResNet-M.

Exit 0 = PASS (max |Δ| or max relative |Δ| within `--tol`), 1 =
numerical FAIL, 2 = usage or key errors (a missing or unreadable file, an
unknown arch, keys the oracle's strict load or the port's import refuses),
3 = no CUDA device and `--device cpu` not asked for.

What a PASS certifies: the import against this artifact. The oracle and
the port read the same bytes, so value-level damage both read alike shows
up as task accuracy, not here; truncation and renames are rc 2.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import get_preset
from ..models import torch_oracle
from ..models.import_torch import HEAD_KEYS, family, load_torch_checkpoint

# the input size by import family: VGG's classifier needs its 7×7 grid
_SIZE = {"resnet": 64, "vgg": 224, "tresnet": 224}


def _oracle(arch: str, num_classes: int) -> torch.nn.Module:
    fam = family(arch)
    if fam == "resnet":
        return torch_oracle.make_torch_resnet(arch, num_classes)
    if fam == "vgg":
        return torch_oracle.make_torch_vgg19_bn(num_classes)
    return torch_oracle.make_torch_tresnet_m(num_classes)


def _port_model(arch: str, num_classes: int, path: str,
                device: torch.device) -> torch.nn.Module:
    """The port's f32 model for `arch` with `path` imported as
    `--pretrained_path` imports it, in eval mode on `device`."""
    from ..models.factory import build_model
    from ..train.state import init_weights_, load_pretrained_

    cfg = get_preset("baseline")
    cfg.model.arch, cfg.model.dtype = arch, "float32"
    model = build_model(cfg.model, num_classes, _SIZE[family(arch)])
    init_weights_(model, torch.Generator().manual_seed(0))
    load_pretrained_(model.backbone, path)
    return model.to(device=device, memory_format=torch.channels_last).eval()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ddp_classification_pytorch_tpu_torch.cli.verify_import",
        description="verify a torchvision/timm .pth imports exactly")
    ap.add_argument("checkpoint", help="path to the .pth / .pt state_dict")
    ap.add_argument("--arch", default="resnet50",
                    help="resnet18|34|50|101|152|vgg19_bn|tresnet_m")
    ap.add_argument("--tol", type=float, default=2e-4,
                    help="forward-parity tolerance (f32, TF32 off)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default="", choices=["", "cuda", "cpu"],
                    help="default cuda; cpu only when asked (rc 3 when cuda "
                         "is missing and cpu was not asked for)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    from ..utils.backend_probe import BackendUnavailable, resolve_device

    args = build_parser().parse_args(argv)
    try:
        fam = family(args.arch)
    except ValueError as e:
        print(f"FAIL: unknown --arch: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    try:
        device = resolve_device(args.device)
    except BackendUnavailable as e:
        print(f"[verify_import] backend unreachable: {e}", file=sys.stderr)
        raise SystemExit(3) from None
    try:
        sd = load_torch_checkpoint(args.checkpoint)
    except Exception as e:  # torch.load raises pickle/zip/Runtime errors
        # on truncated or non-checkpoint files: all usage-class here
        print(f"FAIL: cannot load {args.checkpoint}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    head = HEAD_KEYS[fam]  # its rows give the class count
    if head not in sd:
        print(f"FAIL: {head!r} missing — not a full {args.arch} state_dict "
              f"(keys sample: {sorted(sd)[:5]})", file=sys.stderr)
        raise SystemExit(2)
    num_classes = int(sd[head].shape[0])
    oracle = _oracle(args.arch, num_classes)
    # strict load into the oracle: renamed or missing keys fail here,
    # with the key lists, before any numerics
    try:
        oracle.load_state_dict(sd, strict=True)
    except RuntimeError as e:
        print(f"FAIL: oracle strict load rejected the state_dict:\n{e}",
              file=sys.stderr)
        raise SystemExit(2) from None
    try:
        port = _port_model(args.arch, num_classes, args.checkpoint, device)
    except ValueError as e:
        print(f"FAIL: the port's import rejected the state_dict: {e}",
              file=sys.stderr)
        raise SystemExit(2) from None
    oracle = oracle.to(device).eval()

    size = _SIZE[fam]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(args.batch, 3, size, size)).astype(np.float32)).to(device)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            ref = oracle(x).double().cpu().numpy()
            got = port(x.contiguous(memory_format=torch.channels_last)
                       ).double().cpu().numpy()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32

    diff = np.abs(got - ref)
    max_abs = float(diff.max())
    max_rel = float((diff / np.maximum(np.abs(ref), 1.0)).max())
    ok = max_abs <= args.tol or max_rel <= args.tol
    print(f"{'PASS' if ok else 'FAIL'}: {args.arch} ({num_classes} classes) "
          f"max|Δ|={max_abs:.3e} max_rel={max_rel:.3e} tol={args.tol:.0e} "
          f"over batch {args.batch} @ {size}px on {device} "
          f"(logit std {float(np.std(ref)):.3f})")
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
