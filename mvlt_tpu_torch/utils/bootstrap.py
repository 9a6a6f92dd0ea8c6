"""Official-backbone checkpoint bootstrap of the port (counterpart of
``mvlt_tpu/utils/bootstrap.py:33-95``): the drivers' ``--backbone_ckpt``.

The reference loads pretrained backbone weights at model build
(``modules/model.py:222-226``: an ImageNet Swin ``.pth``); the drivers make
it a flag. :func:`load_backbone` reads a checkpoint file from a local path,
detects its layout from the keys, and returns a port state_dict of the
backbone alone (``conv.backbone.*``, and the BatchNorm running statistics
of a ResNet), which ``TaskRunner.init_state(pretrained_variables=[...])``
merges into the fresh model by name and shape; everything else stays
initialized.

Layouts (a ``swin.`` / ``resnet.`` key prefix is stripped first):

- Swin: the official MSFT ``.pth`` (``{"model": sd}`` or a bare sd; fused
  ``layers.{i}.blocks.{j}.attn.qkv``) and HF ``SwinModel`` (separate
  q / k / v);
- ResNet-50/101: torchvision (``layer{1..4}.{b}.conv{c}``) and HF
  ``ResNetModel`` (``embedder.`` / ``encoder.stages``).

The ViT backbone is not ported (ROADMAP.md queue A, 'Other backbones').
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mvlt_tpu_torch.config import MVLTConfig
from mvlt_tpu_torch.utils import convert


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The state dict of a checkpoint file as numpy arrays: ``.npz``, or a
    ``torch.save`` file of tensors (``weights_only``: no code runs on
    load), unwrapped from ``{"model": ...}`` / ``{"state_dict": ...}``."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]              # official Swin .pth wrapper
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return convert.state_dict_to_numpy(obj)


def _strip_prefix(sd: Dict[str, np.ndarray], prefix: str
                  ) -> Dict[str, np.ndarray]:
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}
    return sd


def convert_backbone(sd: Dict[str, np.ndarray], conv: str,
                     cfg: MVLTConfig) -> Dict[str, torch.Tensor]:
    """State dict (layout auto-detected) -> port state_dict of the backbone
    (``conv.backbone.*``, float32 on the CPU)."""
    conv = conv.lower()
    stats = None
    if conv in ("swin", "swintransformer"):
        sd = _strip_prefix(sd, "swin.")
        if any(".attn.qkv.weight" in k for k in sd):          # MSFT fused
            params = convert.swin_from_torch(sd, cfg.swin.depths)
        else:                                                  # HF layout
            params = convert.swin_from_hf(sd, cfg.swin.depths)
    elif conv in ("resnet101", "resnet50"):
        sd = _strip_prefix(sd, "resnet.")
        if any(k.startswith("layer1.") for k in sd):           # torchvision
            variables = convert.resnet_from_torchvision(sd, cfg.resnet.layers)
        else:                                                  # HF layout
            variables = convert.resnet_from_hf(sd, cfg.resnet.layers)
        params, stats = variables["params"], variables["batch_stats"]
    elif conv in ("vit", "visiontransformer"):
        raise NotImplementedError(
            "--backbone_ckpt for conv='vit': the ViT backbone is not ported "
            "yet (ROADMAP.md queue A, 'Other backbones')")
    else:
        raise NotImplementedError(
            f"--backbone_ckpt does not apply to conv={conv!r}")
    tree = {"params": {"conv": {"backbone": params}}}
    if stats is not None:
        tree["batch_stats"] = {"conv": {"backbone": stats}}
    return convert.params_from_flax(tree)


def load_backbone(path: str, cfg: MVLTConfig) -> Dict[str, torch.Tensor]:
    """Read and convert an official backbone checkpoint for ``cfg.conv``."""
    return convert_backbone(_load_state_dict(path), cfg.conv, cfg)
