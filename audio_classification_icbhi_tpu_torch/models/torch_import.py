"""Import the reference models' torch state_dicts into the port's.

The port's own copy of `audio_classification_icbhi_tpu/models/torch_import.py`;
it gives the port's state_dicts instead of flax trees:

- LightweightCNN (reference src/models/cnn.py:33-103): the reference's
  names are the port's, so its state_dict loads as it is;
- CompactResNet = torchvision resnet18 with a 1-channel stem and a 2-layer
  head (reference src/models/resnet.py:19-39), with or without its
  `resnet.` prefix; also a plain torchvision resnet18 state_dict (the
  ImageNet path, reference resnet.py:23-26): its 3-channel stem is summed
  to one channel and its 1000-class `fc.weight` / `fc.bias` are dropped,
  since the reference replaces that head with its own.

Every other key is kept: the caller loads the result and so meets any key
the model does not have (`training/trainer.Trainer._load_pretrained` raises
on it).
"""

from __future__ import annotations

import torch


def _float(sd: dict) -> dict[str, torch.Tensor]:
    """Tensors (or arrays) as float32 tensors; integer counters stay."""
    out = {}
    for k, v in sd.items():
        v = torch.as_tensor(v).detach().cpu()
        out[k] = v if k.endswith("num_batches_tracked") else v.float()
    return out


def convert_lightweight_cnn(state_dict: dict) -> dict[str, torch.Tensor]:
    """torch LightweightCNN state_dict -> the port's (the same names)."""
    return _float(state_dict)


def convert_resnet18(state_dict: dict, *, sum_rgb_stem: bool = False) -> dict[str, torch.Tensor]:
    """torch CompactResNet / torchvision resnet18 state_dict -> the port's
    CompactResNet state_dict (keys under `resnet.`).

    sum_rgb_stem=True accepts an ImageNet 3-channel stem and folds it to the
    1-channel stem by summing input channels (the same response on
    gray-replicated input)."""
    sd = _float(state_dict)
    if any(k.startswith("resnet.") for k in sd):
        sd = {k.removeprefix("resnet."): v for k, v in sd.items()}
    # a plain torchvision fc (fc.weight) is dropped: the reference replaces
    # it with its own head (resnet.py:32-39)
    sd = {k: v for k, v in sd.items() if k not in ("fc.weight", "fc.bias")}
    if sum_rgb_stem and sd["conv1.weight"].shape[1] == 3:
        sd["conv1.weight"] = sd["conv1.weight"].sum(dim=1, keepdim=True)
    return {f"resnet.{k}": v for k, v in sd.items()}


def load_torch_checkpoint(path: str) -> dict:
    """Read a torch .pt checkpoint (the reference's save format,
    trainer_fixed.py:314-324) and return its model state_dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        return ckpt["model_state_dict"]
    return ckpt
