"""LightweightCNN weights between the JAX package's flax variables and the
port's torch state_dict.

Flax {"params", "batch_stats"} use ConvBlock_{i}/Conv_0 (HWIO kernels),
ConvBlock_{i}/BatchNorm_0 (scale/bias; batch_stats mean/var) and
Dense_{0,1} ((in, out) kernels). The state_dict uses the reference's torch
names: conv{i+1}.conv.weight (OIHW), conv{i+1}.bn.{weight, bias,
running_mean, running_var, num_batches_tracked}, fc1/fc2 ((out, in)).
`flax_from_state_dict` computes what the JAX package's
`models/torch_import.convert_lightweight_cnn` computes.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _t(x) -> torch.Tensor:
    return torch.tensor(_np(x))  # a copy: checkpoint arrays may be read-only


def state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """flax variables (numpy or array leaves) -> LightweightCNN state_dict."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    for i in range(5):
        p, s, t = params[f"ConvBlock_{i}"], stats[f"ConvBlock_{i}"], f"conv{i + 1}"
        sd[f"{t}.conv.weight"] = _t(_np(p["Conv_0"]["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{t}.bn.weight"] = _t(p["BatchNorm_0"]["scale"])
        sd[f"{t}.bn.bias"] = _t(p["BatchNorm_0"]["bias"])
        sd[f"{t}.bn.running_mean"] = _t(s["BatchNorm_0"]["mean"])
        sd[f"{t}.bn.running_var"] = _t(s["BatchNorm_0"]["var"])
        sd[f"{t}.bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    for j in range(2):
        d = params[f"Dense_{j}"]
        sd[f"fc{j + 1}.weight"] = _t(_np(d["kernel"]).T)
        sd[f"fc{j + 1}.bias"] = _t(d["bias"])
    return sd


def flax_from_state_dict(sd: dict) -> dict:
    """LightweightCNN state_dict -> flax variables with numpy leaves."""
    params: dict = {}
    batch_stats: dict = {}
    for i in range(5):
        t = f"conv{i + 1}"
        params[f"ConvBlock_{i}"] = {
            "Conv_0": {"kernel": np.ascontiguousarray(_np(sd[f"{t}.conv.weight"]).transpose(2, 3, 1, 0))},
            "BatchNorm_0": {"scale": _np(sd[f"{t}.bn.weight"]), "bias": _np(sd[f"{t}.bn.bias"])},
        }
        batch_stats[f"ConvBlock_{i}"] = {"BatchNorm_0": {
            "mean": _np(sd[f"{t}.bn.running_mean"]), "var": _np(sd[f"{t}.bn.running_var"])}}
    for j in range(2):
        params[f"Dense_{j}"] = {"kernel": np.ascontiguousarray(_np(sd[f"fc{j + 1}.weight"]).T),
                                "bias": _np(sd[f"fc{j + 1}.bias"])}
    return {"params": params, "batch_stats": batch_stats}
