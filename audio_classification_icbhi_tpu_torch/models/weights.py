"""LightweightCNN weights between the JAX package's flax variables and the
port's torch state_dict.

Flax {"params", "batch_stats"} use ConvBlock_{i}/Conv_0 (HWIO kernels),
ConvBlock_{i}/BatchNorm_0 (scale/bias; batch_stats mean/var) and
Dense_{0,1} ((in, out) kernels). The state_dict uses the reference's torch
names: conv{i+1}.conv.weight (OIHW), conv{i+1}.bn.{weight, bias,
running_mean, running_var, num_batches_tracked}, fc1/fc2 ((out, in)).
`flax_from_state_dict` computes what the JAX package's
`models/torch_import.convert_lightweight_cnn` computes. The optimizer state
crosses too (`opt_state_from_optax`, `optax_from_opt_state`), so a checkpoint
written by either package's trainer resumes in the other.
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


# LightweightCNN's parameters in `named_parameters()` order, which is also the
# order of a torch optimizer's param group built from `model.parameters()`.
PARAM_NAMES = tuple(
    [f"conv{i}.{leaf}" for i in range(1, 6) for leaf in ("conv.weight", "bn.weight", "bn.bias")]
    + ["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"])


def params_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax "params" tree (or an optimizer moment of the same shape) ->
    {PARAM_NAMES: tensor} in torch layout."""
    out: dict[str, torch.Tensor] = {}
    for i in range(5):
        p, t = params[f"ConvBlock_{i}"], f"conv{i + 1}"
        out[f"{t}.conv.weight"] = _t(_np(p["Conv_0"]["kernel"]).transpose(3, 2, 0, 1))
        out[f"{t}.bn.weight"] = _t(p["BatchNorm_0"]["scale"])
        out[f"{t}.bn.bias"] = _t(p["BatchNorm_0"]["bias"])
    for j in range(2):
        d = params[f"Dense_{j}"]
        out[f"fc{j + 1}.weight"] = _t(_np(d["kernel"]).T)
        out[f"fc{j + 1}.bias"] = _t(d["bias"])
    return out


def flax_from_params(named: dict) -> dict:
    """{PARAM_NAMES: tensor} in torch layout -> flax "params" tree with
    numpy leaves (the inverse of params_from_flax)."""
    params: dict = {}
    for i in range(5):
        t = f"conv{i + 1}"
        params[f"ConvBlock_{i}"] = {
            "Conv_0": {"kernel": np.ascontiguousarray(_np(named[f"{t}.conv.weight"]).transpose(2, 3, 1, 0))},
            "BatchNorm_0": {"scale": _np(named[f"{t}.bn.weight"]), "bias": _np(named[f"{t}.bn.bias"])},
        }
    for j in range(2):
        params[f"Dense_{j}"] = {"kernel": np.ascontiguousarray(_np(named[f"fc{j + 1}.weight"]).T),
                                "bias": _np(named[f"fc{j + 1}.bias"])}
    return params


def state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """flax variables (numpy or array leaves) -> LightweightCNN state_dict."""
    sd = params_from_flax(variables["params"])
    stats = variables.get("batch_stats", {})
    for i in range(5):
        s, t = stats[f"ConvBlock_{i}"], f"conv{i + 1}"
        sd[f"{t}.bn.running_mean"] = _t(s["BatchNorm_0"]["mean"])
        sd[f"{t}.bn.running_var"] = _t(s["BatchNorm_0"]["var"])
        sd[f"{t}.bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def flax_from_state_dict(sd: dict) -> dict:
    """LightweightCNN state_dict -> flax variables with numpy leaves."""
    batch_stats = {
        f"ConvBlock_{i}": {"BatchNorm_0": {"mean": _np(sd[f"conv{i + 1}.bn.running_mean"]),
                                           "var": _np(sd[f"conv{i + 1}.bn.running_var"])}}
        for i in range(5)}
    return {"params": flax_from_params(sd), "batch_stats": batch_stats}


# --- optimizer state ---------------------------------------------------------
#
# The JAX package's optimizers are optax chains (`training/optimizers.py`):
#   adam:  [add_decayed_weights(wd)], scale_by_adam   -> ScaleByAdamState last
#   adamw: scale_by_adam, [add_decayed_weights(wd)]   -> ScaleByAdamState first
#   sgd:   [add_decayed_weights(wd)], trace(0.9)      -> TraceState last
# ([...] only when wd != 0). In flax's state-dict form a chain is a dict keyed
# "0", "1", ...; add_decayed_weights holds an empty state ({}). Adam's
# (count, mu, nu) is torch's (step, exp_avg, exp_avg_sq); trace is
# momentum_buffer. Moments carry the parameters' layout transposes.

def _chain_slots(name: str, weight_decay: float) -> tuple[int, int]:
    """(number of chain entries, index of the stateful one)."""
    name = (name or "adam").lower()
    if not weight_decay:
        return 1, 0
    return 2, (0 if name == "adamw" else 1)


def opt_state_from_optax(opt_state: dict, params, name: str) -> dict[int, dict]:
    """optax chain state in flax state-dict form -> the "state" part of a
    torch optimizer's state_dict, keyed by the position of each parameter
    in `params` (model.named_parameters(), PARAM_NAMES order). Load it with
    optimizer.load_state_dict({"state": ..., "param_groups": ...})."""
    inner = next(v for v in opt_state.values() if v)
    names = [n for n, _ in params]
    if names != list(PARAM_NAMES):
        raise ValueError(f"parameters are not LightweightCNN's, in order: {names}")
    if (name or "adam").lower() in ("adam", "adamw"):
        count = int(np.asarray(inner["count"]))
        if count == 0:
            return {}
        mu, nu = params_from_flax(inner["mu"]), params_from_flax(inner["nu"])
        return {i: {"step": torch.tensor(float(count)), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                for i, n in enumerate(names)}
    trace = params_from_flax(inner["trace"])
    return {i: {"momentum_buffer": trace[n]} for i, n in enumerate(names)}


def optax_from_opt_state(optimizer: torch.optim.Optimizer, name: str) -> dict:
    """A torch optimizer over LightweightCNN's parameters -> the optax
    chain state of the same optimizer in flax state-dict form, numpy leaves.
    Before the first step the moments are zeros and the count is 0, as
    optax's init gives them."""
    group = optimizer.param_groups[0]
    tensors = group["params"]
    if len(tensors) != len(PARAM_NAMES):
        raise ValueError("optimizer is not over LightweightCNN's parameters")
    states = [optimizer.state.get(p, {}) for p in tensors]

    def moment(key):
        return flax_from_params({n: st[key] if key in st else torch.zeros_like(p)
                                 for n, p, st in zip(PARAM_NAMES, tensors, states)})

    if (name or "adam").lower() in ("adam", "adamw"):
        step = states[0].get("step", 0)
        inner = {"count": np.asarray(int(step), np.int32),
                 "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}
    else:
        inner = {"trace": moment("momentum_buffer")}
    n, slot = _chain_slots(name, group["weight_decay"])
    return {str(i): (inner if i == slot else {}) for i in range(n)}
