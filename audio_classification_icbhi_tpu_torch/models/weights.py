"""Classifier weights between the JAX package's flax variables and the
port's torch state_dict, for both architectures.

Each architecture has one name table: a row per module, (torch module name,
flax module path, kind). A kind fixes the leaves and their layouts:

- "conv": weight (O, I, H, W) <-> kernel (H, W, I, O);
- "linear": weight (out, in) <-> kernel (in, out), bias <-> bias;
- "bn": weight/bias <-> params scale/bias, running_mean/running_var <->
  batch_stats mean/var (num_batches_tracked, which flax lacks, comes back 0).

LightweightCNN: conv{i+1}.conv / conv{i+1}.bn <-> ConvBlock_{i}/Conv_0 /
BatchNorm_0, fc1/fc2 <-> Dense_0/Dense_1. CompactResNet: resnet.conv1 /
resnet.bn1 <-> stem_conv / stem_bn, resnet.layer{s}.{b}.{conv1, bn1, conv2,
bn2, downsample.0, downsample.1} <-> layer{s}_block{b}/{conv1, bn1, conv2,
bn2, downsample_conv, downsample_bn}, resnet.fc.1/resnet.fc.4 <->
Dense_0/Dense_1. The table is read off the flax tree's keys (`stem_conv`
or `ConvBlock_0`, and the blocks present) or the torch names, so any
`stage_sizes` crosses. `flax_from_state_dict` computes what the JAX
package's `models/torch_import.convert_lightweight_cnn` and
`convert_resnet18` compute.

The optimizer state crosses too (`opt_state_from_optax`,
`optax_from_opt_state`), by parameter name, so a checkpoint written by
either package's trainer resumes in the other.

A model registered with `models/registry.register_model` crosses by the
table its class's `weight_table()` gives, or, without one, under its torch
names split at the dots (`resnet.fc.1.weight` -> params["resnet"]["fc"]["1"]
["weight"]; the whole state_dict, its buffers too, in the params tree).
Each function takes the config's `architecture` for that; a tree that
matches neither builtin, of an architecture without a registered table,
raises.
"""

from __future__ import annotations

import re

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

# kind -> (torch leaf, flax leaf, layout) of its parameters
_PARAM_LEAVES = {
    "conv": (("weight", "kernel", "conv"),),
    "linear": (("weight", "kernel", "linear"), ("bias", "bias", "vector")),
    "bn": (("weight", "scale", "vector"), ("bias", "bias", "vector")),
}
_STAT_LEAVES = (("running_mean", "mean"), ("running_var", "var"))


def _cnn_table() -> list[tuple[str, tuple, str]]:
    rows = []
    for i in range(5):
        rows += [(f"conv{i + 1}.conv", (f"ConvBlock_{i}", "Conv_0"), "conv"),
                 (f"conv{i + 1}.bn", (f"ConvBlock_{i}", "BatchNorm_0"), "bn")]
    return rows + [("fc1", ("Dense_0",), "linear"), ("fc2", ("Dense_1",), "linear")]


def _resnet_table(blocks) -> list[tuple[str, tuple, str]]:
    """blocks: (stage, block, has_downsample) in order; rows in torch's
    registration (`named_parameters`) order."""
    rows = [("resnet.conv1", ("stem_conv",), "conv"), ("resnet.bn1", ("stem_bn",), "bn")]
    for stage, block, down in blocks:
        t, f = f"resnet.layer{stage}.{block}", f"layer{stage}_block{block}"
        rows += [(f"{t}.conv1", (f, "conv1"), "conv"), (f"{t}.bn1", (f, "bn1"), "bn"),
                 (f"{t}.conv2", (f, "conv2"), "conv"), (f"{t}.bn2", (f, "bn2"), "bn")]
        if down:
            rows += [(f"{t}.downsample.0", (f, "downsample_conv"), "conv"),
                     (f"{t}.downsample.1", (f, "downsample_bn"), "bn")]
    return rows + [("resnet.fc.1", ("Dense_0",), "linear"), ("resnet.fc.4", ("Dense_1",), "linear")]


def _table_from_flax(params: dict) -> list[tuple[str, tuple, str]] | None:
    if "stem_conv" not in params:
        return _cnn_table() if "ConvBlock_0" in params else None
    found = (re.fullmatch(r"layer(\d+)_block(\d+)", k) for k in params)
    blocks = sorted((int(m[1]), int(m[2])) for m in found if m)
    return _resnet_table([(s, b, "downsample_conv" in params[f"layer{s}_block{b}"])
                          for s, b in blocks])


def _table_from_torch(names) -> list[tuple[str, tuple, str]] | None:
    names = set(names)
    if "resnet.conv1.weight" not in names:
        return _cnn_table() if "conv1.conv.weight" in names else None
    found = (re.fullmatch(r"resnet\.layer(\d+)\.(\d+)\.conv1\.weight", k) for k in names)
    blocks = sorted((int(m[1]), int(m[2])) for m in found if m)
    return _resnet_table([(s, b, f"resnet.layer{s}.{b}.downsample.0.weight" in names)
                          for s, b in blocks])


def _registered(architecture: str | None):
    """The class registered under `architecture` when it is not a builtin,
    else None."""
    from audio_classification_icbhi_tpu_torch.models.cnn import LightweightCNN
    from audio_classification_icbhi_tpu_torch.models.registry import _REGISTRY
    from audio_classification_icbhi_tpu_torch.models.resnet import CompactResNet

    cls = _REGISTRY.get((architecture or "").lower())
    return None if cls in (None, LightweightCNN, CompactResNet) else cls


def _table(architecture: str | None, tree: dict, from_flax: bool):
    """The name table of `tree` (flax params, or torch names): a registered
    architecture's own, or None without one (its torch names cross as
    they are); a builtin's, read off the keys, for a builtin or no
    architecture."""
    cls = _registered(architecture)
    if cls is not None:
        table = getattr(cls, "weight_table", None)
        return None if table is None else list(table())
    rows = _table_from_flax(tree) if from_flax else _table_from_torch(tree)
    if rows is None:
        raise ValueError(f"architecture {architecture!r}: the weights match neither builtin "
                         "(no stem_conv / ConvBlock_0, resnet.conv1 / conv1.conv) and no "
                         "registered model's table")
    return rows


def _flatten(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """A nested dict -> {dotted path: tensor}, dtypes kept."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.clone() if isinstance(v, torch.Tensor) else torch.tensor(np.array(v))
    return out


def _nest(named: dict) -> dict:
    """{dotted name: tensor} -> the nested dict of numpy copies (floats as
    float32, other dtypes kept)."""
    tree: dict = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        t = torch.as_tensor(t).detach().cpu()
        _node(tree, tuple(path), create=True)[leaf] = np.array(
            (t.float() if t.is_floating_point() else t).numpy())
    return tree


# layout -> (the axes from flax's order to torch's, and back)
_AXES = {"conv": ((3, 2, 0, 1), (2, 3, 1, 0)), "linear": ((1, 0), (1, 0)),
         "vector": ((0,), (0,))}


def _to_torch(x: np.ndarray, layout: str) -> np.ndarray:
    return x.transpose(_AXES[layout][0])


def _to_flax(x: np.ndarray, layout: str) -> np.ndarray:
    return np.ascontiguousarray(x.transpose(_AXES[layout][1]))


def _node(tree: dict, path: tuple, create: bool = False) -> dict:
    for key in path:
        tree = tree.setdefault(key, {}) if create else tree[key]
    return tree


def params_from_flax(params: dict, architecture: str | None = None) -> dict[str, torch.Tensor]:
    """flax "params" tree (or an optimizer moment of the same shape) ->
    {torch parameter name: tensor} in torch layout, in the model's
    `named_parameters()` order."""
    table = _table(architecture, params, from_flax=True)
    if table is None:
        return _flatten(params)
    out: dict[str, torch.Tensor] = {}
    for t, path, kind in table:
        node = _node(params, path)
        for tl, fl, layout in _PARAM_LEAVES[kind]:
            out[f"{t}.{tl}"] = _t(_to_torch(_np(node[fl]), layout))
    return out


def flax_from_params(named: dict, architecture: str | None = None) -> dict:
    """{torch parameter name: tensor} in torch layout (a state_dict will
    do) -> flax "params" tree with numpy leaves (the inverse of
    params_from_flax)."""
    table = _table(architecture, named, from_flax=False)
    if table is None:
        return _nest(named)
    params: dict = {}
    for t, path, kind in table:
        node = _node(params, path, create=True)
        for tl, fl, layout in _PARAM_LEAVES[kind]:
            node[fl] = _to_flax(_np(named[f"{t}.{tl}"]), layout)
    return params


def state_dict_from_flax(variables: dict,
                         architecture: str | None = None) -> dict[str, torch.Tensor]:
    """flax variables (numpy or array leaves) -> the port's state_dict."""
    table = _table(architecture, variables["params"], from_flax=True)
    if table is None:
        return _flatten(variables["params"]) | _flatten(variables.get("batch_stats", {}))
    sd = params_from_flax(variables["params"], architecture)
    stats = variables.get("batch_stats", {})
    for t, path, kind in table:
        if kind == "bn":
            node = _node(stats, path)
            for tl, fl in _STAT_LEAVES:
                sd[f"{t}.{tl}"] = _t(node[fl])
            sd[f"{t}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def flax_from_state_dict(sd: dict, architecture: str | None = None) -> dict:
    """The port's state_dict -> flax variables with numpy leaves."""
    table = _table(architecture, sd, from_flax=False)
    if table is None:
        return {"params": _nest(sd), "batch_stats": {}}
    batch_stats: dict = {}
    for t, path, kind in table:
        if kind == "bn":
            node = _node(batch_stats, path, create=True)
            for tl, fl in _STAT_LEAVES:
                node[fl] = _np(sd[f"{t}.{tl}"])
    return {"params": flax_from_params(sd, architecture), "batch_stats": batch_stats}


# --- optimizer state ---------------------------------------------------------
#
# The JAX package's optimizers are optax chains (`training/optimizers.py`):
#   adam:  [add_decayed_weights(wd)], scale_by_adam   -> ScaleByAdamState last
#   adamw: scale_by_adam, [add_decayed_weights(wd)]   -> ScaleByAdamState first
#   sgd:   [add_decayed_weights(wd)], trace(0.9)      -> TraceState last
# ([...] only when wd != 0). In flax's state-dict form a chain is a dict keyed
# "0", "1", ...; add_decayed_weights holds an empty state ({}). Adam's
# (count, mu, nu) is torch's (step, exp_avg, exp_avg_sq); trace is
# momentum_buffer. Moments carry the parameters' layout transposes and
# cross by parameter name: flax's tree order is not torch's.

def _chain_slots(name: str, weight_decay: float) -> tuple[int, int]:
    """(number of chain entries, index of the stateful one)."""
    name = (name or "adam").lower()
    if not weight_decay:
        return 1, 0
    return 2, (0 if name == "adamw" else 1)


def _check_names(moment: dict, names: list[str]) -> None:
    missing, extra = sorted(set(names) - set(moment)), sorted(set(moment) - set(names))
    if missing or extra:
        raise ValueError(f"optimizer state does not match the parameters: missing {missing}, "
                         f"extra {extra}")


def opt_state_from_optax(opt_state: dict, params, name: str,
                         architecture: str | None = None) -> dict[int, dict]:
    """optax chain state in flax state-dict form -> the "state" part of a
    torch optimizer's state_dict, keyed by the position of each parameter
    in `params` (model.named_parameters(), the optimizer's order), matched
    by name. Load it with
    optimizer.load_state_dict({"state": ..., "param_groups": ...})."""
    inner = next(v for v in opt_state.values() if v)
    names = [n for n, _ in params]
    if (name or "adam").lower() in ("adam", "adamw"):
        count = int(np.asarray(inner["count"]))
        if count == 0:
            return {}
        mu, nu = (params_from_flax(inner[k], architecture) for k in ("mu", "nu"))
        _check_names(mu, names)
        return {i: {"step": torch.tensor(float(count)), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                for i, n in enumerate(names)}
    trace = params_from_flax(inner["trace"], architecture)
    _check_names(trace, names)
    return {i: {"momentum_buffer": trace[n]} for i, n in enumerate(names)}


def optax_from_opt_state(optimizer: torch.optim.Optimizer, name: str,
                         architecture: str | None = None) -> dict:
    """A torch optimizer over a classifier's parameters -> the optax chain
    state of the same optimizer in flax state-dict form, numpy leaves.
    The names are the optimizer's own when it was built over
    `model.named_parameters()`; one built over `model.parameters()` is
    taken to hold LightweightCNN's, in PARAM_NAMES order. Before the first
    step the moments are zeros and the count is 0, as optax's init gives
    them."""
    group = optimizer.param_groups[0]
    tensors = group["params"]
    names = group.get("param_names") or list(PARAM_NAMES)
    if len(tensors) != len(names):
        raise ValueError("the optimizer's parameters are unnamed and not LightweightCNN's: "
                         "build it over model.named_parameters()")
    states = [optimizer.state.get(p, {}) for p in tensors]

    def moment(key):
        return flax_from_params({n: st[key] if key in st else torch.zeros_like(p)
                                 for n, p, st in zip(names, tensors, states)}, architecture)

    if (name or "adam").lower() in ("adam", "adamw"):
        step = states[0].get("step", 0)
        inner = {"count": np.asarray(int(step), np.int32),
                 "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}
    else:
        inner = {"trace": moment("momentum_buffer")}
    n, slot = _chain_slots(name, group["weight_decay"])
    return {str(i): (inner if i == slot else {}) for i in range(n)}
