"""`model.pretrained`: the port's torch state_dict import against the JAX
package's `models/torch_import.py`, and the trainer's use of it, on the CPU.

State_dicts are made from a seed: the reference's CompactResNet (names under
`resnet.`), the same without the prefix, a plain torchvision resnet18 (a
3-channel stem and a 1000-class `fc`), and LightweightCNN's. Nothing is
downloaded.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from audio_classification_icbhi_tpu.models import torch_import as jax_import
from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.data.synthetic import generate_icbhi_dataset
from audio_classification_icbhi_tpu_torch.models import CompactResNet, LightweightCNN, build_model
from audio_classification_icbhi_tpu_torch.models import torch_import
from audio_classification_icbhi_tpu_torch.models.weights import flax_from_state_dict
from audio_classification_icbhi_tpu_torch.training.trainer import Trainer
from audio_classification_icbhi_tpu_torch.utils.config import load_config
from test_torch_cnn import assert_trees_equal

REPO = Path(__file__).resolve().parent.parent


def seeded_resnet_sd(seed: int = 0) -> dict[str, torch.Tensor]:
    """The reference CompactResNet's state_dict, every tensor from a seed
    (BN statistics too)."""
    g = torch.Generator().manual_seed(seed)
    sd = CompactResNet(generator=g).state_dict()
    return {k: v if k.endswith("tracked") else torch.randn(v.shape, generator=g) * 0.1 + (
        1.0 if k.endswith("running_var") else 0.0) for k, v in sd.items()}


def torchvision_resnet18_sd(seed: int = 1) -> dict[str, torch.Tensor]:
    """A plain torchvision resnet18 state_dict: 3-channel stem, fc 512 -> 1000."""
    sd = {k.removeprefix("resnet."): v for k, v in seeded_resnet_sd(seed).items()
          if not k.startswith("resnet.fc.")}
    g = torch.Generator().manual_seed(seed + 100)
    sd["conv1.weight"] = torch.randn((64, 3, 7, 7), generator=g) * 0.05
    sd["fc.weight"] = torch.randn((1000, 512), generator=g) * 0.01
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def merged_flax(init_sd: dict, converted: dict) -> dict:
    """flax variables of `init_sd` with the converted keys replacing their
    init: what the port's trainer loads, in flax form."""
    return flax_from_state_dict({**init_sd, **converted})


def jax_merged(init_variables: dict, converted: dict) -> dict:
    """The JAX trainer's `merge` (training/trainer.py:247-253 there)."""
    def merge(init_tree, new_tree):
        out = dict(init_tree)
        for k, v in new_tree.items():
            out[k] = merge(init_tree[k], v) if isinstance(v, dict) and k in out else v
        return out
    return {"params": merge(init_variables["params"], converted["params"]),
            "batch_stats": merge(init_variables["batch_stats"], converted["batch_stats"])}


@pytest.mark.parametrize("form", ["reference", "unprefixed", "torchvision"])
def test_convert_resnet18_matches_jax(form):
    """The reference's state_dict with and without its `resnet.` prefix, and
    a torchvision one whose 3-channel stem is summed to 1 and whose fc is
    dropped: the port's import, laid over a seeded init, equals the JAX
    import laid over the same init, leaf for leaf."""
    sd = seeded_resnet_sd()
    if form == "unprefixed":
        sd = {k.removeprefix("resnet."): v for k, v in sd.items()}
    elif form == "torchvision":
        sd = torchvision_resnet18_sd()
    init = CompactResNet(generator=torch.Generator().manual_seed(7)).state_dict()
    got = torch_import.convert_resnet18(sd, sum_rgb_stem=True)
    assert set(got) <= set(init)
    want = jax_merged(flax_from_state_dict(init),
                      jax_import.convert_resnet18(sd, sum_rgb_stem=True))
    assert_trees_equal(merged_flax(init, got), jax.tree_util.tree_map(np.asarray, want))
    if form == "torchvision":
        assert torch.equal(got["resnet.conv1.weight"], sd["conv1.weight"].sum(1, keepdim=True))
        assert not any(k.startswith("resnet.fc") for k in got)


def test_convert_lightweight_cnn_matches_jax():
    sd = LightweightCNN(generator=torch.Generator().manual_seed(3)).state_dict()
    got = torch_import.convert_lightweight_cnn(sd)
    assert set(got) == set(sd)
    assert_trees_equal(flax_from_state_dict(got), jax_import.convert_lightweight_cnn(sd))


def test_load_torch_checkpoint_unwraps(tmp_path):
    """The reference's save format (a dict with model_state_dict) and a bare
    state_dict both read back as the state_dict."""
    sd = seeded_resnet_sd()
    torch.save({"epoch": 3, "model_state_dict": sd}, tmp_path / "wrapped.pt")
    torch.save(sd, tmp_path / "bare.pt")
    for name in ("wrapped.pt", "bare.pt"):
        back = torch_import.load_torch_checkpoint(str(tmp_path / name))
        assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate_icbhi_dataset(tmp_path_factory.mktemp("synth"), num_recordings=4, seed=0)


def pretrained_trainer(corpus, tmp_path, arch: str, path) -> Trainer:
    config = load_config(str(REPO / "config.yaml"))
    config["model"].update(architecture=arch, pretrained=True)
    if path is not None:
        config["model"]["pretrained_path"] = str(path)
    config["data"]["duration"] = 1.0
    config["training"].update(checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "runs"))
    return Trainer(build_model(config), ICBHIDataset(corpus, "train", config),
                   ICBHIDataset(corpus, "val", config), config, device="cpu")


def test_trainer_imports_a_torchvision_resnet18(corpus, tmp_path, capsys):
    """model.pretrained with a torchvision-shaped .pt: the stem is the
    channel sum, every other trunk tensor is the file's, the head keeps the
    seeded init, and the trainer prints the JAX trainer's line with its
    count (the converted parameters)."""
    sd = torchvision_resnet18_sd()
    torch.save(sd, tmp_path / "resnet18.pt")
    trainer = pretrained_trainer(corpus, tmp_path, "resnet", tmp_path / "resnet18.pt")
    got = trainer.model.state_dict()
    assert torch.equal(got["resnet.conv1.weight"], sd["conv1.weight"].sum(1, keepdim=True))
    for k, v in sd.items():
        if k != "conv1.weight" and not k.startswith("fc."):
            assert torch.equal(got[f"resnet.{k}"], v), k
    init = CompactResNet(generator=torch.Generator().manual_seed(42)).state_dict()
    for k in ("resnet.fc.1.weight", "resnet.fc.1.bias", "resnet.fc.4.weight", "resnet.fc.4.bias"):
        assert torch.equal(got[k], init[k]), k
    n = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(
        jax_import.convert_resnet18(sd, sum_rgb_stem=True)["params"]))
    assert f"Loaded pretrained weights from {tmp_path / 'resnet18.pt'} ({n:,} params)" in \
        capsys.readouterr().out


def test_trainer_imports_the_reference_cnn(corpus, tmp_path):
    sd = LightweightCNN(generator=torch.Generator().manual_seed(5)).state_dict()
    torch.save({"model_state_dict": sd}, tmp_path / "cnn.pt")
    got = pretrained_trainer(corpus, tmp_path, "cnn", tmp_path / "cnn.pt").model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in sd.items())


def test_missing_pretrained_path_raises(corpus, tmp_path):
    with pytest.raises(ValueError, match="pretrained_path"):
        pretrained_trainer(corpus, tmp_path, "resnet", None)


def test_unexpected_key_raises(corpus, tmp_path):
    """Nothing but a torchvision fc is dropped: a key the model does not
    have stops the import."""
    sd = seeded_resnet_sd()
    sd["resnet.layer5.0.conv1.weight"] = torch.zeros(3)
    torch.save(sd, tmp_path / "extra.pt")
    with pytest.raises(ValueError, match="layer5"):
        pretrained_trainer(corpus, tmp_path, "resnet", tmp_path / "extra.pt")
