"""audio_classification_icbhi_tpu_torch — the PyTorch/CUDA port of
audio_classification_icbhi_tpu for one NVIDIA H100.

It carries the serving path, wav -> probabilities: the log-mel front end
(hand-written Hopper kernels, `ops/mel_kernels.py`), LightweightCNN and
CompactResNet18 on cuDNN (`models/`, with the torch state_dict import),
checkpoints in the JAX package's msgpack format, the inference engine and
its CLI; and the training path: augmentation (`ops/augment.py`), the
kernel's SpecAugment-masked form, the train and eval steps
(`parallel/data_parallel.py`), the trainers (`training/`), the data pipeline
(`data/`) and the `train` / `train_icbhi` entry points; and the
sliding-window analyzers (`analyzers/`, the `analyze` entry point), whose
sub-second windows run a second hand-written kernel, the radix-8 log-mel;
and the opt-in fused CNN (`ICBHI_FUSED_CNN=1`, `models/fused_infer.py`),
whose blocks 1-3 run hand-written conv-block kernels (`ops/conv_kernels.py`);
and evaluation and the segmented ICBHI path: the segmenter
(`preprocess_icbhi`), the per-cycle dataset, `train_segmented` and
`train_icbhi` at config_segmented.yaml, the Validator, numpy metrics, and
the `validate` / `validate_icbhi` entry points with their reports (PNGs
through `utils/plotting`, which alone imports matplotlib, inside its
functions); and data-parallel training over ranks, one a device
(`parallel/mesh.py`: NCCL between GPUs, gloo between CPU processes; the
sharded step, cross-rank BatchNorm, `train --num-devices / --multihost`,
the sharded Validator and analyzer), and the fp16 loss-scale mode
(`training.precision: fp16`, also through the LegacyTrainer). Entry points
run on the card unless the caller passes device="cpu".

Nothing heavy is imported here; the exports load on first access.
"""

__version__ = "0.1.0"


def lazy_exports(package: str, modules: dict[str, tuple[str, ...]]):
    """(__getattr__, __all__) for `package`, whose names are exported from
    its submodules, {submodule: names}: a name's submodule is imported on
    the name's first access, so importing the package imports none of them."""
    owner = {name: f"{package}.{module}" for module, names in modules.items() for name in names}

    def __getattr__(name):
        if name in owner:
            import importlib

            return getattr(importlib.import_module(owner[name]), name)
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    return __getattr__, list(owner)


__getattr__, __all__ = lazy_exports(__name__, {
    "utils.config": ("load_config", "set_seed"),
    "ops.mel": ("MelFrontend",),
    "models.registry": ("build_model",),
    "inference": ("ClassifierEngine",),
})
