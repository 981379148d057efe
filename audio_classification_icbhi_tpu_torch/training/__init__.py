"""Training: optimizers, LR schedules, the trainers and validation.

The names of the JAX package's `training` load on first access."""

from audio_classification_icbhi_tpu_torch import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "schedules": ("CosineAnnealingLR", "ReduceLROnPlateau", "StepLR", "build_scheduler"),
    "optimizers": ("build_optimizer",),
    "trainer": ("Trainer",),
    "trainer_legacy": ("LegacyTrainer",),
    "trainer_icbhi": ("TrainerWithICBHI",),
    "validation": ("Validator",),
})
