"""The train and eval steps, and the data-parallel mesh they shard over.

The names of the JAX package's `parallel` load on first access."""

from audio_classification_icbhi_tpu_torch import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "mesh": ("DATA_AXIS", "get_mesh", "shard_batch"),
    "data_parallel": ("TrainStepFns", "make_step_fns", "weighted_cross_entropy"),
})
