"""Classifiers as torch nn.Modules (LightweightCNN in this slice)."""

from audio_classification_icbhi_tpu_torch.models.cnn import (  # noqa: F401
    ConvBlock,
    LightweightCNN,
    count_parameters,
)
from audio_classification_icbhi_tpu_torch.models.registry import build_model  # noqa: F401
