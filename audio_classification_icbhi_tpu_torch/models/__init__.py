"""Classifiers as torch nn.Modules (LightweightCNN, CompactResNet18 and the
port's own AST, `models/ast.py`), the registry that builds them and a user's
registered architectures, and the opt-in fused inference forward of
LightweightCNN."""

from audio_classification_icbhi_tpu_torch.models.cnn import (  # noqa: F401
    ConvBlock,
    LightweightCNN,
    count_parameters,
)
from audio_classification_icbhi_tpu_torch.models.resnet import CompactResNet  # noqa: F401
from audio_classification_icbhi_tpu_torch.models.fused_infer import (  # noqa: F401
    fused_apply_supported,
    fused_cnn_enabled,
    fused_kernels_available,
    make_fused_apply,
)
from audio_classification_icbhi_tpu_torch.models.registry import (  # noqa: F401
    available_models,
    build_model,
    register_model,
)
