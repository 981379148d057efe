"""wav -> features, the front half of every eval step.

Port of the eval branch of `features_from_wavs`
(`audio_classification_icbhi_tpu/parallel/data_parallel.py:64-101`). The
training branch (waveform and SpecAugment augmentation) comes with the
training slice.
"""

from __future__ import annotations

import torch

from audio_classification_icbhi_tpu_torch.ops.mel import MelFrontend, normalize_spectrogram


def features_from_wavs(frontend: MelFrontend, wavs: torch.Tensor, *,
                       augment: bool = False) -> torch.Tensor:
    """wav (B, L) -> normalized log-mel image (B, n_mels, T, 1).

    On a kernel route the normalize runs inside the kernel's epilogue; on
    the plain route it follows the log-mel."""
    if augment:
        raise NotImplementedError(
            "augmented features come with the training slice (ROADMAP.md A5)")
    if frontend.uses_kernel(wavs):
        mel = frontend._pallas_log_mel(wavs, normalize=True)
    else:
        mel = normalize_spectrogram(frontend.log_mel(wavs))
    return mel[..., None]
