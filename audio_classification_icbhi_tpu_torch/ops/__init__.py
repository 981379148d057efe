"""Ops: STFT, mel, augmentation, resampling, time stretch, the Hopper log-mel
kernels and the fused conv-block kernels.

The names of the JAX package's `ops` load on first access, so importing
this package builds and loads no kernel module."""

from audio_classification_icbhi_tpu_torch import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "stft": ("frame_signal", "hann_window", "num_frames", "reflect_pad", "spectrogram",
             "stft_power"),
    "mel": ("MelFrontend", "amplitude_to_db", "hz_to_mel", "log_mel_spectrogram",
            "mel_filterbank", "mel_to_hz", "power_to_db"),
    "augment": ("add_noise", "augment_spectrogram", "augment_waveform", "freq_mask",
                "spec_mask_bounds", "time_mask", "time_shift"),
    "time_stretch": ("TimeStretch", "phase_vocoder", "stft_complex"),
    "conv_kernels": ("fused_conv_block1", "fused_conv_block2", "fused_conv_block3"),
})

# `resample` names a submodule and its function. As in the JAX package, the
# function is bound over the submodule here, whatever was imported first (the
# module itself: `importlib.import_module("...ops.resample")`).
from audio_classification_icbhi_tpu_torch.ops.resample import resample  # noqa: E402

__all__ += ["resample"]
