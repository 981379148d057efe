"""Sliding-window analyzers.

Port of `audio_classification_icbhi_tpu/analyzers/`: one engine, windows ->
flexible log-mel -> classifier -> probabilities over the whole padded window
batch in one device pass, with the five analyzer scripts' differences
expressed as detection modes and CSV layouts (`analyze.py`), and their
pictures (`analyzers/viz.py`: the 3-panel view, the timeline, the
spectrogram overlay; matplotlib, imported only where a picture is drawn).
"""

from audio_classification_icbhi_tpu_torch.analyzers.engine import (  # noqa: F401
    CLASS_MAP,
    AnalyzerEngine,
    FlexibleMelFrontend,
    SegmentResult,
)
