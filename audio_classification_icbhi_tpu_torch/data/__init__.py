"""Host-side data: the WAV codec, annotations, the datasets and loaders, the
device-resident cache, the segmenter and the synthetic corpora.

The names of the JAX package's `data` load on first access."""

from audio_classification_icbhi_tpu_torch import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "wavio": ("load_audio", "read_wav", "write_wav"),
    "annotations": ("CLASS_MAP", "CLASS_NAMES", "label_from_flags", "parse_annotation_file",
                    "recording_label"),
    "dataset": ("ICBHIDataset",),
    "dataset_segmented": ("ICBHISegmentedDataset",),
    "loader": ("BatchLoader",),
    "segmenter": ("ICBHISegmenter",),
    "synthetic": ("generate_icbhi_corpus_fixture", "generate_icbhi_dataset",
                  "generate_segmented_dataset", "synth_respiratory_cycle"),
})
