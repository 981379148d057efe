"""Segmented (per-cycle) ICBHI dataset index.

Port of `audio_classification_icbhi_tpu/data/dataset_segmented.py:28-120`,
split for split in the same order: per-class directories normal/ crackle/
wheeze/ both/ (files sorted within each), a `random.Random(42)` shuffle,
then a positional train/val/test split by data.train_split and
data.val_split (defaults 0.7 / 0.15). The class distribution of the split
is printed.

The JAX package's documented deviation from the reference is kept:
config_segmented.yaml ships train 0.75 / val 0.45, which sum past 1 and
would leave the test split empty; when train + val >= 1, val becomes
(1 - train) / 2, with a warning.

Items are fixed-length waveforms (3 s where the config names no duration)
decoded on the host by `data/dataset.ICBHIDataset`, which this class
extends with its own index: `load_batch` is its native batch decode
(`dataset_segmented.py:116-120` of the JAX package).
"""

from __future__ import annotations

import random
from typing import Any

from audio_classification_icbhi_tpu_torch.data.annotations import SEGMENT_DIR_NAMES
from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset


class ICBHISegmentedDataset(ICBHIDataset):
    """Index of per-cycle wav segments; loading is `ICBHIDataset`'s."""

    CLASS_MAP = {name: i for i, name in enumerate(SEGMENT_DIR_NAMES)}
    DEFAULT_DURATION = 3.0

    def _load_index(self, data_cfg: dict[str, Any]) -> list[tuple[str, int]]:
        data = []
        for class_name, class_idx in self.CLASS_MAP.items():
            class_dir = self.root_dir / class_name
            if not class_dir.exists():
                print(f"Warning: Directory not found: {class_dir}")
                continue
            for wav_file in sorted(class_dir.glob("*.wav")):
                data.append((str(wav_file), class_idx))
        if not data:
            raise ValueError(f"No audio files found in {self.root_dir}")
        random.Random(42).shuffle(data)

        total = len(data)
        train_split = data_cfg.get("train_split", 0.7)
        val_split = data_cfg.get("val_split", 0.15)
        if train_split + val_split >= 1.0:
            fixed = (1.0 - train_split) * 0.5
            print(
                f"Warning: train_split+val_split = {train_split + val_split:.2f} >= 1; "
                f"renormalizing val_split {val_split} -> {fixed:.3f} so the test split "
                "is non-empty (documented deviation from the reference, which would "
                "produce an empty test set here)."
            )
            val_split = fixed
        train_size = int(train_split * total)
        val_size = int(val_split * total)
        if self.split == "train":
            data = data[:train_size]
        elif self.split == "val":
            data = data[train_size : train_size + val_size]
        else:
            data = data[train_size + val_size :]
        print(f"Loaded {len(data)} samples for {self.split} split")
        inv = {v: k for k, v in self.CLASS_MAP.items()}
        class_counts: dict[str, int] = {}
        for _, label in data:
            class_counts[inv[label]] = class_counts.get(inv[label], 0) + 1
        print(f"Class distribution for {self.split}:")
        for class_name, count in sorted(class_counts.items()):
            print(f"  {class_name}: {count} ({100 * count / max(len(data), 1):.1f}%)")
        return data
