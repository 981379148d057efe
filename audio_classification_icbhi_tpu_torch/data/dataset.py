"""Whole-recording ICBHI dataset index.

Port of `audio_classification_icbhi_tpu/data/dataset.py:147-213`: glob
`audio_and_txt_files/*.wav` sorted, pair each with its annotation txt,
label at recording level, positional 70/15/15 split over the sorted list.
Items are fixed-length waveforms decoded on the host; the mel transform
and augmentation run on the device inside the train step. `load_batch`
(the loader's and the device cache's path) decodes a batch in one threaded
call of the native decoder (`native.decode_batch`, 4 threads), with the
JAX loader's per-row fallback (`dataset.py:27-46` there): a row at another
sample rate, or one the library refused, is decoded and resampled alone.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np

from audio_classification_icbhi_tpu_torch import native
from audio_classification_icbhi_tpu_torch.data import wavio
from audio_classification_icbhi_tpu_torch.data.annotations import recording_label


def _native_load_batch(dataset, idxs) -> tuple[np.ndarray, np.ndarray]:
    """The fixed-shape datasets' batch load: one `native.decode_batch` call,
    then the per-row path (`dataset[i]`) for each row whose file is at
    another rate than the dataset's or failed to decode. Without the
    library, every row takes the per-row path."""
    idxs = [int(i) for i in idxs]
    labels = np.asarray([dataset.data[i][1] for i in idxs], dtype=np.int32)
    decoded = native.decode_batch([dataset.data[i][0] for i in idxs],
                                  dataset.target_length, n_threads=4)
    if decoded is None:
        return np.stack([dataset[i][0] for i in idxs]).astype(np.float32), labels
    batch, srs, _ = decoded
    per_row = [row for row in range(len(idxs)) if srs[row] != dataset.sample_rate]
    for row in per_row:
        batch[row] = dataset[idxs[row]][0]
    native.ROWS.add(native=len(idxs) - len(per_row), per_row=len(per_row))
    return batch, labels


class ICBHIDataset:
    """Index of (wav_path, label) with host-side fixed-shape waveform loading."""

    DEFAULT_DURATION = 5.0  # seconds, where the config's data section names none

    def __init__(self, root_dir: str | Path, split: str = "train",
                 config: dict[str, Any] | None = None, augment: bool = False):
        self.root_dir = Path(root_dir)
        self.split = split
        # recorded for the trainer (augmentation runs on the device), and
        # only for the train split
        self.augment = augment and split == "train"
        data_cfg = (config or {}).get("data", {})
        self.sample_rate = int(data_cfg.get("sample_rate", 16000))
        self.duration = float(data_cfg.get("duration", self.DEFAULT_DURATION))
        self.target_length = int(self.sample_rate * self.duration)
        self.data = self._load_index(data_cfg)

    def _load_index(self, data_cfg: dict[str, Any]) -> list[tuple[str, int]]:
        """This split's (wav_path, label) list; the whole-recording split is
        fixed at 70/15/15, whatever `data_cfg` says."""
        audio_dir = self.root_dir / "audio_and_txt_files"
        if not audio_dir.exists():
            raise ValueError(f"Audio directory not found: {audio_dir}")
        data = []
        for wav_file in sorted(audio_dir.glob("*.wav")):
            txt_file = wav_file.with_suffix(".txt")
            if txt_file.exists():
                data.append((str(wav_file), recording_label(txt_file)))
        total = len(data)
        train_size = int(0.7 * total)
        val_size = int(0.15 * total)
        if self.split == "train":
            data = data[:train_size]
        elif self.split == "val":
            data = data[train_size : train_size + val_size]
        else:  # test
            data = data[train_size + val_size :]
        print(f"Loaded {len(data)} samples for {self.split} split")
        return data

    def __len__(self) -> int:
        return len(self.data)

    @property
    def labels(self) -> np.ndarray:
        return np.array([lbl for _, lbl in self.data], dtype=np.int32)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, int]:
        """-> ((target_length,) float32 waveform, label)."""
        path, label = self.data[idx]
        wav, _ = wavio.load_audio(path, target_sr=self.sample_rate)
        return wavio.pad_or_crop(wav, self.target_length).astype(np.float32), label

    def load_batch(self, idxs) -> tuple[np.ndarray, np.ndarray]:
        """(B, target_length) float32 waveforms and (B,) int32 labels,
        through the native batch decoder (`_native_load_batch`)."""
        return _native_load_batch(self, idxs)
