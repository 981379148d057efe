"""Offline ETL: cut ICBHI recordings into per-cycle labeled wav segments.

Port of `audio_classification_icbhi_tpu/data/segmenter.py:29-115` (host
numpy, as there): parse each recording's annotation rows (start, end,
crackle, wheeze), load the audio resampled to the target rate
(`wavio.resample_np`), slice it per cycle, skip segments shorter than
min_duration (default 0.5 s), write {output}/{label}/{stem}_seg{idx:03d}_
{label}.wav, and print a summary and write segmentation_stats.json.
"""

from __future__ import annotations

import json
from pathlib import Path

from audio_classification_icbhi_tpu_torch.data.annotations import (
    SEGMENT_DIR_NAMES,
    label_from_flags,
    parse_annotation_file,
)
from audio_classification_icbhi_tpu_torch.data.wavio import load_audio, write_wav

# output dirs and stats keys derive from the one flag -> dir mapping, so the
# segmenter's directory names are the ones the segmented dataset loads by
_LABELS = tuple(SEGMENT_DIR_NAMES)


class ICBHISegmenter:
    def __init__(self, input_dir: str | Path, output_dir: str | Path,
                 sample_rate: int = 16000, min_duration: float = 0.5):
        self.input_dir = Path(input_dir)
        self.output_dir = Path(output_dir)
        self.sample_rate = sample_rate
        self.min_duration = min_duration
        self.stats = {label: 0 for label in _LABELS}
        self.stats.update(total_segments=0, skipped_segments=0, processed_files=0)
        for label in _LABELS:
            (self.output_dir / label).mkdir(parents=True, exist_ok=True)

    @staticmethod
    def get_label(crackle: int, wheeze: int) -> str:
        """(crackle, wheeze) flags -> segment directory name."""
        return SEGMENT_DIR_NAMES[label_from_flags(crackle, wheeze)]

    def segment_audio(self, audio_path: str | Path, txt_path: str | Path) -> int:
        audio_path = Path(audio_path)
        try:
            audio, _ = load_audio(audio_path, target_sr=self.sample_rate)
        except Exception as e:  # one unreadable file must not stop the corpus
            print(f"  Error loading {audio_path.name}: {e}")
            return 0
        cycles = parse_annotation_file(txt_path)
        if not cycles:
            print(f"  Warning: No valid annotations for {audio_path.name}")
            return 0
        created = 0
        for idx, c in enumerate(cycles):
            # clamp corrupt times: a negative start would be a negative slice
            # index and cut the end of the file as a labeled segment
            start = max(int(c.start * self.sample_rate), 0)
            end = min(max(int(c.end * self.sample_rate), 0), len(audio))
            segment = audio[start:end]
            if len(segment) / self.sample_rate < self.min_duration:
                self.stats["skipped_segments"] += 1
                continue
            label = self.get_label(c.crackles, c.wheezes)
            name = f"{audio_path.stem}_seg{idx:03d}_{label}.wav"
            try:
                write_wav(self.output_dir / label / name, segment, self.sample_rate)
            except Exception as e:  # as above: report the segment, go on
                print(f"  Error saving segment {name}: {e}")
                continue
            created += 1
            self.stats[label] += 1
            self.stats["total_segments"] += 1
        return created

    def process_all(self) -> dict:
        wavs = sorted(self.input_dir.glob("*.wav"))
        print(f"Found {len(wavs)} audio files in {self.input_dir}")
        for wav in wavs:
            txt = wav.with_suffix(".txt")
            if not txt.exists():
                print(f"  Warning: no annotation for {wav.name}")
                continue
            n = self.segment_audio(wav, txt)
            self.stats["processed_files"] += 1
            print(f"  {wav.name}: {n} segments")
        self.print_summary()
        (self.output_dir / "segmentation_stats.json").write_text(json.dumps(self.stats, indent=2))
        return self.stats

    def print_summary(self) -> None:
        print("\nSegmentation summary")
        print("=" * 40)
        for label in _LABELS:
            print(f"  {label}: {self.stats[label]}")
        print(f"  total: {self.stats['total_segments']}")
        print(f"  skipped (< {self.min_duration}s): {self.stats['skipped_segments']}")
