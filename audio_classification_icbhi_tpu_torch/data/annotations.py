"""ICBHI annotation parsing and label mapping.

A copy of `audio_classification_icbhi_tpu/data/annotations.py`: annotation
files are tab-separated `start  end  crackles  wheezes` lines per breathing
cycle; the recording-level label is the OR over cycles; classes map to
normal=0, crackles=1, wheezes=2, both=3.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

CLASS_MAP = {"normal": 0, "crackles": 1, "wheezes": 2, "both": 3}
CLASS_NAMES = ["normal", "crackles", "wheezes", "both"]
# Directory names used by the segmented dataset layout differ from the
# config class names (reference quirk: config.yaml:41-42 says crackles/
# wheezes, dirs are crackle/wheeze — dataset_segmented.py:29-34).
SEGMENT_DIR_NAMES = ["normal", "crackle", "wheeze", "both"]


class Cycle(NamedTuple):
    start: float
    end: float
    crackles: int
    wheezes: int


def parse_annotation_file(txt_path: str | Path) -> list[Cycle]:
    """Parse per-cycle rows; rows with <4 tab-separated fields are skipped
    (reference dataset.py:111-113 behavior)."""
    cycles = []
    for line in Path(txt_path).read_text().splitlines():
        parts = line.strip().split("\t")
        if len(parts) >= 4:
            try:
                cycles.append(
                    Cycle(float(parts[0]), float(parts[1]), int(parts[2]), int(parts[3]))
                )
            except ValueError:
                continue
    return cycles


def label_from_flags(crackles: bool | int, wheezes: bool | int) -> int:
    """(crackles, wheezes) -> class index (reference preprocess_icbhi.py:93-111).

    Flags compare == 1 exactly (int(True) == 1 keeps bool callers working):
    the reference tests `crackle == 1` everywhere, and truthiness here made
    a corrupt flag value like 2 a crackle for the segmenter while
    recording_label's `c.crackles == 1` ignored it — two labeling contracts
    silently disagreeing on the same file."""
    c, w = int(crackles) == 1, int(wheezes) == 1
    if c and w:
        return CLASS_MAP["both"]
    if c:
        return CLASS_MAP["crackles"]
    if w:
        return CLASS_MAP["wheezes"]
    return CLASS_MAP["normal"]


def recording_label(txt_path: str | Path) -> int:
    """Recording-level label = OR over all cycles (reference dataset.py:95-130)."""
    cycles = parse_annotation_file(txt_path)
    has_crackles = any(c.crackles == 1 for c in cycles)
    has_wheezes = any(c.wheezes == 1 for c in cycles)
    return label_from_flags(has_crackles, has_wheezes)
