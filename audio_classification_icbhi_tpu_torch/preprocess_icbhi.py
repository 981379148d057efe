"""Segment ICBHI recordings into per-cycle labeled wavs (host only).

    python -m audio_classification_icbhi_tpu_torch.preprocess_icbhi \
        --input-dir data/ICBHI/audio_and_txt_files --output-dir data/ICBHI_segmented

Port of the repository's `preprocess_icbhi.py`, with its flags --input-dir
--output-dir --sample-rate --min-duration (`data/segmenter.py`).
"""

from __future__ import annotations

import argparse

from audio_classification_icbhi_tpu_torch.data.segmenter import ICBHISegmenter


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Segment ICBHI recordings by breathing cycle")
    parser.add_argument("--input-dir", type=str, default="data/ICBHI/audio_and_txt_files",
                        help="Directory with paired .wav/.txt recordings")
    parser.add_argument("--output-dir", type=str, default="data/ICBHI_segmented",
                        help="Output root (per-class subdirectories)")
    parser.add_argument("--sample-rate", type=int, default=16000)
    parser.add_argument("--min-duration", type=float, default=0.5)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    segmenter = ICBHISegmenter(args.input_dir, args.output_dir, sample_rate=args.sample_rate,
                               min_duration=args.min_duration)
    return segmenter.process_all()


if __name__ == "__main__":
    main()
