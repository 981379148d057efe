"""The sliding-window analyzers: one entry point for the five scripts.

    python -m audio_classification_icbhi_tpu_torch.analyze VARIANT --audio rec.wav --model m.ckpt
        [--segment-duration 1.0] [--overlap 0.5] [--crackle-threshold 0.3]
        [--wheeze-threshold 0.3] [--output-dir analysis_results] [--device cuda|cpu]

Each variant keeps its script's flags, detection mode, sample rate (16 kHz)
and CSV name:

- realtime (realtime_analyzer.py) and parallel_p
  (realtime_analyzer_parallel_p.py): legacy mode, `{stem}_results.csv`;
- parallel (realtime_analyzer_parallel.py): threshold mode,
  `{stem}_results_t{crackle threshold:.2f}.csv`;
- spec (realtime_analyzer_spec.py) and timeline
  (realtime_analyzer_timeline.py): threshold mode, the timeline CSV
  `{stem}_detections.csv`.

The scripts' PNG panels (`analyzers/viz.py`, matplotlib) and the pygame
`interactive_analyzer.py` are not ported yet (ROADMAP.md A8): this entry
point writes the CSV and prints the summary. `--device` defaults to cuda.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import NamedTuple

from audio_classification_icbhi_tpu_torch.analyzers import AnalyzerEngine, SegmentResult


class Variant(NamedTuple):
    script: str
    mode: str          # detection mode of AnalyzerEngine
    thresholds: bool   # takes --crackle-threshold / --wheeze-threshold
    timeline_csv: bool
    csv_name: str      # formatted with stem and thr


VARIANTS = {
    "realtime": Variant("realtime_analyzer.py", "legacy", False, False, "{stem}_results.csv"),
    "parallel": Variant("realtime_analyzer_parallel.py", "threshold", True, False,
                        "{stem}_results_t{thr:.2f}.csv"),
    "parallel_p": Variant("realtime_analyzer_parallel_p.py", "legacy", False, False,
                          "{stem}_results.csv"),
    "spec": Variant("realtime_analyzer_spec.py", "threshold", True, True,
                    "{stem}_detections.csv"),
    "timeline": Variant("realtime_analyzer_timeline.py", "threshold", True, True,
                        "{stem}_detections.csv"),
}
SAMPLE_RATE = 16000  # the scripts' fixed rate (the reference's librosa.load(sr=16000))
NOT_PORTED = ("the PNG panels (analyzers/viz.py) and interactive_analyzer.py are not "
              "ported yet (ROADMAP.md A8); this writes the CSV and the summary")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Respiratory sound analyzers: sliding windows over a recording, "
                    "crackle/wheeze detections per window, written as CSV. " + NOT_PORTED)
    sub = parser.add_subparsers(dest="variant", required=True)
    for name, v in VARIANTS.items():
        p = sub.add_parser(name, help=f"{v.script}: {v.mode} mode, "
                                      + v.csv_name.replace("{thr:.2f}", "{thr}"))
        p.add_argument("--audio", type=str, required=True,
                       help="Path to audio file (the first 15 seconds are analyzed)")
        p.add_argument("--model", type=str, required=True, help="Path to model checkpoint")
        p.add_argument("--segment-duration", type=float, default=1.0)
        p.add_argument("--overlap", type=float, default=0.5)
        if v.thresholds:
            p.add_argument("--crackle-threshold", type=float, default=0.3,
                           help="Detection threshold for crackles (0-1, default: 0.3)")
            p.add_argument("--wheeze-threshold", type=float, default=0.3,
                           help="Detection threshold for wheezes (0-1, default: 0.3)")
        p.add_argument("--output-dir", type=str, default="analysis_results")
        p.add_argument("--device", type=str, choices=["cuda", "cpu"], default="cuda",
                       help="Device to run on (default: cuda)")
        p.add_argument("--no-display", action="store_true",
                       help="Accepted for the scripts' interface; nothing is displayed")
    return parser


def main(argv=None) -> tuple[AnalyzerEngine, list[SegmentResult], Path]:
    """Run one variant; returns (engine, per-window results, CSV path)."""
    args = build_parser().parse_args(argv)
    v = VARIANTS[args.variant]
    thresholds = (dict(crackle_threshold=args.crackle_threshold,
                       wheeze_threshold=args.wheeze_threshold) if v.thresholds else {})
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    analyzer = AnalyzerEngine(args.model, segment_duration=args.segment_duration,
                              overlap=args.overlap, sample_rate=SAMPLE_RATE, mode=v.mode,
                              device=args.device, **thresholds)
    results, _ = analyzer.analyze_audio(args.audio)
    analyzer.print_summary(results)

    csv_path = output_dir / v.csv_name.format(stem=Path(args.audio).stem,
                                              thr=thresholds.get("crackle_threshold", 0.0))
    if v.timeline_csv:
        analyzer.export_results_timeline(results, csv_path)
    else:
        analyzer.export_results(results, csv_path)
    print(f"\n✓ Results saved to: {output_dir}")
    return analyzer, results, csv_path


if __name__ == "__main__":
    main()
