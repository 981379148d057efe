"""The sliding-window analyzers: one entry point for the five scripts.

    python -m audio_classification_icbhi_tpu_torch.analyze VARIANT --audio rec.wav --model m.ckpt
        [--segment-duration 1.0] [--overlap 0.5] [--crackle-threshold 0.3]
        [--wheeze-threshold 0.3] [--output-dir analysis_results] [--device cuda|cpu]
        [--no-plots]

Each variant keeps its script's flags, detection mode, sample rate (16 kHz),
CSV and picture (`analyzers/viz.py`):

- realtime (realtime_analyzer.py) and parallel_p
  (realtime_analyzer_parallel_p.py): legacy mode, `{stem}_results.csv`,
  the 3-panel view `{stem}_analysis.png`;
- parallel (realtime_analyzer_parallel.py): threshold mode,
  `{stem}_results_t{crackle threshold:.2f}.csv`, the 3-panel view with the
  thresholds `{stem}_analysis_t{crackle threshold:.2f}.png`;
- spec (realtime_analyzer_spec.py): threshold mode, the timeline CSV
  `{stem}_detections.csv`, the spectrogram view `{stem}_spectrogram.png`;
- timeline (realtime_analyzer_timeline.py): threshold mode,
  `{stem}_detections.csv`, the coloured timeline `{stem}_timeline.png`.

The picture needs matplotlib, which the machine with the card lacks:
--no-plots writes the CSV alone. The summary prints either way; the
interactive viewer is `interactive.py`. `--device` defaults to cuda.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import NamedTuple

from audio_classification_icbhi_tpu_torch.analyzers import AnalyzerEngine, SegmentResult, viz


class Variant(NamedTuple):
    script: str
    mode: str          # detection mode of AnalyzerEngine
    thresholds: bool   # takes --crackle-threshold / --wheeze-threshold
    timeline_csv: bool
    csv_name: str      # formatted with stem and thr
    panel: str         # the analyzers/viz function that draws the picture
    png_name: str      # formatted with stem and thr


VARIANTS = {
    "realtime": Variant("realtime_analyzer.py", "legacy", False, False, "{stem}_results.csv",
                        "three_panel", "{stem}_analysis.png"),
    "parallel": Variant("realtime_analyzer_parallel.py", "threshold", True, False,
                        "{stem}_results_t{thr:.2f}.csv", "three_panel",
                        "{stem}_analysis_t{thr:.2f}.png"),
    "parallel_p": Variant("realtime_analyzer_parallel_p.py", "legacy", False, False,
                          "{stem}_results.csv", "three_panel", "{stem}_analysis.png"),
    "spec": Variant("realtime_analyzer_spec.py", "threshold", True, True,
                    "{stem}_detections.csv", "spectrogram", "{stem}_spectrogram.png"),
    "timeline": Variant("realtime_analyzer_timeline.py", "threshold", True, True,
                        "{stem}_detections.csv", "timeline", "{stem}_timeline.png"),
}
SAMPLE_RATE = 16000  # the scripts' fixed rate (the reference's librosa.load(sr=16000))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Respiratory sound analyzers: sliding windows over a recording, "
                    "crackle/wheeze detections per window, written as CSV with the "
                    "variant's picture (--no-plots: the CSV alone).")
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
        p.add_argument("--no-plots", action="store_true",
                       help="Write the CSV without the " + v.png_name.replace("{thr:.2f}", "{thr}")
                            + " picture (no matplotlib needed)")
    return parser


def draw(v: Variant, analyzer: AnalyzerEngine, results: list[SegmentResult], audio,
         png_path: Path) -> None:
    """The variant's picture, as its script draws it."""
    kwargs = {}
    if v.panel == "spectrogram":
        kwargs["device"] = analyzer.device
    elif v.panel == "three_panel" and v.thresholds:  # parallel: the lines at its thresholds
        kwargs = dict(crackle_threshold=analyzer.crackle_threshold,
                      wheeze_threshold=analyzer.wheeze_threshold)
    getattr(viz, v.panel)(results, audio, analyzer.sample_rate, save_path=png_path, **kwargs)


def main(argv=None) -> tuple[AnalyzerEngine, list[SegmentResult], Path]:
    """Run one variant; returns (engine, per-window results, CSV path). The
    picture, unless --no-plots, is `VARIANTS[variant].png_name` beside the
    CSV."""
    args = build_parser().parse_args(argv)
    v = VARIANTS[args.variant]
    thresholds = (dict(crackle_threshold=args.crackle_threshold,
                       wheeze_threshold=args.wheeze_threshold) if v.thresholds else {})
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    analyzer = AnalyzerEngine(args.model, segment_duration=args.segment_duration,
                              overlap=args.overlap, sample_rate=SAMPLE_RATE, mode=v.mode,
                              device=args.device, **thresholds)
    results, audio = analyzer.analyze_audio(args.audio)
    analyzer.print_summary(results)

    names = dict(stem=Path(args.audio).stem, thr=thresholds.get("crackle_threshold", 0.0))
    csv_path = output_dir / v.csv_name.format(**names)
    if v.timeline_csv:
        analyzer.export_results_timeline(results, csv_path)
    else:
        analyzer.export_results(results, csv_path)
    if not args.no_plots:
        draw(v, analyzer, results, audio, output_dir / v.png_name.format(**names))
    print(f"\n✓ Results saved to: {output_dir}")
    return analyzer, results, csv_path


if __name__ == "__main__":
    main()
