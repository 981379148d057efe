"""Inference CLI: classify | classify-batch | info.

Port of the root `cli.py:85-124`: the same subcommands, flags, result
schema and JSON/CSV output. `--device` defaults to cuda.

    python -m audio_classification_icbhi_tpu_torch.cli classify --audio x.wav --model m.ckpt
    python -m audio_classification_icbhi_tpu_torch.cli classify-batch --input-dir wavs --model m.ckpt --output r.csv
    python -m audio_classification_icbhi_tpu_torch.cli info --model m.ckpt [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine


def classify_command(args):
    engine = ClassifierEngine(args.model, device=args.device)
    result = engine.classify_file(args.audio)
    print("\n" + "=" * 60)
    print("CLASSIFICATION RESULT")
    print("=" * 60)
    print(f"Audio: {result['audio_path']}")
    print(f"Predicted class: {result['predicted_class']}")
    print(f"Confidence: {result['confidence']:.4f}")
    print("\nClass probabilities:")
    for name, prob in result["probabilities"].items():
        bar = "#" * int(prob * 40)
        print(f"  {name:<10} {prob:.4f} {bar}")
    print("=" * 60)


def classify_batch_command(args):
    print(f"Loading model from {args.model}...")
    engine = ClassifierEngine(args.model, device=args.device)
    input_dir = Path(args.input_dir)
    audio_files = sorted(input_dir.glob("*.wav"))
    if not audio_files:
        print(f"No .wav files found in {input_dir}")
        return
    print(f"\nFound {len(audio_files)} audio files")
    results = engine.classify_files(audio_files)

    output_path = args.output
    if output_path.endswith(".json"):
        with open(output_path, "w") as f:
            json.dump(results, f, indent=2)
    else:  # CSV: path, class, confidence, then per-class probabilities
        fields = ["audio_path", "predicted_class", "confidence", *engine.class_names]
        with open(output_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fields)
            writer.writeheader()
            for r in results:
                writer.writerow({"audio_path": r["audio_path"],
                                 "predicted_class": r["predicted_class"],
                                 "confidence": r["confidence"], **r["probabilities"]})
    print(f"\n✓ Results saved to {output_path}")
    print(f"✓ Processed {len(results)}/{len(audio_files)} files successfully")


def info_command(args):
    engine = ClassifierEngine(args.model, device=args.device)
    info = engine.describe()
    print("\n" + "=" * 60)
    print("MODEL INFORMATION")
    print("=" * 60)
    print(f"Architecture: {info['architecture']}")
    print(f"Parameters: {info['parameters']:,}")
    print(f"Classes: {', '.join(info['classes'])}")
    print(f"Trained epochs: {info['epoch'] + 1}")
    print(f"Validation loss: {info['val_loss']:.4f}")
    if "icbhi_score" in info:
        print(f"ICBHI score: {info['icbhi_score']:.4f}")
    print("\nAudio configuration:")
    print(f"  Sample Rate: {info['sample_rate']} Hz")
    print(f"  Mel Bins: {info['n_mels']}")
    print(f"  Duration: {info['duration']} seconds")
    print("=" * 60)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Audio Classification CLI",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    subparsers = parser.add_subparsers(dest="command", help="Command to execute")

    def add_device(p):
        p.add_argument("--device", type=str, choices=["cuda", "cpu"], default="cuda",
                       help="Device to run on (default: cuda)")

    classify_parser = subparsers.add_parser("classify", help="Classify a single audio file")
    classify_parser.add_argument("--audio", type=str, required=True, help="Path to audio file")
    classify_parser.add_argument("--model", type=str, required=True, help="Path to model checkpoint")
    add_device(classify_parser)

    batch_parser = subparsers.add_parser("classify-batch", help="Classify multiple audio files")
    batch_parser.add_argument("--input-dir", type=str, required=True)
    batch_parser.add_argument("--model", type=str, required=True)
    batch_parser.add_argument("--output", type=str, default="results.csv")
    add_device(batch_parser)

    info_parser = subparsers.add_parser("info", help="Display model information")
    info_parser.add_argument("--model", type=str, required=True)
    add_device(info_parser)

    args = parser.parse_args(argv)
    if args.command == "classify":
        classify_command(args)
    elif args.command == "classify-batch":
        classify_batch_command(args)
    elif args.command == "info":
        info_command(args)
    else:
        parser.print_help()


if __name__ == "__main__":
    main()
