"""Train with best-model selection on the ICBHI score, on the GPU.

    python -m audio_classification_icbhi_tpu_torch.train_icbhi --config config.yaml \
        --data-path data/ICBHI [--device cuda|cpu]

Port of the repository's `training_icbhi.py`: the flags and flow of
`train.py`, with `TrainerWithICBHI`. It trains on the whole-recording
dataset, the one this port carries; the segmented per-cycle dataset and its
default `config_segmented.yaml` wait for ROADMAP.md A5, the ICBHI history
plot for A7.
"""

from __future__ import annotations

from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.train import build_trainer, parse_args, report
from audio_classification_icbhi_tpu_torch.training.trainer_icbhi import TrainerWithICBHI


def main(argv=None):
    args = parse_args(argv)
    trainer = build_trainer(args, ICBHIDataset, TrainerWithICBHI, "config.yaml")
    history = trainer.train(resume_from=args.resume, profile_dir=args.profile)
    report(trainer)
    return history


if __name__ == "__main__":
    main()
