"""Train with best-model selection on the ICBHI score, on the GPU.

    python -m audio_classification_icbhi_tpu_torch.train_icbhi \
        --data-path data/ICBHI_segmented [--config config_segmented.yaml] \
        [--device cuda|cpu] [--no-plots]

Port of the repository's `training_icbhi.py`: the flags and flow of
`train.py`, with `TrainerWithICBHI` on the per-cycle
`ICBHISegmentedDataset` (made by `preprocess_icbhi`) at
config_segmented.yaml; it draws the 4-panel icbhi_training_history.png in
the working directory unless --no-plots.
"""

from __future__ import annotations

from audio_classification_icbhi_tpu_torch.data.dataset_segmented import ICBHISegmentedDataset
from audio_classification_icbhi_tpu_torch.train import build_trainer, report, run
from audio_classification_icbhi_tpu_torch.training.trainer_icbhi import TrainerWithICBHI
from audio_classification_icbhi_tpu_torch.utils import plotting


def _main(args):
    trainer = build_trainer(args, ICBHISegmentedDataset, TrainerWithICBHI,
                            "config_segmented.yaml")
    history = trainer.train(resume_from=args.resume, profile_dir=args.profile)
    report(trainer, history, args, plotting.plot_icbhi_history, "icbhi_training_history.png",
           "ICBHI training history")
    return history


def main(argv=None):
    return run("audio_classification_icbhi_tpu_torch.train_icbhi", argv, _main)


if __name__ == "__main__":
    main()
