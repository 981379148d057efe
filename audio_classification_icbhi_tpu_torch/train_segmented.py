"""Train on pre-segmented respiratory cycles, on the GPU.

    python -m audio_classification_icbhi_tpu_torch.train_segmented \
        --data-path data/ICBHI_segmented [--config config_segmented.yaml] \
        [--device cuda|cpu] [--no-plots]

Port of the repository's `train_segmented.py`: the flags and flow of
`train.py` (selection on validation loss) on the per-cycle
`ICBHISegmentedDataset` at config_segmented.yaml; it draws
training_history_segmented.png in the working directory unless --no-plots.
"""

from __future__ import annotations

from audio_classification_icbhi_tpu_torch.data.dataset_segmented import ICBHISegmentedDataset
from audio_classification_icbhi_tpu_torch.train import build_trainer, report, run
from audio_classification_icbhi_tpu_torch.training.trainer import Trainer
from audio_classification_icbhi_tpu_torch.utils import plotting


def _main(args):
    trainer = build_trainer(args, ICBHISegmentedDataset, Trainer, "config_segmented.yaml")
    history = trainer.train(resume_from=args.resume, profile_dir=args.profile)
    report(trainer, history, args, plotting.plot_training_history,
           "training_history_segmented.png")
    return history


def main(argv=None):
    return run("audio_classification_icbhi_tpu_torch.train_segmented", argv, _main)


if __name__ == "__main__":
    main()
