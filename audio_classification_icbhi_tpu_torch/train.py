"""Train an ICBHI classifier on whole recordings, on the GPU.

    python -m audio_classification_icbhi_tpu_torch.train --config config.yaml \
        --data-path data/ICBHI [--epochs N] [--device cuda|cpu]

Port of the repository's `train.py:19-107`, with its flags --config --model
--epochs --batch-size --learning-rate --device --data-path --resume
--profile --num-devices --multihost --coordinator --num-processes
--process-id, and --no-plots. --device defaults to cuda and raises where
there is no GPU; the CPU runs only when asked. After training it prints
where the best checkpoint went and draws training_history.png in the
working directory (`utils/plotting`, which needs matplotlib) unless
--no-plots.

Data parallelism, one rank a device (`parallel/mesh.py`):
- by default the mesh spans every visible GPU, as the JAX entry's spans
  every local device: with two or more, the entry starts one rank a GPU
  (NCCL); with one, or `--device cpu`, it trains in this process with no
  process group;
- `--num-devices N` starts N ranks (`--device cpu`: N gloo processes);
- `--multihost` makes this process one rank of a group started
  elsewhere: at `--coordinator host:port` with `--num-processes` and
  `--process-id`, or from torchrun's variables (`torchrun --nproc-per-node
  N -m audio_classification_icbhi_tpu_torch.train --multihost ...`).
Only rank 0 writes checkpoints, TensorBoard events and the PNG.
`train_segmented` and `train_icbhi` take the same flags.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.models import build_model
from audio_classification_icbhi_tpu_torch.parallel.mesh import (
    close_distributed,
    free_port,
    get_mesh,
    init_distributed,
)
from audio_classification_icbhi_tpu_torch.training.trainer import Trainer
from audio_classification_icbhi_tpu_torch.utils import plotting
from audio_classification_icbhi_tpu_torch.utils.config import load_config, resolve_device, set_seed


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train audio classification model")
    parser.add_argument("--config", type=str, default=None, help="Path to configuration file")
    parser.add_argument("--model", type=str, choices=["cnn", "resnet"], help="Model architecture")
    parser.add_argument("--epochs", type=int, help="Number of epochs")
    parser.add_argument("--batch-size", type=int, help="Batch size")
    parser.add_argument("--learning-rate", type=float, help="Learning rate")
    parser.add_argument("--device", type=str, choices=["cuda", "cpu"], default="cuda",
                        help="Device to train on (default cuda; cpu only when asked)")
    parser.add_argument("--data-path", type=str, help="Override data.dataset_path")
    parser.add_argument("--resume", type=str, help="Checkpoint to resume from")
    parser.add_argument("--profile", type=str, metavar="DIR",
                        help="Write a torch.profiler trace of the first epoch to DIR")
    parser.add_argument("--no-plots", action="store_true",
                        help="Skip the training-history PNG (no matplotlib needed)")
    parser.add_argument("--num-devices", type=int,
                        help="Data-parallel ranks, one a device (default: every visible GPU; "
                        "1 with --device cpu)")
    parser.add_argument("--multihost", action="store_true",
                        help="Join a process group as one rank before building the mesh: run "
                        "this command once a rank, with --coordinator host:port, "
                        "--num-processes and --process-id, or under torchrun")
    parser.add_argument("--coordinator", type=str, help="host:port of rank 0")
    parser.add_argument("--num-processes", type=int, help="Total ranks")
    parser.add_argument("--process-id", type=int, help="This rank's index")
    return parser.parse_args(argv)


def ranks_to_start(args) -> int:
    """How many ranks the entry starts itself: none under --multihost
    (this process is a rank already); else --num-devices, by default every
    visible GPU, or 1 on the CPU."""
    if args.multihost:
        return 1
    if args.num_devices is not None:
        return args.num_devices
    return torch.cuda.device_count() if args.device == "cuda" else 1


def _rank_entry(rank: int, module: str, argv: list, n: int, port: int, results) -> None:
    import importlib

    if parse_args(argv).device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))  # the ranks share the cores
    out = importlib.import_module(module).main(
        argv + ["--multihost", "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", str(n), "--process-id", str(rank)])
    if rank == 0:
        results.put(out)


def spawn_ranks(module: str, argv: list, n: int):
    """Run `module.main(argv)` as n ranks on this machine, one process each
    (spawned, so each imports torch anew), joined in a process group at a
    free port of 127.0.0.1 (`--multihost --coordinator ... --process-id r`
    added to argv). Returns rank 0's result; a rank that fails raises."""
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").SimpleQueue()
    ranks = mp.start_processes(_rank_entry, args=(module, list(argv), n, free_port(), results),
                               nprocs=n, join=False, start_method="spawn")
    out = []
    # read rank 0's result while waiting, so that its write cannot block its exit
    while not ranks.join(timeout=1.0):
        if not out and not results.empty():
            out.append(results.get())
    return out[0] if out else results.get()


def run(module: str, argv, body):
    """`body(args)` in this process, or, when the flags ask for several
    ranks, in that many rank processes started here (`module.main` runs in
    each; rank 0's result is returned). A process that joined a group
    leaves it at the end."""
    args = parse_args(argv)
    n = ranks_to_start(args)
    if n > 1:
        return spawn_ranks(module, list(sys.argv[1:] if argv is None else argv), n)
    try:
        return body(args)
    finally:
        if args.multihost:
            close_distributed()


def build_trainer(args, dataset_cls, trainer_cls, default_config: str):
    """Shared setup of the train entry points."""
    device = resolve_device(args.device)  # no GPU and no --device cpu: raise first
    mesh = None
    if getattr(args, "multihost", False):
        idx = init_distributed(args.coordinator, args.num_processes, args.process_id,
                               auto=True, device=device)
        print(f"Distributed: process {idx}")
        mesh = get_mesh(num_devices=args.num_devices, device=device)
    config = load_config(args.config if args.config else default_config)
    # `is not None`: --epochs 0 / --learning-rate 0.0 are explicit values
    if args.model:
        config["model"]["architecture"] = args.model
    if args.epochs is not None:
        config["training"]["epochs"] = args.epochs
    if args.batch_size is not None:
        config["training"]["batch_size"] = args.batch_size
    if args.learning_rate is not None:
        config["training"]["learning_rate"] = args.learning_rate
    if args.data_path:
        config["data"]["dataset_path"] = args.data_path
    set_seed(config.get("seed", 42))

    print("\n" + "=" * 60)
    print("TRAINING CONFIGURATION")
    print("=" * 60)
    print(f"Model: {config['model']['architecture']}")
    print(f"Epochs: {config['training']['epochs']}")
    print(f"Batch size: {config['training']['batch_size']}")
    print(f"Learning rate: {config['training']['learning_rate']}")
    print(f"Device: {device}")
    print(f"Mesh: {mesh.world_size if mesh is not None else 1} device(s)")
    print("=" * 60)

    augment = bool(config["data"].get("augmentation", False))
    train_ds = dataset_cls(config["data"]["dataset_path"], "train", config, augment=augment)
    val_ds = dataset_cls(config["data"]["dataset_path"], "val", config, augment=False)
    # the group makes BatchNorm take the global batch's statistics
    model = build_model(config, axis_name=mesh.group if mesh is not None else None)
    return trainer_cls(model, train_ds, val_ds, config, device=device, mesh=mesh)


def report(trainer, history: dict, args, plot, png: str, what: str = "Training history") -> None:
    """Where the best checkpoint went, and the history drawn by `plot` (a
    `utils/plotting` function) to `png` unless --no-plots (rank 0 only)."""
    if not trainer.rank0:
        return
    print(f"Best checkpoint: {trainer.checkpoint_dir / 'best_model.ckpt'}")
    if not args.no_plots:
        plot(history, save_path=png)
        print(f"{what} saved to {png}")


def _main(args):
    trainer = build_trainer(args, ICBHIDataset, Trainer, "config.yaml")
    history = trainer.train(resume_from=args.resume, profile_dir=args.profile)
    report(trainer, history, args, plotting.plot_training_history, "training_history.png")
    return history


def main(argv=None):
    return run("audio_classification_icbhi_tpu_torch.train", argv, _main)


if __name__ == "__main__":
    main()
