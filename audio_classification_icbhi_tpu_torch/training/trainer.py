"""Trainer with class weighting, grad accumulation, clipping, schedules,
early stopping, TensorBoard logging and self-describing checkpoints.

Port of `audio_classification_icbhi_tpu/training/trainer.py:49-921` on the
per-step path: one train step per accumulation group of `BatchLoader`
batches (a shorter tail group steps too, its gradient still divided by
accum_steps), inverse-frequency class weights, the per-epoch scheduler
stepped on the selection metric, the JAX trainer's TensorBoard tags, the best
and periodic checkpoints in its payload, a msgpack file or, under
`training.checkpoint_format: orbax`, an orbax directory (either trainer
resumes from the other's, in either format), early stopping, and exact
resume.

Randomness: the model's initial weights come from a torch.Generator seeded
by config["seed"]; every train step draws its augmentation and dropout from
a generator on the device seeded by (seed, epoch, step), so a resumed run
repeats an uninterrupted one. Metrics stay on the device until the epoch
ends and cross to the host in one copy.

Data parallelism (`mesh`, one rank a device, `parallel/mesh.py`; the JAX
trainer's `:76-89`, `:290-333`): every rank reads the same seeded global
batches, decodes only its `local_batch_slice` of each and trains on it
through the sharded step (`parallel/data_parallel.py`), its draws from a
generator seeded by (seed, epoch, step, rank) as the JAX step folds in the
device index; the state is broadcast from rank 0 after init and after a
restore; only rank 0 writes checkpoints and TensorBoard events, and the
ranks meet at a barrier before reading a resume file. The model must carry the mesh's group
(`build_model(config, axis_name=mesh.group)`).

`training.precision: fp16` trains the fp16 model with the dynamic loss
scale (the JAX trainer's `:141-154`): the scale state (65,536, 0 clean
steps at the start) rides in the checkpoint as a float64 pair
(`scale_state`, `:832-838` there), so either trainer resumes the other's
fp16 run exactly.

`data.cache_on_device` (the JAX trainer's `:102-127`, `:365-580`) decodes
both splits once into device-resident caches (`data/device_cache.py`) and,
unless `training.steps_per_dispatch` is 1, trains and validates through the
fused multi-step epoch: one `train_many` call over the epoch's full
accumulation groups, the tail group (fewer than accum_steps batches)
through one `train_step` on gathered rows, then one `eval_many` call over
every val batch, the tail batch mask-padded; the metrics cross to the host
once an epoch. Any steps_per_dispatch other than 1 (absent, 0 or K) runs
the whole epoch a call: in the JAX package K sizes the scanned program,
here every step is a graph replay of its own whatever K is. On a
CUDA device each step and each eval group is a replayed CUDA graph, and
Adam is built `capturable`. The fp16 loss-scaled step has no fused form,
as in the JAX package: it runs per step on the cache.

Over the ranks of one machine (`train --num-devices N`, JAX's one process
over N devices) the cache stays on: every rank holds both splits whole,
and every read of it takes this rank's `local_batch_slice` columns of each
global batch (the fused epoch and its tail step, the per-step path and
the per-batch validation through the loader's `columns`), so the fused
epoch trains as the sharded per-step path does. The cache is turned off,
with the JAX trainer's message, only where the group spans several
machines (`mesh.hosts > 1`), as the JAX trainer turns it off over several
processes (`jax.process_count() > 1`).

Tracing (`tracing.py`): the set-up runs in the span `trainer.init`, with
children `trainer.frontend`, `trainer.cache` (the device caches, whose own
spans are `cache.decode`, `cache.pcm16` and `cache.upload`),
`trainer.model`, `trainer.optimizer`, `trainer.step_fns` and
`trainer.writer`. A fused epoch runs in the span `fused_epoch`, whose
children are `fused_epoch.prepare` (`set_epoch`, the rate, the epoch's
index batches and labels), the spans of `train_many` (`train_many.upload`,
`train_many.replays`), `fused_epoch.tail` and `fused_epoch.readback` (the
one read of the epoch's metrics from the device, where the host waits for
it), after which the recorder reads the train graph's device marks of the
epoch's last replay; so `fused_epoch`'s self time is the host time its
children leave out. Fused validation runs in `fused_val`, with children
`fused_val.prepare`, the spans of `eval_many` and `fused_val.readback`.
`train(profile_dir=)` writes the recorder's export, `spans.json`, beside
the profiler's `trace.json`.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch import tracing
from audio_classification_icbhi_tpu_torch.data.device_cache import DeviceCachedLoader
from audio_classification_icbhi_tpu_torch.data.loader import BatchLoader
from audio_classification_icbhi_tpu_torch.models.registry import compute_dtype
from audio_classification_icbhi_tpu_torch.models.weights import (
    flax_from_state_dict,
    opt_state_from_optax,
    optax_from_opt_state,
    state_dict_from_flax,
)
from audio_classification_icbhi_tpu_torch.ops.mel import MelFrontend
from audio_classification_icbhi_tpu_torch.parallel.data_parallel import (
    eval_batches,
    make_step_fns,
    step_seed,
    to_device,
)
from audio_classification_icbhi_tpu_torch.parallel.mesh import (
    Mesh,
    barrier,
    local_batch_slice,
    replicate,
    shard_batch,
)
from audio_classification_icbhi_tpu_torch.training.optimizers import build_optimizer
from audio_classification_icbhi_tpu_torch.training.schedules import (
    build_scheduler,
    restore_scheduler,
)
from audio_classification_icbhi_tpu_torch.utils.checkpoint import (
    AsyncCheckpointWriter,
    load_checkpoint,
    save_checkpoint,
)
from audio_classification_icbhi_tpu_torch.utils.config import resolve_device
from audio_classification_icbhi_tpu_torch.utils.tensorboard import SummaryWriter


class _NoWriter:
    """The TensorBoard writer of a rank other than 0: it writes nothing."""

    def add_scalar(self, *args, **kwargs) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    """Best-model selection on minimum validation loss."""

    plateau_mode = "min"
    # subclasses that score on predictions set this so validate() keeps the
    # per-batch predictions from its single pass
    collect_predictions = False

    def __init__(self, model: torch.nn.Module, train_dataset, val_dataset,
                 config: dict[str, Any], device: str | torch.device = "cuda",
                 mesh: Mesh | None = None):
        """`mesh`: this rank's data mesh (its device replaces `device`), or
        None for one device."""
        with tracing.span("trainer.init"):
            self._set_up(model, train_dataset, val_dataset, config, device, mesh)

    def _set_up(self, model, train_dataset, val_dataset, config, device, mesh) -> None:
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self.rank0 = mesh is None or mesh.rank == 0
        self.model = model
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.config = config

        tcfg = config["training"]
        self.epochs = tcfg["epochs"]
        self.batch_size = tcfg["batch_size"]
        self.learning_rate = tcfg["learning_rate"]
        self.accum_steps = max(1, tcfg.get("gradient_accumulation_steps", 1))
        self.early_stopping_patience = tcfg.get("early_stopping_patience", 15)
        self.save_every = tcfg.get("save_every", 5)
        self.seed = int(config.get("seed", 42))

        n_dev = mesh.world_size if mesh is not None else 1
        if n_dev > 1 and getattr(model, "axis_name", None) is not mesh.group:
            raise ValueError(
                "the model's axis_name is not the mesh's process group, but training is "
                f"data-parallel over a {n_dev}-rank mesh: BatchNorm statistics would silently "
                "diverge per rank. Build the model with build_model(config, axis_name=mesh.group).")
        if self.batch_size % n_dev:
            raise ValueError(
                f"batch_size {self.batch_size} must be divisible by the {n_dev}-rank data mesh")

        with tracing.span("trainer.frontend"):
            self.frontend = MelFrontend.from_config(config)
        self.class_weights = torch.as_tensor(self._calculate_class_weights(), device=self.device)
        dcfg = config["data"]
        self.cache_on_device = bool(dcfg.get("cache_on_device", False))
        # this rank's columns of a global batch (every column without a mesh)
        self.columns = local_batch_slice(self.batch_size, mesh)
        if self.cache_on_device and mesh is not None and mesh.hosts > 1:
            print("cache_on_device: disabled under multi-host training "
                  "(the fused dispatch paths are single-controller); "
                  "using the per-step host loader.")
            self.cache_on_device = False
        if self.cache_on_device:
            # decode once, keep the waveforms on the device, ship only indices
            cache_dtype = dcfg.get("cache_dtype", "auto")
            with tracing.span("trainer.cache"):
                self.train_loader = DeviceCachedLoader(
                    train_dataset, self.batch_size, device=self.device, shuffle=True,
                    drop_last=True, seed=self.seed, cache_dtype=cache_dtype,
                    columns=self.columns)
                self.val_loader = DeviceCachedLoader(
                    val_dataset, self.batch_size, device=self.device, shuffle=False,
                    cache_dtype=cache_dtype, columns=self.columns)
            mb = (self.train_loader.nbytes + self.val_loader.nbytes) / 1e6
            print(f"Device cache: {mb:.0f} MB of waveforms resident on {self.device}")
        else:
            # each rank decodes only its rows of the same seeded batches
            shard = (mesh.rank, mesh.world_size) if mesh is not None else (0, 1)
            self.train_loader = BatchLoader(train_dataset, self.batch_size, shuffle=True,
                                            drop_last=True, seed=self.seed, shard=shard)
            self.val_loader = BatchLoader(val_dataset, self.batch_size, shuffle=False,
                                          shard=shard)

        with tracing.span("trainer.model"):
            self.model.reset_parameters(torch.Generator().manual_seed(self.seed))
            if config["model"].get("pretrained", False):
                self._load_pretrained()
            self.model.to(self.device)
            if mesh is not None:
                replicate(mesh, self.model.state_dict().values())
        self.optimizer_name = tcfg.get("optimizer", "adam")
        with tracing.span("trainer.optimizer"):
            # the fused epoch captures the optimizer step in a CUDA graph
            self.optimizer = build_optimizer(
                self.optimizer_name, self.model.named_parameters(),
                tcfg.get("weight_decay", 0.0),
                capturable=self.cache_on_device and self.device.type == "cuda")
            self.scheduler = build_scheduler(
                tcfg.get("scheduler"), self.learning_rate, self.epochs,
                plateau_mode=self.plateau_mode,
                warmup_epochs=int(tcfg.get("warmup_epochs", 0)),
            )
        self.dynamic_loss_scale = compute_dtype(config) == torch.float16
        # torch GradScaler's defaults: init scale 65,536, growth interval 2,000
        self.scale_state = (np.float32(65536.0), np.int32(0))
        with tracing.span("trainer.step_fns"):
            self.steps = make_step_fns(
                self.model, self.frontend, self.optimizer,
                accum_steps=self.accum_steps,
                augment=bool(config["data"].get("augmentation", False))
                and getattr(train_dataset, "augment", True),
                max_grad_norm=self._max_grad_norm(),
                accum_mode=tcfg.get("accum_mode", "parallel"),
                mesh=mesh,
                dynamic_loss_scale=self.dynamic_loss_scale,
                seed=self.seed,
            )

        self.checkpoint_dir = Path(tcfg.get("checkpoint_dir", "checkpoints"))
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.async_checkpoint = bool(tcfg.get("async_checkpoint", True))
        self._ckpt_writer: AsyncCheckpointWriter | None = None
        with tracing.span("trainer.writer"):
            self.writer = SummaryWriter(log_dir=tcfg.get("log_dir", "runs")) if self.rank0 \
                else _NoWriter()

        self.history = {"train_loss": [], "val_loss": [], "train_acc": [], "val_acc": []}
        self.val_predictions = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        self.best_val_loss = float("inf")
        self.patience_counter = 0
        self.start_epoch = 0

    # ------------------------------------------------------------------ setup

    def _load_pretrained(self) -> None:
        """Initialize the model from a torch state_dict (model.pretrained +
        model.pretrained_path), as the JAX trainer does
        (`training/trainer.py:226-261` there): a reference checkpoint of
        either architecture, or a plain torchvision resnet18 (3-channel stem
        summed to 1, its 1000-class fc dropped). Keys the state_dict lacks
        (the head, for a plain resnet18) keep the seeded init; a key the
        model does not have raises."""
        from audio_classification_icbhi_tpu_torch.models import torch_import

        path = self.config["model"].get("pretrained_path")
        if not path:
            raise ValueError(
                "model.pretrained=true requires model.pretrained_path (a "
                "torch .pt/.pth state_dict; this environment has no network "
                "egress to download torchvision weights)")
        sd = torch_import.load_torch_checkpoint(path)
        if self.config["model"]["architecture"].lower() == "cnn":
            converted = torch_import.convert_lightweight_cnn(sd)
        else:
            converted = torch_import.convert_resnet18(sd, sum_rgb_stem=True)
        unexpected = sorted(set(converted) - set(self.model.state_dict()))
        if unexpected:
            raise ValueError(f"{path}: keys the model does not have: {unexpected}")
        self.model.load_state_dict(converted, strict=False)
        params = dict(self.model.named_parameters())
        n = sum(v.numel() for k, v in converted.items() if k in params)
        print(f"Loaded pretrained weights from {path} ({n:,} params)")

    def _max_grad_norm(self) -> float:
        """The gradient-clip threshold of the step (LegacyTrainer: none)."""
        return 1.0

    def _calculate_class_weights(self) -> np.ndarray:
        """Inverse-frequency weights; training.class_weighting=false gives
        uniform ones."""
        labels = self.train_dataset.labels
        num_classes = self.config["model"]["num_classes"]
        counts = np.bincount(labels, minlength=num_classes).astype(np.float64)
        if not self.config["training"].get("class_weighting", True):
            print("\nClass weighting disabled (uniform weights).")
            return np.ones(num_classes, np.float32)
        weights = len(labels) / (num_classes * np.maximum(counts, 1))
        print("\nClass distribution:")
        for i, (count, weight) in enumerate(zip(counts, weights)):
            name = self.config["classes"][i] if i < len(self.config["classes"]) else str(i)
            print(f"  {name}: {int(count)} samples (weight: {weight:.3f})")
        return weights.astype(np.float32)

    def _to_device(self, x) -> torch.Tensor:
        return to_device(self.device, x)

    # ------------------------------------------------------------------ epochs

    def _grouped_batches(self, loader):
        """Yield (wavs (A, B, L), labels (A, B)) accumulation groups; a
        partial tail group (fewer than accum_steps batches) is yielded too.
        The device cache's batches stack on the device."""
        buf_w, buf_l = [], []

        def stack(ws, ls):
            return (torch.stack(ws) if isinstance(ws[0], torch.Tensor) else np.stack(ws),
                    np.stack(ls))

        for wavs, labels in loader:
            buf_w.append(wavs)
            buf_l.append(labels)
            if len(buf_w) == self.accum_steps:
                yield stack(buf_w, buf_l)
                buf_w, buf_l = [], []
        if buf_w:
            yield stack(buf_w, buf_l)

    def step_generator(self, epoch: int, step: int) -> torch.Generator:
        rank = self.mesh.rank if self.mesh is not None and self.mesh.world_size > 1 else None
        return torch.Generator(device=self.device).manual_seed(
            step_seed(self.seed, epoch, step, rank))

    def _fused_dispatch(self) -> bool:
        """training.steps_per_dispatch is not 1: absent, 0 or any K runs the
        whole epoch in one call."""
        return int(self.config["training"].get("steps_per_dispatch", 0)) != 1

    def _use_multi_dispatch(self) -> bool:
        """The fused epoch: the cache is on the device, the step has a fused
        form (not the fp16 loss-scaled one) and `_fused_dispatch`."""
        return (self.steps.train_many is not None
                and isinstance(self.train_loader, DeviceCachedLoader)
                and self._fused_dispatch())

    def _use_fused_eval(self) -> bool:
        """Fused validation: the same rule, keyed on the val loader."""
        return (self.steps.eval_many is not None
                and isinstance(self.val_loader, DeviceCachedLoader)
                and self._fused_dispatch())

    @staticmethod
    def _epoch_summary(losses, corrects, counts) -> tuple[float, float]:
        """(mean step loss, accuracy %) of an epoch's per-step device
        metrics, read from the device in one copy."""
        packed = torch.stack([torch.cat(losses).mean(), torch.cat(corrects).sum(),
                              torch.cat(counts).sum()]).cpu().numpy()
        return float(packed[0]), 100.0 * float(packed[1]) / max(float(packed[2]), 1.0)

    def _train_epoch_fused(self, epoch: int) -> tuple[float, float]:
        """The epoch's full accumulation groups through one `train_many`
        call against the device cache (the global indices: each rank takes
        its columns); the tail group through one `train_step` on this
        rank's columns. Step g draws from the generator the per-step path
        gives group g, so both paths train alike."""
        loader = self.train_loader
        with tracing.span("fused_epoch.prepare"):
            loader.set_epoch(epoch)
            lr = float(self.scheduler.lr)
            idxs = loader.epoch_index_batches()  # (S, B)
            labels = loader.labels_all[idxs]
        s_total = idxs.shape[0]
        if s_total == 0:
            return 0.0, 0.0
        a, bsz = self.accum_steps, self.batch_size
        groups = s_total // a
        losses, corrects, counts = [], [], []
        if groups:
            sl = slice(0, groups * a)
            m = self.steps.train_many(loader.cache, idxs[sl].reshape(groups, a, bsz),
                                      labels[sl].reshape(groups, a, bsz), self.class_weights,
                                      lr, epoch, 0)
            losses.append(m["loss"])
            corrects.append(m["correct"])
            counts.append(m["count"])
        tail = s_total - groups * a
        if tail:
            with tracing.span("fused_epoch.tail"):
                sl, own = slice(groups * a, s_total), self.columns
                m = self.steps.train_step(
                    loader.gather(idxs[sl, own]),
                    self._to_device(labels[sl, own]).long(), self.class_weights, lr,
                    generator=self.step_generator(epoch, groups))
                losses.append(m["loss"][None])
                corrects.append(m["correct"][None])
                counts.append(m["count"][None])
        with tracing.span("fused_epoch.readback"):
            summary = self._epoch_summary(losses, corrects, counts)
        tracing.read_marks()  # the read-back has synchronised
        return summary

    def train_epoch(self, epoch: int) -> tuple[float, float]:
        if self._use_multi_dispatch():
            with tracing.span("fused_epoch"):
                return self._train_epoch_fused(epoch)
        self.train_loader.set_epoch(epoch)
        lr = float(self.scheduler.lr)
        step_metrics = []
        for step_idx, (wavs, labels) in enumerate(self._grouped_batches(self.train_loader)):
            # on a mesh the loader decoded (or gathered from the cache) this
            # rank's rows alone, and gave every row's label
            wavs = self._to_device(wavs)
            labels = shard_batch(self.mesh, labels, axis=1) if self.mesh is not None \
                else self._to_device(labels)
            args = (wavs, labels.long(), self.class_weights, lr)
            generator = self.step_generator(epoch, step_idx)
            if self.dynamic_loss_scale:
                metrics, self.scale_state = self.steps.train_step(
                    *args, generator=generator, scale_state=self.scale_state)
            else:
                metrics = self.steps.train_step(*args, generator=generator)
            step_metrics.append(metrics)
        if not step_metrics:
            return 0.0, 0.0
        return self._epoch_summary(*([m[k][None] for m in step_metrics]
                                     for k in ("loss", "correct", "count")))

    def _validate_fused(self) -> tuple[float, float]:
        """The whole val epoch through one `eval_many` call, the tail batch
        padded to batch_size with mask-0 rows (index 0) inside the same
        call; read from the device once (twice with collect_predictions).
        The loss is the mean of the per-batch criterion values, as on the
        per-batch path. Over ranks each runs its columns and every rank
        gets the global sums and predictions, in loader order."""
        loader = self.val_loader
        with tracing.span("fused_val.prepare"):
            batches = loader._batch_indices()  # loader order: full batches, then the tail
            if not batches:
                if self.collect_predictions:
                    self.val_predictions = (np.zeros(0, np.int64), np.zeros(0, np.int64))
                return 0.0, 0.0
            bsz = self.batch_size
            counts = np.asarray([len(b) for b in batches])
            idxs = np.zeros((len(batches), bsz), np.int64)
            mask = np.zeros((len(batches), bsz), np.float32)
            for i, bidx in enumerate(batches):
                idxs[i, :len(bidx)] = bidx
                mask[i, :len(bidx)] = 1.0
            labels = loader.labels_all[idxs]  # pad rows' labels are masked out
        num, den, corr, pred = self.steps.eval_many(loader.cache, idxs, labels, mask,
                                                    self.class_weights)
        with tracing.span("fused_val.readback"):
            packed = torch.stack([num, den, corr]).cpu().numpy()  # (3, S)
            if self.collect_predictions:
                real = mask.astype(bool)
                self.val_predictions = (labels[real].astype(np.int64),
                                        pred.cpu().numpy()[real].astype(np.int64))
        val_loss = float(np.mean(packed[0] / np.maximum(packed[1], 1e-12)))
        return val_loss, 100.0 * float(packed[2].sum()) / max(float(counts.sum()), 1.0)

    def validate(self, epoch: int) -> tuple[float, float]:
        """One pass over the val loader; with collect_predictions the same
        pass records (y_true, y_pred) in self.val_predictions."""
        if self._use_fused_eval():
            with tracing.span("fused_val"):
                return self._validate_fused()
        sums, total = [], 0.0
        kept_preds, kept_labels = [], []
        for logits, num, den, corr, labels in eval_batches(
                self.steps.eval_step, self.val_loader, self.batch_size, self.device,
                self.class_weights, self.mesh):
            sums.append(torch.stack([num, den, corr]))
            total += len(labels)
            if self.collect_predictions:
                kept_preds.append(logits.argmax(-1))
                kept_labels.append(labels)
        if self.collect_predictions:
            self.val_predictions = (
                np.concatenate(kept_labels).astype(np.int64) if kept_labels
                else np.zeros(0, np.int64),
                torch.cat(kept_preds).cpu().numpy().astype(np.int64) if kept_preds
                else np.zeros(0, np.int64),
            )
        if not sums:
            return 0.0, 0.0
        stacked = torch.stack(sums).cpu().numpy()  # (N, 3)
        # the mean of per-batch criterion values, as the JAX trainer reports
        val_loss = float(np.mean(stacked[:, 0] / np.maximum(stacked[:, 1], 1e-12)))
        return val_loss, 100.0 * float(stacked[:, 2].sum()) / max(total, 1.0)

    # ------------------------------------------------------------------ loop

    def _epoch_metrics(self, epoch: int) -> dict[str, float]:
        """Hook: extra per-epoch validation metrics (the ICBHI trainer's)."""
        return {}

    def _selection_metric(self, val_loss: float, extra: dict) -> float:
        return val_loss

    def _is_improvement(self, metric: float) -> bool:
        return metric < self.best_val_loss

    def train(self, resume_from: str | None = None, profile_dir: str | None = None) -> dict:
        """profile_dir writes a torch.profiler trace of the first trained
        epoch there (`trace.json`, Chrome trace format), and beside it the
        recorder's spans and counters so far (`spans.json`)."""
        if resume_from:
            self.restore(resume_from)
        print(f"\nStarting training for {self.epochs} epochs...")
        print(f"Training samples: {len(self.train_dataset)}")
        print(f"Validation samples: {len(self.val_dataset)}")
        print(f"Device: {self.device}"
              + (f" ({torch.cuda.get_device_name(self.device)})" if self.device.type == "cuda"
                 else ""))
        print(f"Batch size: {self.batch_size} (grad accum {self.accum_steps})")
        print(f"Learning rate: {self.learning_rate}")
        try:
            self._train_loop(profile_dir)
        except BaseException:
            # drain queued writes, but never let a drain failure mask the
            # primary error
            try:
                self.wait_for_checkpoints(close=True)
            except Exception:
                pass
            raise
        self.wait_for_checkpoints(close=True)
        print("\n✓ Training completed!")
        self.writer.close()
        return self.history

    def _train_epoch_profiled(self, epoch: int, profile_dir: str) -> tuple[float, float]:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            out = self.train_epoch(epoch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
        spans = tracing.write(Path(profile_dir) / "spans.json")
        print(f"✓ Profiler trace written to {Path(profile_dir) / 'trace.json'}, spans to {spans}")
        return out

    def _train_loop(self, profile_dir: str | None) -> None:
        for epoch in range(self.start_epoch, self.epochs):
            t0 = time.time()
            if profile_dir is not None and epoch == self.start_epoch:
                train_loss, train_acc = self._train_epoch_profiled(epoch, profile_dir)
            else:
                train_loss, train_acc = self.train_epoch(epoch)
            val_loss, val_acc = self.validate(epoch)
            extra = self._epoch_metrics(epoch)

            metric = self._selection_metric(val_loss, extra)
            self.scheduler.step(metric)

            self.writer.add_scalar("Loss/train", train_loss, epoch)
            self.writer.add_scalar("Loss/val", val_loss, epoch)
            self.writer.add_scalar("Accuracy/train", train_acc, epoch)
            self.writer.add_scalar("Accuracy/val", val_acc, epoch)
            self.writer.add_scalar("Learning_Rate", self.scheduler.lr, epoch)
            for tag, value in extra.items():
                self.writer.add_scalar(tag, value, epoch)
            self.writer.flush()

            self.history["train_loss"].append(train_loss)
            self.history["val_loss"].append(val_loss)
            self.history["train_acc"].append(train_acc)
            self.history["val_acc"].append(val_acc)
            self._extend_history(extra)

            print(
                f"\nEpoch {epoch + 1}/{self.epochs} - "
                f"Train Loss: {train_loss:.4f}, Train Acc: {train_acc:.2f}% - "
                f"Val Loss: {val_loss:.4f}, Val Acc: {val_acc:.2f}% - "
                f"LR: {self.scheduler.lr:.6f} ({time.time() - t0:.1f}s)"
            )

            if self._is_improvement(metric):
                self._record_best(metric)
                self.patience_counter = 0
                self.save_checkpoint(self.checkpoint_dir / "best_model.ckpt", epoch, val_loss, extra)
                print(f"✓ Best model saved ({self._best_description()})")
            else:
                self.patience_counter += 1
                print(f"  No improvement ({self.patience_counter}/{self.early_stopping_patience})")

            if (epoch + 1) % self.save_every == 0:
                self.save_checkpoint(self.checkpoint_dir / f"checkpoint_epoch_{epoch + 1}.ckpt",
                                     epoch, val_loss, extra)

            if self.patience_counter >= self.early_stopping_patience:
                print(f"\nEarly stopping triggered after {epoch + 1} epochs")
                break

    def _extend_history(self, extra: dict) -> None:
        pass

    def _record_best(self, metric: float) -> None:
        self.best_val_loss = metric

    def _best_description(self) -> str:
        return f"validation loss: {self.best_val_loss:.4f}"

    # ------------------------------------------------------------------ ckpt

    def _checkpoint_payload(self, epoch: int, val_loss: float, extra: dict) -> dict:
        """The JAX trainer's payload (`trainer.py:816-839`), with flax-form
        params, batch_stats and optax-form opt_state."""
        arch = self.config["model"]["architecture"]
        variables = flax_from_state_dict(self.model.state_dict(), arch)
        return {
            "epoch": epoch,
            "params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt_state": optax_from_opt_state(self.optimizer, self.optimizer_name, arch),
            "val_loss": float(val_loss),
            "config": self.config,
            "class_weights": self.class_weights.cpu().numpy(),
            "scheduler": self.scheduler.state_dict(),
            "best_metric": float(self._best_metric()),
            "patience_counter": int(self.patience_counter),
        } | (
            # the fp16 scale must resume exactly, or the first steps after a
            # resume overflow at 65,536 and are skipped while it halves down
            {"scale_state": np.asarray([float(self.scale_state[0]), float(self.scale_state[1])],
                                       np.float64)}
            if self.dynamic_loss_scale else {}
        )

    def _best_metric(self) -> float:
        return self.best_val_loss

    def _restore_best_metric(self, value: float, ckpt: dict) -> None:
        self.best_val_loss = value

    def save_checkpoint(self, path, epoch: int, val_loss: float, extra: dict | None = None):
        """training.checkpoint_format: "msgpack" (one file, the default) or
        "orbax" (a directory), as the JAX trainer writes them."""
        if not self.rank0:  # every rank holds the same state; one writes it
            return
        fmt = self.config["training"].get("checkpoint_format", "msgpack")
        payload = self._checkpoint_payload(epoch, val_loss, extra or {})
        if self.async_checkpoint:
            if self._ckpt_writer is None:
                self._ckpt_writer = AsyncCheckpointWriter()
            self._ckpt_writer.save(path, payload, format=fmt)
        else:
            save_checkpoint(path, payload, format=fmt)

    def wait_for_checkpoints(self, close: bool = False) -> None:
        """Block until every queued checkpoint write is on disk; close=True
        also retires the worker (a later save starts a new one)."""
        if self._ckpt_writer is not None:
            if close:
                writer, self._ckpt_writer = self._ckpt_writer, None
                writer.close()
            else:
                self._ckpt_writer.wait()

    def restore(self, path) -> None:
        """Resume from a checkpoint written by either package. Scheduler
        state, the best-metric bar and the patience counter come back
        verbatim, so a resumed run matches an uninterrupted one."""
        self.wait_for_checkpoints()  # a queued write may be the file we read
        barrier(self.mesh)  # ... and rank 0's, for every rank
        ckpt = load_checkpoint(path)
        arch = self.config["model"]["architecture"]
        sd = state_dict_from_flax({"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]},
                                  arch)
        self.model.load_state_dict(sd)
        state = opt_state_from_optax(ckpt["opt_state"], list(self.model.named_parameters()),
                                     self.optimizer_name, arch)
        self.optimizer.load_state_dict({"state": state,
                                        "param_groups": self.optimizer.state_dict()["param_groups"]})
        if self.mesh is not None:
            replicate(self.mesh, list(self.model.state_dict().values()) + [
                t for st in self.optimizer.state.values() for t in st.values()
                if torch.is_tensor(t) and t.device == self.device])
        if self.dynamic_loss_scale and "scale_state" in ckpt:
            s = np.asarray(ckpt["scale_state"])
            self.scale_state = (np.float32(s[0]), np.int32(s[1]))
        self.start_epoch = int(ckpt["epoch"]) + 1
        if "best_metric" in ckpt:
            self._restore_best_metric(float(ckpt["best_metric"]), ckpt)
        else:  # a checkpoint without trainer state: the val_loss bar
            self._restore_best_metric(self._legacy_best_metric(ckpt), ckpt)
        self.patience_counter = int(ckpt.get("patience_counter", 0))
        if "scheduler" in ckpt:
            restore_scheduler(self.scheduler, ckpt["scheduler"])
        else:  # replay with the selection metric
            for _ in range(self.start_epoch):
                self.scheduler.step(self._best_metric())
        scale = (f" (loss scale {float(self.scale_state[0]):g}, {int(self.scale_state[1])} clean "
                 "steps)") if self.dynamic_loss_scale else ""
        print(f"Resumed from {path} at epoch {self.start_epoch}{scale}")

    def _legacy_best_metric(self, ckpt: dict) -> float:
        return float(ckpt.get("val_loss", float("inf")))
