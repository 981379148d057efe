"""The loop of the `train_epochs` traffic kind: whole training epochs of the
port's `Trainer` on its device cache, as `Trainer._train_loop` runs them
(`train_epoch`, `validate`, the scheduler's step), with no checkpoint and
no TensorBoard.

Set-up writes the mix's corpus in ICBHI's layout under TMPDIR, makes the
initial weights from the seed (`reference/step.seeded_state`), builds the
Trainer (which decodes the corpus into its device cache) and loads those
weights into it. Epoch 0 is the warm-up: validation at the initial
weights (each val batch's loss kept from its `eval_many` call), then the
epoch's optimizer steps through `train_many` in three calls (one step,
two, the rest), reading the first gradient from Adam's state after step 1
and, after step 3, the change of every leaf and of every BatchNorm's
running statistics; then validation and the scheduler's step. The graphs
are captured there. `setup_s` leaves out the writing of the corpus and the
making of the weights (whose BatchNorm calibration is the reference's
forward): a user has the recordings and the weights already.

The window runs epochs 1, 2, ... until --seconds have passed at the end of
one; `train_clips_per_s` is the train clips of those epochs over the time
from the window's start to the end of the last. With --trace, the window
also times each `train_epoch` by CUDA events; after it three more epochs
run under the profiler, the profiler's records of raw replays of the
captured graphs are counted against the graphs' nodes (where one is
missing, the idle share and the breakdown are left out), and the front
end's masked call at the step's rows is timed alone.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from port_bench import compare, corpus, timing, trace
from port_bench.reference import readings, step

TRACED_EPOCHS = 3


def _norms(tensors: list[torch.Tensor]) -> list[float]:
    if not tensors:  # a model with no BatchNorm has no running statistics
        return []
    return torch.stack([t.float().norm() for t in tensors]).cpu().tolist()


def running_stats(model) -> list[tuple[str, torch.Tensor]]:
    """The BatchNorms' running means and variances, by state_dict name."""
    return [(n, b) for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))]


def first_epoch(trainer, state0: dict) -> dict:
    """Epoch 0 with the program's readings of the checks (module doc)."""
    steps, seen = trainer.steps, []

    def eval_many(*args):  # the validation's own call, its per-batch sums kept
        out = steps.eval_many(*args)
        seen.append((out[0] / out[1].clamp_min(1e-12)).tolist())
        return out

    trainer.steps = steps._replace(eval_many=eval_many)
    trainer.validate(0)
    trainer.steps = steps
    loader = trainer.train_loader
    loader.set_epoch(0)
    idxs = loader.epoch_index_batches()
    a, b = trainer.accum_steps, trainer.batch_size
    k = len(idxs) // a
    labels = loader.labels_all[idxs][: k * a].reshape(k, a, b)
    idxs = idxs[: k * a].reshape(k, a, b)
    lr = float(trainer.scheduler.lr)
    cw, cache, many = trainer.class_weights, loader.cache, trainer.steps.train_many
    named = list(trainer.model.named_parameters())
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    losses = many(cache, idxs[:1], labels[:1], cw, lr, 0, 0)["loss"].tolist()
    states = [trainer.optimizer.state.get(p, {}).get("exp_avg") for _, p in named]
    first = [torch.zeros_like(p) if s is None else s / (1 - beta1) for s, (_, p) in
             zip(states, named)]
    grad1 = _norms(first)
    losses += many(cache, idxs[1:3], labels[1:3], cw, lr, 0, 1)["loss"].tolist()
    change = _norms([p.detach() - state0[n].to(p.device) for n, p in named])
    stats = running_stats(trainer.model)
    stats3 = _norms([b - state0[n].to(b.device) for n, b in stats])
    if k > 3:
        many(cache, idxs[3:], labels[3:], cw, lr, 0, 3)
    trainer.scheduler.step(trainer.validate(0)[0])
    names = [n for n, _ in named]
    return {"losses": losses[:3], "grad1": dict(zip(names, grad1)),
            "grad1_tensors": {n: t.float().cpu() for n, t in zip(names, first)},
            "change": dict(zip(names, change)),
            "stats": dict(zip([n for n, _ in stats], stats3)), "val_losses": seen[0],
            "steps": k, "train_clips": k * a * b, "val_clips": len(trainer.val_dataset)}


def front_end_ms(trainer, pcm: np.ndarray, device, rows: int) -> float:
    """Device ms of the masked front-end call the train step makes, at its
    rows (A · B flattened), with draws from a seeded generator: calls
    captured in a CUDA graph and replayed, as the fused step runs it."""
    from audio_classification_icbhi_tpu_torch.ops import augment
    from audio_classification_icbhi_tpu_torch.parallel.data_parallel import features_from_wavs

    fe = trainer.frontend
    wavs = torch.as_tensor(readings.pcm_to_float(pcm[:rows]), device=device)
    g = torch.Generator(device=device).manual_seed(0)
    draws = augment.draw_augment(g, rows, wavs.shape[1], fe.n_mels, fe.num_frames, device)
    with torch.no_grad():
        return timing.graph_ms(lambda: features_from_wavs(fe, wavs, augment=True, draws=draws))


def run(r):
    from port_bench.run import Outcome

    t_loop = time.perf_counter()
    dev = r.device
    cfg = copy.deepcopy(r.config)
    cfg["seed"] = r.seed
    data, tcfg = cfg["data"], cfg["training"]
    spans = timing.Spans(dev)
    tmp = Path(tempfile.mkdtemp(prefix="port_bench_"))
    try:
        n = int(r.traffic["recordings"])
        corp = spans.timed("corpus", corpus.write_icbhi, tmp / "icbhi", n, data["sample_rate"],
                           data["duration"], r.seed, dev)
        data["dataset_path"] = str(tmp / "icbhi")
        tcfg["checkpoint_dir"] = str(tmp / "checkpoints")
        tcfg["log_dir"] = str(tmp / "runs")
        calib = torch.as_tensor(readings.pcm_to_float(corp.pcm[: r.traffic["calibration_clips"]]),
                                device=dev)
        state0 = spans.timed("weights", lambda: {
            k: v.cpu() for k, v in step.seeded_state(cfg, r.seed, calib).items()})
        del calib
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

        from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
        from audio_classification_icbhi_tpu_torch.models import build_model
        from audio_classification_icbhi_tpu_torch.training.trainer import Trainer

        def make():
            augment = bool(data.get("augmentation", False))
            train_ds = ICBHIDataset(data["dataset_path"], "train", cfg, augment=augment)
            val_ds = ICBHIDataset(data["dataset_path"], "val", cfg, augment=False)
            return Trainer(build_model(cfg), train_ds, val_ds, cfg, device=dev)

        trainer = spans.timed("trainer_init", make, sync=True)
        trainer.model.load_state_dict(state0)
        prog = spans.timed("warm_epoch", first_epoch, trainer, state0, sync=True)

        t_win = time.perf_counter()
        setup_s = t_win - r.started - spans.host["corpus"][0] - spans.host["weights"][0]
        epoch, failed = 1, 0
        while True:
            tl, _ = spans.timed("train_epoch", trainer.train_epoch, epoch, device_time=r.trace)
            vl, _ = spans.timed("validate", trainer.validate, epoch)
            trainer.scheduler.step(vl)
            failed += 0 if math.isfinite(tl) and math.isfinite(vl) else prog["steps"]
            epoch += 1
            t_end = time.perf_counter()
            if t_end - t_win >= r.seconds:
                break
        epochs = epoch - 1
        window_s = t_end - t_win
        info = {"window_s": window_s, "epochs": epochs, "steps": epochs * prog["steps"],
                "train_clips": epochs * prog["train_clips"],
                "val_clips": epochs * prog["val_clips"]}

        red, probes = {}, {}
        if r.trace and dev.type == "cuda":  # the profiler and the events time the card
            def segment():
                from torch.profiler import record_function

                for e in range(epoch, epoch + TRACED_EPOCHS):
                    with record_function("train_epoch"):
                        trainer.train_epoch(e)
                    with record_function("validate"):
                        trainer.scheduler.step(trainer.validate(e)[0])

            _, red = trace.profiled(segment, spans=("train_epoch", "validate"))
            records, nodes, types = trace.replay_records(
                trainer.steps.train_many.graphs.values())
            probes["profiler_complete"] = records >= nodes
            if not probes["profiler_complete"]:
                red.pop("device_ops", None)
                red.pop("idle_gaps", None)
            probes["front_end_ms"] = front_end_ms(
                trainer, corp.pcm, dev, trainer.accum_steps * trainer.batch_size)
            probes["front_end_rows"] = trainer.accum_steps * trainer.batch_size
            print(f"port_bench: the profiler's device records of {trace.REPLAYS} raw replays "
                  f"of each captured graph: {records} for {nodes} kernel, copy and fill "
                  f"nodes (node types per graph: {types})", file=sys.stderr)
        print("port_bench: set-up seconds " + json.dumps(
            {"to_loop": t_loop - r.started, "setup": setup_s}
            | {k: v[0] for k, v in spans.host.items() if len(v) == 1}), file=sys.stderr)
        memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        del trainer
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        ref = readings.train(cfg, state0, corp.pcm, corp.labels, r.seed, dev)
        numbers = compare.train_numbers(prog, ref)
        print("port_bench: " + json.dumps(compare.train_detail(prog, ref)), file=sys.stderr)
        print("port_bench: numbers " + json.dumps(numbers), file=sys.stderr)
        return Outcome(
            e2e={"setup_s": setup_s, "train_clips_per_s": info["train_clips"] / window_s},
            attempted=info["steps"], failed=failed, memory_peak=memory_peak, numbers=numbers,
            spans=spans, trace=red, probes=probes, info=info | {"config": cfg})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
