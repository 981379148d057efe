"""Train and eval steps: wav -> features -> loss -> update, on one device or
one rank of a data-parallel mesh.

Port of `audio_classification_icbhi_tpu/parallel/data_parallel.py:37-644`:

- the front end with the reference's augmentation order: wave-aug ->
  mel + dB -> SpecAugment mask -> normalize. On a CUDA tensor the mask and
  normalize run in the log-mel kernel's epilogue (its training form); on a
  CPU tensor the plain chain runs;
- class-weighted cross entropy as torch.nn.CrossEntropyLoss(weight=w):
  Σ w[y]·ce / Σ w[y];
- gradient accumulation over A microbatches, each gradient divided by
  accum_steps (also in a shorter tail group), then global-norm clipping at
  1.0 with torch semantics and one optimizer step at the given lr.

With a `mesh` that has a process group (`parallel/mesh.py`), each rank
runs its (A, B/N, L) shard, as the JAX package's shard_map does: the loss
of a microbatch stays the ratio of global sums, num_local / Σ_ranks den
(den all-reduced, with no gradient), so the ranks' gradients are summed,
not averaged (DDP's mean would weight ranks with different Σw wrongly);
the BatchNorm statistics are global (`models/cnn.BatchNorm` with the
group); the metrics are all-reduced; clipping and the optimizer step follow
the one gradient all-reduce, so the parameters stay equal on every rank.
The eval step all-gathers the logits in rank order (a tiled all_gather).

`dynamic_loss_scale=True` is the fp16 mode (`train_shard_scaled`,
`:413-448` there): the backward of loss × scale, the gradients divided by
accum_steps × scale after the all-reduce, a step whose reduced gradients
are not all finite skipped on every rank (parameters and optimizer state
untouched; the BatchNorm running statistics of its forward kept;
grad_norm inf), the scale halved on a skip but never below 1.0, doubled
after 2,000 clean steps. scale_state = (scale f32, good_steps i32).

Random numbers come from an explicit torch.Generator: the augmentation
draws of every microbatch first (`ops/augment.draw_augment`), then the
dropout masks in microbatch order. Tests inject the JAX package's draws
instead.

The fused multi-step epoch (`train_many`, `eval_many`: `:450-568` there)
gathers its batches from the device-resident cache (`data/device_cache.py`),
so only indices cross from the host. Step s of a `train_many` call draws
from the generator the per-step path seeds for step step0 + s
(`step_seed`), the counterpart of the JAX package's `fold_in(key, step0 +
s)`, so the two paths train alike. Eval runs G = max(1, 128 // b) batches
as one (G·b)-row forward. On a CUDA device one optimizer step, and one eval
group, is a CUDA graph captured once and replayed per step
(`parallel/step_graph.py`); on the CPU the same functions run eagerly.

Over a process group the fused epoch is the JAX `train_shard_many` /
`eval_shard_many` under shard_map: every rank holds the whole cache (the
JAX `P()`), takes its `local_batch_slice` columns of the global (K, A, B)
or (S, B) indices (the JAX in_specs' batch sharding) and gathers them from
its own replica. A train step is the sharded `train_step` with its
collectives, so on the card the captured graph holds them: Σw a
microbatch, the cross-rank BatchNorm's all-gather and all-reduce, the flat
gradient all-reduce and the metrics. An eval group needs no peer (eval
BatchNorm reads running statistics), so its graph holds no collective;
after the replays one all-reduce sums the (3, S) per-batch sums and one
all-gather joins the (S, b) predictions along the batch axis in rank
order, the JAX `P(None, "data")` out_spec's global (S, B).

Tracing (`tracing.py`): `train_many` runs in two spans,
`train_many.upload` (the rows' upload, the rate, the graph's lookup, and
its capture with the warm-up step where there is none yet) and
`train_many.replays` (the steps); `eval_many` in three,
`eval_many.upload`, `eval_many.replays` and `eval_many.collect` (the
collectives). A captured train step holds device marks at its phase boundaries: the start, after the input
and front end (the cache gather, dequantize, the augmentation's draws and
the front end), after each microbatch's forward and loss and after its
backward, and after the update (the gradient reduce, the clip and the
optimizer's step), and the ops' own around their kernels (attention's,
forward and backward); `train_many` leaves them with the recorder after its
replays.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch import tracing
from audio_classification_icbhi_tpu_torch.data.device_cache import dequantize
from audio_classification_icbhi_tpu_torch.ops import augment as aug_ops
from audio_classification_icbhi_tpu_torch.ops.mel import MelFrontend, normalize_spectrogram
from audio_classification_icbhi_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_sum,
    local_batch_slice,
)
from audio_classification_icbhi_tpu_torch.parallel.step_graph import GraphedStep

GROWTH_INTERVAL = 2000  # torch GradScaler's default, as the JAX step uses


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: torch.Tensor, mask: torch.Tensor | None = None,
                           dim: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σ w[y]·ce·mask, Σ w[y]·mask) over `dim` of labels' shape (None:
    every row): the loss is their ratio, exactly
    torch.nn.CrossEntropyLoss(weight=w) over the unmasked rows."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(-1, labels[..., None].long())[..., 0]
    w = class_weights[labels.long()]
    if mask is not None:
        w = w * mask
    return torch.sum(w * ce, dim), torch.sum(w, dim)


def masked_correct(preds: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                   dim: int | None = None) -> torch.Tensor:
    """The count of unmasked rows whose prediction is their label, over
    `dim` (None: every row)."""
    return torch.sum((preds == labels).float() * mask, dim)


def features_from_wavs(frontend: MelFrontend, wavs: torch.Tensor, *,
                       augment: bool = False,
                       draws: aug_ops.AugmentDraws | None = None) -> torch.Tensor:
    """wav (B, L) -> normalized log-mel image (B, n_mels, T, 1).

    augment=True applies `draws` (one microbatch's, `ops/augment`) in the
    reference's order: wave-aug -> mel -> dB -> SpecAugment -> normalize. On
    a kernel route the mask and normalize run inside the kernel's epilogue;
    on the plain route they follow the log-mel. Both mask from the same
    (B, 4) bounds."""
    bounds = None
    if augment:
        if draws is None:
            raise ValueError("augment=True needs the microbatch's draws")
        wavs = aug_ops.augment_waveform(wavs, draws.wave)
        bounds = aug_ops.spec_mask_bounds(draws.spec)
    if frontend.uses_kernel(wavs):
        return frontend._pallas_log_mel(wavs, normalize=True, spec_mask_bounds=bounds)[..., None]
    mel = frontend.log_mel(wavs)
    if bounds is not None:
        mel = aug_ops.mask_from_bounds(mel, bounds)
    return normalize_spectrogram(mel)[..., None]


def features_from_wavs_grouped(frontend: MelFrontend, wavs: torch.Tensor, *, augment: bool,
                               draws: Sequence[aug_ops.AugmentDraws] | None = None
                               ) -> torch.Tensor:
    """(A, B, L) microbatched wavs -> (A, B, n_mels, T, 1) features as ONE
    flattened (A·B)-wide front-end launch. The front end is per example, so
    this equals A separate `features_from_wavs` calls with the same draws."""
    a, b = wavs.shape[0], wavs.shape[1]
    flat = wavs.reshape((a * b,) + wavs.shape[2:])
    flat_draws = aug_ops.concat_draws(list(draws)) if augment else None
    feats = features_from_wavs(frontend, flat, augment=augment, draws=flat_draws)
    return feats.reshape((a, b) + feats.shape[1:])


def step_seed(seed: int, epoch: int, step: int, rank: int | None = None) -> int:
    """The seed of one train step's generator, a function of (seed, epoch,
    step) alone, and of the rank on a mesh of several."""
    entropy = [seed, epoch, step] + ([] if rank is None else [rank])
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


def _pad_rows(x, n: int):
    """x (a numpy array, or a tensor, padded on its device) with rows of
    zeros appended up to n rows."""
    if len(x) == n:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((n - len(x),) + tuple(x.shape[1:]))])
    return np.concatenate([x, np.zeros((n - len(x),) + x.shape[1:], x.dtype)])


def to_device(device: torch.device, x) -> torch.Tensor:
    """A numpy array or a tensor, on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device, non_blocking=True)


def pad_eval_batch(wavs, labels: np.ndarray, batch_size: int, rows: slice = slice(None)):
    """Pad a partial batch to batch_size with a validity mask, and take
    `rows` of it: a rank's rows, for which alone its loader decoded `wavs`
    (`labels` are the whole batch's). Returns (wavs, labels, mask,
    real_count); wavs stay a tensor on their device where the loader gave
    one (the device cache), the rest are numpy arrays."""
    b = len(labels)
    mask = (np.arange(batch_size) < b).astype(np.float32)[rows]
    return _pad_rows(wavs, len(mask)), _pad_rows(labels, batch_size)[rows], mask, b


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float = 1.0) -> torch.Tensor:
    """torch.nn.utils.clip_grad_norm_ semantics, in place: scale every
    gradient by min(1, max_norm / (‖g‖ + 1e-6)) where ‖g‖ is the global L2
    norm. Returns ‖g‖ (before clipping) as a 0-d tensor, without a sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(list(grads), scale)
    return norm


class TrainStepFns(NamedTuple):
    train_step: Callable
    eval_step: Callable
    # the fused multi-step epoch; None under dynamic_loss_scale, as in the
    # JAX package
    train_many: Callable | None = None
    eval_many: Callable | None = None


def all_reduce_grads(grads: Sequence[torch.Tensor], mesh: Mesh | None) -> None:
    """Σ over the ranks of every gradient, in place, as one all-reduce of
    one flat buffer. No-op without a group."""
    if mesh is None or mesh.group is None:
        return
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), mesh)
    torch._foreach_copy_(list(grads), [f.view_as(g) for f, g in
                                       zip(flat.split([g.numel() for g in grads]), grads)])


def all_finite(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """0-d bool: every element of every gradient is finite (the largest |g|
    of each tensor is; it cannot overflow as a norm can)."""
    return torch.isfinite(torch.stack(torch._foreach_norm(list(grads), float("inf")))).all()


def next_scale_state(scale_state, finite: bool):
    """The loss-scale update of the JAX step (`data_parallel.py:432-439`
    there): a clean step counts towards growth and doubles the scale at
    GROWTH_INTERVAL (the count back to 0); a skipped one resets the count
    and halves the scale, floored at 1.0 (torch's GradScaler has no
    floor)."""
    scale, good = np.float32(scale_state[0]), np.int32(scale_state[1])
    good = np.int32(good + 1) if finite else np.int32(0)
    grew = good >= GROWTH_INTERVAL
    if finite:
        scale = scale * np.float32(2.0) if grew else scale
    else:
        scale = np.maximum(scale * np.float32(0.5), np.float32(1.0))
    return np.float32(scale), np.int32(0) if grew else good


def make_step_fns(model: torch.nn.Module, frontend: MelFrontend,
                  optimizer: torch.optim.Optimizer, *, accum_steps: int = 1,
                  augment: bool = False, max_grad_norm: float = 1.0,
                  accum_mode: str = "parallel", mesh: Mesh | None = None,
                  dynamic_loss_scale: bool = False, seed: int = 42) -> TrainStepFns:
    """Train and eval steps over `model` and `optimizer`, updated in place.

    train_step(wavs (A, B, L), labels (A, B), class_weights (C,), lr,
               generator=None, draws=None[, scale_state], marks=None) -> metrics
        A ≤ accum_steps microbatches make one optimizer step; B is this
        rank's rows (the whole batch without a mesh). lr is a float, or a
        0-d tensor on the device; Adam and AdamW built capturable always
        take it as a device tensor, as their captured step reads it at each
        replay. Each microbatch's
        loss is its weighted mean over the global batch; its gradient is
        added divided by accum_steps. `draws` (a list of A AugmentDraws)
        replaces the augmentation draws from `generator`; dropout masks
        always come from `generator`. metrics = {loss: mean over the
        microbatches, correct, count (both over every rank), grad_norm},
        0-d tensors left on the device. With dynamic_loss_scale the step
        takes scale_state and returns (metrics, scale_state), the metrics
        with loss_scale and step_skipped; it reads one flag from the device
        (the skip is decided on the host, as GradScaler's is). `marks` (a
        captured step's `tracing.StepMarks`) records the phase boundaries.

    eval_step: `make_eval_step`'s.

    train_many(cache (N, L), idxs (K, A, B), labels (K, A, B),
               class_weights, lr, epoch, step0) -> metrics
        K optimizer steps on rows of the device cache (int16 or float32,
        `data/device_cache.py`), each gathered on the device
        (index_select, then dequantize) and trained as `train_step` trains
        them, step s with the generator seeded `step_seed(seed, epoch,
        step0 + s)`. idxs and labels are numpy or tensors. metrics: loss,
        correct, count, grad_norm, each (K,) on the device.
    eval_many(cache, idxs (S, B), labels (S, B), mask (S, B), class_weights)
        -> (num (S,), den (S,), correct (S,), predictions (S, B))
        per-batch sums and argmax predictions over masked rows, G = max(1,
        128 // B) batches a forward, S padded to a multiple of G with
        mask-0 rows that are cut off again.

    On a mesh with a group, idxs, labels and mask are the global arrays
    (B the global batch); each rank runs its `local_batch_slice` columns,
    with the rank in each step's seed (not at world size 1, as
    `Trainer.step_generator`), and eval_many's G counts this rank's b =
    B / N columns. eval_many returns the global sums and the (S, B)
    predictions on every rank.

    On a CUDA device both replay CUDA graphs (`parallel/step_graph.py`): the
    optimizer step is captured on its first call, after that call's first
    step has run eagerly as the capture's warm-up, and again, with no
    warm-up, when the cache, the class weights or the optimizer's state
    tensors change (the graph holds them by address; a restored checkpoint
    replaces the optimizer's state); the eval group once per cache and
    class weights, the same way. Adam and AdamW
    must be built `capturable` (`training/optimizers.build_optimizer`):
    their step count lives on the device, and so does the learning rate, a
    0-d tensor each call fills, so that a new rate (each epoch under
    cosine) needs no new capture. SGD's foreach update takes the rate only
    as a number, so its graph holds the rate it was captured at and is
    captured again when the rate changes. Over a group the train graph
    holds the step's NCCL collectives. The key that decides a capture
    changes at the same call on every rank (the same calls, rates and
    restores run everywhere), and only a kind's first capture warms up, so
    the warm-up's eager collectives, which also create the NCCL
    communicator before any capture, run on every rank together; a
    re-capture launches nothing. Over a group both kinds capture in
    "thread_local" mode: ProcessGroupNCCL's watchdog thread queries the
    events of eager collectives at any time, and the default "global" mode
    lets a capture forbid such calls to every thread of the process. A
    capture that fails raises; nothing falls back to eager steps.

    The step runs one flattened front end over all A·B examples, then the
    model once per microbatch, in order. `accum_mode` is accepted for the
    JAX package's configs, and "scan" and "parallel" give this same step:
    there the two modes differ in how the model runs (a scan or a vmap), and
    the vmap needs `recover_ema_chain` to rebuild the BatchNorm running
    statistics. Here the model runs once per microbatch and its BatchNorm
    buffers update in place each time: that is the sequential chain itself,
    so nothing needs recovering.
    """
    if accum_mode not in ("scan", "parallel"):
        raise ValueError(f"accum_mode must be scan|parallel, got {accum_mode!r}")
    params = [p for p in model.parameters() if p.requires_grad]
    dp = mesh if mesh is not None and mesh.group is not None else None
    # Adam and AdamW built capturable take the rate as a device tensor
    device_lr = bool(optimizer.param_groups) and all(
        g.get("capturable", False) for g in optimizer.param_groups)
    ranks = mesh.world_size if dp is not None else 1

    def train_step(wavs: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
                   lr: float, generator: torch.Generator | None = None,
                   draws: Sequence[aug_ops.AugmentDraws] | None = None, scale_state=None,
                   marks: tracing.StepMarks | None = None):
        mark = marks.mark if marks is not None else (lambda phase: None)
        a, b, length = wavs.shape
        if a > accum_steps:
            raise ValueError(f"{a} microbatches exceed accum_steps={accum_steps}")
        if dynamic_loss_scale and scale_state is None:
            raise ValueError("the loss-scaled step needs scale_state")
        scale = float(scale_state[0]) if dynamic_loss_scale else 1.0
        model.train()
        if augment and draws is None:
            draws = [aug_ops.draw_augment(generator, b, length, frontend.n_mels,
                                          frontend.num_frames, wavs.device)
                     for _ in range(a)]
        optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            feats = features_from_wavs_grouped(frontend, wavs, augment=augment, draws=draws)
        mark("front_end")
        nums, dens, corrects = [], [], []
        for i in range(a):
            logits = model(feats[i], generator=generator)
            num, den = weighted_cross_entropy(logits, labels[i], class_weights)
            den = all_reduce_sum(den.detach(), dp)  # Σ w over every rank; no gradient
            loss = num / den
            mark("forward")
            if dynamic_loss_scale:
                (loss * scale).backward()
            else:
                (loss / accum_steps).backward()
            mark("backward")
            nums.append(num.detach())
            dens.append(den)
            corrects.append((logits.detach().argmax(-1) == labels[i]).sum().float())
        grads = [p.grad for p in params]
        all_reduce_grads(grads, dp)
        sums = all_reduce_sum(torch.stack(nums + corrects), dp)
        metrics = {
            "loss": (sums[:a] / torch.stack(dens)).mean(),
            "correct": sums[a:].sum(),
            "count": torch.full((), float(a * b * ranks), device=wavs.device),
        }
        if device_lr and not isinstance(lr, torch.Tensor):
            # the rate as the captured step reads it: a float divides in
            # other roundings, which bf16 weights turn into other losses
            lr = torch.full((), float(lr), device=wavs.device)
        for group in optimizer.param_groups:
            group["lr"] = lr if isinstance(lr, torch.Tensor) else float(lr)
        if not dynamic_loss_scale:
            metrics["grad_norm"] = clip_by_global_norm(grads, max_grad_norm)
            optimizer.step()
            mark("update")
            return metrics
        torch._foreach_div_(grads, accum_steps * scale)
        finite = bool(all_finite(grads))  # the same on every rank: the gradients are reduced
        if finite:
            metrics["grad_norm"] = clip_by_global_norm(grads, max_grad_norm)
            optimizer.step()
        else:
            metrics["grad_norm"] = torch.full((), float("inf"), device=wavs.device)
        scale_state = next_scale_state(scale_state, finite)
        metrics["loss_scale"] = torch.full((), float(scale_state[0]), device=wavs.device)
        metrics["step_skipped"] = torch.full((), 0.0 if finite else 1.0, device=wavs.device)
        return metrics, scale_state

    eval_step = make_eval_step(model, frontend, mesh)
    if dynamic_loss_scale:
        return TrainStepFns(train_step=train_step, eval_step=eval_step)

    def gathered_step(cache, rows, class_weights, lr, generator):
        """One optimizer step on rows (2, A, B) int64 (cache indices,
        labels): (4,) loss, correct, count, grad_norm. While it is
        captured, its marks go to `capture_marks`."""
        a, b = rows.shape[1], rows.shape[2]
        marks = tracing.step_marks(cache.device)
        if marks is not None:
            capture_marks.append(marks)
            marks.mark("start")
        wavs = dequantize(cache.index_select(0, rows[0].reshape(-1))).reshape(a, b, -1)
        with tracing.marking(marks):  # the ops' own marks (`tracing.interval`)
            m = train_step(wavs, rows[1], class_weights, lr, generator=generator, marks=marks)
        return torch.stack([m["loss"], m["correct"], m["count"], m["grad_norm"]])

    @torch.no_grad()
    def eval_group(cache, rows, class_weights):
        """Eval of rows (3, G, B) int64 (cache indices, labels, mask) as
        one (G·B)-row forward: (G, 3 + B) float32, each batch's loss_num,
        loss_den, correct and argmax predictions."""
        g, b = rows.shape[1], rows.shape[2]
        model.eval()
        wavs = dequantize(cache.index_select(0, rows[0].reshape(-1)))
        logits = model(features_from_wavs(frontend, wavs)).reshape(g, b, -1)
        labels, mask = rows[1], rows[2].float()
        num, den = weighted_cross_entropy(logits, labels, class_weights, mask, dim=-1)
        preds = logits.argmax(-1)
        sums = torch.stack([num, den, masked_correct(preds, labels, mask, dim=-1)], dim=1)
        return torch.cat([sums, preds.float()], dim=1)

    graphs: dict[str, GraphedStep] = {}
    capture_marks: list[tracing.StepMarks] = []  # of the train step being captured
    sides: dict[str, tuple] = {}  # kind -> (memory pool, capture stream)
    # the watchdog's event queries must not invalidate a capture (above)
    capture_mode = "global" if dp is None else "thread_local"
    # step seeds carry the rank on a mesh of several, as Trainer.step_generator
    seed_rank = dp.rank if ranks > 1 else None

    def state_tensors() -> list[torch.Tensor]:
        return [t for st in optimizer.state.values() for t in st.values() if torch.is_tensor(t)]

    def graphed(kind: str, device: torch.device, key: Callable[[], tuple],
                make: Callable) -> GraphedStep:
        """The graph of `kind`, captured anew when key() changed, into the
        memory pool and on the stream of the last one; the first capture
        of a kind warms up first, on the call's first step."""
        step = graphs.get(kind)
        if step is not None and step.key == key():
            return step
        first = kind not in sides
        if first:
            sides[kind] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(device))
        pool, stream = sides[kind]
        step = make(pool=pool, stream=stream, warm=first)
        step.key = key()  # after the capture: its warm-up may create optimizer state
        graphs[kind] = step
        return step

    def took_first(step: GraphedStep, out: torch.Tensor) -> int:
        """Where the replays start: 1 when the step's capture has just run
        the call's first step as its warm-up (its output into out[0]), else
        0."""
        if step.first is None:
            return 0
        out[0].copy_(step.first)
        step.first = None
        return 1

    def train_graph(cache: torch.Tensor, rows: torch.Tensor, class_weights: torch.Tensor, lr,
                    seeds: list[int]) -> GraphedStep:
        """The train step's graph over these operands, its rate set to lr."""
        device = cache.device
        # Adam and AdamW built capturable read the rate from the device
        rate = torch.full((), float(lr), device=device) if device_lr else float(lr)

        def make(pool, stream, warm):
            # the warm-up is step 0, drawing what an eager step 0 draws
            generator = torch.Generator(device=device).manual_seed(seeds[0])

            def fn(r, *static_rate):  # the rate's static buffer, or none: SGD's is baked
                return gathered_step(cache, r, class_weights,
                                     static_rate[0] if device_lr else rate, generator)

            capture_marks.clear()
            step = GraphedStep(fn, [rows[0]] + ([rate] if device_lr else []),
                               stream=stream, kind="train", warm=warm, generator=generator,
                               pool=pool, capture_error_mode=capture_mode)
            step.marks = capture_marks.pop() if capture_marks else None
            return step

        step = graphed("train", device, lambda: (
            cache.data_ptr(), tuple(cache.shape), cache.dtype, tuple(rows.shape[1:]),
            class_weights.data_ptr(), None if device_lr else rate,
            tuple(t.data_ptr() for t in state_tensors())), make)
        if device_lr:
            step.static[1].copy_(rate)
        return step

    def train_many(cache: torch.Tensor, idxs, labels, class_weights: torch.Tensor, lr,
                   epoch: int, step0: int):
        device = cache.device
        with tracing.span("train_many.upload"):
            idxs = torch.as_tensor(idxs, dtype=torch.int64)
            own = local_batch_slice(idxs.shape[-1], dp)  # this rank's columns
            rows = to_device(device, torch.stack(
                [idxs[..., own], torch.as_tensor(labels, dtype=torch.int64)[..., own]], dim=1))
            k = rows.shape[0]
            seeds = [step_seed(seed, epoch, step0 + s, seed_rank) for s in range(k)]
            out = torch.empty((k, 4), device=device)
            step = train_graph(cache, rows, class_weights, lr, seeds) \
                if device.type == "cuda" else None
            start = 0 if step is None else took_first(step, out)
        with tracing.span("train_many.replays"):
            if step is None:
                for s in range(k):
                    generator = torch.Generator(device=device).manual_seed(seeds[s])
                    out[s] = gathered_step(cache, rows[s], class_weights, lr, generator)
            else:
                for s in range(start, k):
                    step.generator.manual_seed(seeds[s])
                    out[s].copy_(step.replay(rows[s]))
        if step is not None and k > start:
            tracing.marks_pending(step.marks)
        return {"loss": out[:, 0], "correct": out[:, 1], "count": out[:, 2],
                "grad_norm": out[:, 3]}

    def eval_graph(cache: torch.Tensor, rows: torch.Tensor,
                   class_weights: torch.Tensor) -> GraphedStep:
        """The eval group's graph over these operands."""
        def make(pool, stream, warm):
            def fn(r):
                return eval_group(cache, r, class_weights)

            return GraphedStep(fn, [rows[0]], stream=stream, kind="eval", warm=warm,
                               pool=pool, capture_error_mode=capture_mode)

        return graphed("eval", cache.device, lambda: (
            cache.data_ptr(), tuple(cache.shape), cache.dtype, tuple(rows.shape[2:]),
            class_weights.data_ptr()), make)

    def eval_many(cache: torch.Tensor, idxs, labels, mask, class_weights: torch.Tensor):
        device = cache.device
        idxs = torch.as_tensor(idxs, dtype=torch.int64)
        s, b_all = idxs.shape
        if s == 0:
            z = torch.zeros(0, device=device)
            return z, z, z, torch.zeros((0, b_all), dtype=torch.int64, device=device)
        with tracing.span("eval_many.upload"):
            own = local_batch_slice(b_all, dp)  # this rank's columns
            rows = torch.stack([idxs, torch.as_tensor(labels, dtype=torch.int64),
                                torch.as_tensor(mask).to(torch.int64)])[:, :, own]  # (3, S, b)
            b = rows.shape[2]
            g = max(1, 128 // b)
            pad = (-s) % g
            if pad:  # repeated rows of the first batch, masked out
                fill = rows[:, :1].expand(3, pad, b).clone()
                fill[2] = 0
                rows = torch.cat([rows, fill], dim=1)
            n = rows.shape[1] // g
            rows = to_device(device, rows.reshape(3, n, g, b).permute(1, 0, 2, 3).contiguous())
            out = torch.empty((n, g, 3 + b), device=device)
            step = eval_graph(cache, rows, class_weights) if device.type == "cuda" else None
            start = 0 if step is None else took_first(step, out)
        with tracing.span("eval_many.replays"):
            if step is None:
                for i in range(n):
                    out[i] = eval_group(cache, rows[i], class_weights)
            else:
                for i in range(start, n):
                    out[i].copy_(step.replay(rows[i]))
        with tracing.span("eval_many.collect"):
            out = out.reshape(n * g, 3 + b)[:s]
            # the global sums, and every rank's columns of the predictions in
            # rank order (no-ops without a group)
            sums = all_reduce_sum(out[:, :3].T.contiguous(), dp)
            preds = all_gather_rows(out[:, 3:].long(), dp, dim=1)
        return sums[0], sums[1], sums[2], preds

    # the captured steps by kind ("train", "eval"), for inspection; the
    # recorder counts their captures and replays (`tracing.counters()`)
    train_many.graphs = eval_many.graphs = graphs
    return TrainStepFns(train_step=train_step, eval_step=eval_step, train_many=train_many,
                        eval_many=eval_many)


def make_eval_step(model: torch.nn.Module, frontend: MelFrontend,
                   mesh: Mesh | None = None) -> Callable:
    """eval_step(wavs (B, L), labels (B,), mask (B,), class_weights)
    -> (logits (B, C), loss_num, loss_den, correct) under the mask, with the
    model in eval mode and no gradient. On a mesh with a group, B is this
    rank's rows: the sums come back over every rank and the logits of
    every rank's rows, in rank order."""
    dp = mesh if mesh is not None and mesh.group is not None else None

    @torch.no_grad()
    def eval_step(wavs: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                  class_weights: torch.Tensor):
        model.eval()
        logits = model(features_from_wavs(frontend, wavs))
        num, den = weighted_cross_entropy(logits, labels, class_weights, mask)
        correct = masked_correct(logits.argmax(-1), labels, mask)
        if dp is not None:
            num, den, correct = all_reduce_sum(torch.stack([num, den, correct]), dp)
            logits = all_gather_rows(logits, dp)
        return logits, num, den, correct

    return eval_step


def eval_batches(eval_step: Callable, loader, batch_size: int, device: torch.device,
                 class_weights: torch.Tensor, mesh: Mesh | None = None):
    """The eval pass over `loader`'s (wavs, labels) batches (numpy, or
    wavs already on the device from the device cache), each padded to
    batch_size with a mask (`pad_eval_batch`) and run through `eval_step` on
    `device`. On a mesh of several ranks (batch_size a
    multiple of them), the loader decodes only this rank's rows of each
    batch (`BatchLoader(shard=...)`) and gives every row's label; the rank
    runs its rows of the padded batch. Yields, a batch, (logits of the real
    rows on the device, loss_num, loss_den, correct, the real rows' labels
    as numpy)."""
    rows = local_batch_slice(batch_size, mesh)  # every row without a mesh
    for wavs, labels in loader:
        wavs, padded, mask, b = pad_eval_batch(wavs, labels, batch_size, rows)
        logits, num, den, correct = eval_step(to_device(device, wavs),
                                              to_device(device, padded).long(),
                                              to_device(device, mask), class_weights)
        yield logits[:b], num, den, correct, labels
