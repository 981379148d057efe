"""Train and eval steps: wav -> features -> loss -> update, on one device or
one rank of a data-parallel mesh.

Port of `audio_classification_icbhi_tpu/parallel/data_parallel.py:37-644`
(the multi-step dispatch is ROADMAP.md A6):

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
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch.ops import augment as aug_ops
from audio_classification_icbhi_tpu_torch.ops.mel import MelFrontend, normalize_spectrogram
from audio_classification_icbhi_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_sum,
    local_batch_slice,
)

GROWTH_INTERVAL = 2000  # torch GradScaler's default, as the JAX step uses


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: torch.Tensor,
                           mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σ w[y]·ce·mask, Σ w[y]·mask): the loss is their ratio, exactly
    torch.nn.CrossEntropyLoss(weight=w) over the unmasked rows."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(-1, labels[:, None].long())[:, 0]
    w = class_weights[labels.long()]
    if mask is not None:
        w = w * mask
    return torch.sum(w * ce), torch.sum(w)


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


def _pad_rows(x: np.ndarray, n: int) -> np.ndarray:
    """x with rows of zeros appended up to n rows."""
    return x if len(x) == n else np.concatenate([x, np.zeros((n - len(x),) + x.shape[1:],
                                                             x.dtype)])


def pad_eval_batch(wavs: np.ndarray, labels: np.ndarray, batch_size: int,
                   rows: slice = slice(None)):
    """Pad a partial batch to batch_size with a validity mask, and take
    `rows` of it: a rank's rows, for which alone its loader decoded `wavs`
    (`labels` are the whole batch's). Returns (wavs, labels, mask,
    real_count) as numpy arrays."""
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
                  dynamic_loss_scale: bool = False) -> TrainStepFns:
    """Train and eval steps over `model` and `optimizer`, updated in place.

    train_step(wavs (A, B, L), labels (A, B), class_weights (C,), lr,
               generator=None, draws=None[, scale_state]) -> metrics
        A ≤ accum_steps microbatches make one optimizer step; B is this
        rank's rows (the whole batch without a mesh). Each microbatch's
        loss is its weighted mean over the global batch; its gradient is
        added divided by accum_steps. `draws` (a list of A AugmentDraws)
        replaces the augmentation draws from `generator`; dropout masks
        always come from `generator`. metrics = {loss: mean over the
        microbatches, correct, count (both over every rank), grad_norm},
        0-d tensors left on the device. With dynamic_loss_scale the step
        takes scale_state and returns (metrics, scale_state), the metrics
        with loss_scale and step_skipped; it reads one flag from the device
        (the skip is decided on the host, as GradScaler's is).

    eval_step: `make_eval_step`'s.

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
    ranks = mesh.world_size if dp is not None else 1

    def train_step(wavs: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
                   lr: float, generator: torch.Generator | None = None,
                   draws: Sequence[aug_ops.AugmentDraws] | None = None, scale_state=None):
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
        nums, dens, corrects = [], [], []
        for i in range(a):
            logits = model(feats[i], generator=generator)
            num, den = weighted_cross_entropy(logits, labels[i], class_weights)
            den = all_reduce_sum(den.detach(), dp)  # Σ w over every rank; no gradient
            loss = num / den
            if dynamic_loss_scale:
                (loss * scale).backward()
            else:
                (loss / accum_steps).backward()
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
        for group in optimizer.param_groups:
            group["lr"] = float(lr)
        if not dynamic_loss_scale:
            metrics["grad_norm"] = clip_by_global_norm(grads, max_grad_norm)
            optimizer.step()
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

    return TrainStepFns(train_step=train_step, eval_step=make_eval_step(model, frontend, mesh))


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
        correct = torch.sum((logits.argmax(-1) == labels).float() * mask)
        if dp is not None:
            num, den, correct = all_reduce_sum(torch.stack([num, den, correct]), dp)
            logits = all_gather_rows(logits, dp)
        return logits, num, den, correct

    return eval_step


def eval_batches(eval_step: Callable, loader, batch_size: int, device: torch.device,
                 class_weights: torch.Tensor, mesh: Mesh | None = None):
    """The eval pass over `loader`'s (wavs, labels) numpy batches, each
    padded to batch_size with a mask (`pad_eval_batch`) and run through
    `eval_step` on `device`. On a mesh of several ranks (batch_size a
    multiple of them), the loader decodes only this rank's rows of each
    batch (`BatchLoader(shard=...)`) and gives every row's label; the rank
    runs its rows of the padded batch. Yields, a batch, (logits of the real
    rows on the device, loss_num, loss_den, correct, the real rows' labels
    as numpy)."""
    def to_device(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, non_blocking=True)

    rows = local_batch_slice(batch_size, mesh)  # every row without a mesh
    for wavs, labels in loader:
        wavs, padded, mask, b = pad_eval_batch(wavs, labels, batch_size, rows)
        logits, num, den, correct = eval_step(to_device(wavs), to_device(padded).long(),
                                              to_device(mask), class_weights)
        yield logits[:b], num, den, correct, labels
