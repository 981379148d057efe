"""Train and eval steps on one device: wav -> features -> loss -> update.

Port of `audio_classification_icbhi_tpu/parallel/data_parallel.py:37-644`,
single-device (the mesh, the multi-step dispatch and the fp16 loss scale
are ROADMAP.md A10, A6 and A5):

- the front end with the reference's augmentation order: wave-aug ->
  mel + dB -> SpecAugment mask -> normalize. On a CUDA tensor the mask and
  normalize run in the log-mel kernel's epilogue (its training form); on a
  CPU tensor the plain chain runs;
- class-weighted cross entropy as torch.nn.CrossEntropyLoss(weight=w):
  Σ w[y]·ce / Σ w[y];
- gradient accumulation over A microbatches, each gradient divided by
  accum_steps (also in a shorter tail group), then global-norm clipping at
  1.0 with torch semantics and one optimizer step at the given lr.

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


def pad_eval_batch(wavs: np.ndarray, labels: np.ndarray, batch_size: int):
    """Pad a partial batch to batch_size with a validity mask. Returns
    (wavs, labels, mask, real_count) as numpy arrays."""
    b = wavs.shape[0]
    mask = np.ones((batch_size,), np.float32)
    if b < batch_size:
        pad = batch_size - b
        wavs = np.concatenate([wavs, np.zeros((pad,) + wavs.shape[1:], wavs.dtype)])
        labels = np.concatenate([labels, np.zeros((pad,), labels.dtype)])
        mask[b:] = 0.0
    return wavs, labels, mask, b


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


def make_step_fns(model: torch.nn.Module, frontend: MelFrontend,
                  optimizer: torch.optim.Optimizer, *, accum_steps: int = 1,
                  augment: bool = False, max_grad_norm: float = 1.0,
                  accum_mode: str = "parallel") -> TrainStepFns:
    """Train and eval steps over `model` and `optimizer`, updated in place.

    train_step(wavs (A, B, L), labels (A, B), class_weights (C,), lr,
               generator=None, draws=None) -> metrics
        A ≤ accum_steps microbatches make one optimizer step. Each
        microbatch's loss is its weighted mean; its gradient is added
        divided by accum_steps. `draws` (a list of A AugmentDraws) replaces
        the augmentation draws from `generator`; dropout masks always come
        from `generator`. metrics = {loss: mean over the microbatches,
        correct, count, grad_norm}, 0-d tensors left on the device.

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

    def train_step(wavs: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
                   lr: float, generator: torch.Generator | None = None,
                   draws: Sequence[aug_ops.AugmentDraws] | None = None) -> dict:
        a, b, length = wavs.shape
        if a > accum_steps:
            raise ValueError(f"{a} microbatches exceed accum_steps={accum_steps}")
        model.train()
        if augment and draws is None:
            draws = [aug_ops.draw_augment(generator, b, length, frontend.n_mels,
                                          frontend.num_frames, wavs.device)
                     for _ in range(a)]
        optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            feats = features_from_wavs_grouped(frontend, wavs, augment=augment, draws=draws)
        losses, corrects = [], []
        for i in range(a):
            logits = model(feats[i], generator=generator)
            num, den = weighted_cross_entropy(logits, labels[i], class_weights)
            loss = num / den
            (loss / accum_steps).backward()
            losses.append(loss.detach())
            corrects.append((logits.detach().argmax(-1) == labels[i]).sum())
        grad_norm = clip_by_global_norm([p.grad for p in params], max_grad_norm)
        for group in optimizer.param_groups:
            group["lr"] = float(lr)
        optimizer.step()
        return {
            "loss": torch.stack(losses).mean(),
            "correct": torch.stack(corrects).sum().float(),
            "count": torch.full((), float(a * b), device=wavs.device),
            "grad_norm": grad_norm,
        }

    return TrainStepFns(train_step=train_step, eval_step=make_eval_step(model, frontend))


def make_eval_step(model: torch.nn.Module, frontend: MelFrontend) -> Callable:
    """eval_step(wavs (B, L), labels (B,), mask (B,), class_weights)
    -> (logits (B, C), loss_num, loss_den, correct) under the mask, with the
    model in eval mode and no gradient."""

    @torch.no_grad()
    def eval_step(wavs: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                  class_weights: torch.Tensor):
        model.eval()
        logits = model(features_from_wavs(frontend, wavs))
        num, den = weighted_cross_entropy(logits, labels, class_weights, mask)
        correct = torch.sum((logits.argmax(-1) == labels).float() * mask)
        return logits, num, den, correct

    return eval_step


def eval_batches(eval_step: Callable, loader, batch_size: int, device: torch.device,
                 class_weights: torch.Tensor):
    """The eval pass over `loader`'s (wavs, labels) numpy batches, each
    padded to batch_size with a mask (`pad_eval_batch`) and run through
    `eval_step` on `device`. Yields, a batch, (logits of the real rows on
    the device, loss_num, loss_den, correct, the real rows' labels as
    numpy)."""
    def to_device(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, non_blocking=True)

    for wavs, labels in loader:
        wavs, labels, mask, b = pad_eval_batch(wavs, labels, batch_size)
        logits, num, den, correct = eval_step(to_device(wavs), to_device(labels).long(),
                                              to_device(mask), class_weights)
        yield logits[:b], num, den, correct, labels[:b]
