"""The reference's weights, train steps and validation loss.

Given the benchmark's inputs (waveforms, labels, the seed, the config), it
follows what the program does at `config.yaml`: gradient accumulation over
A microbatches, each microbatch's loss Σ w[y]·ce / Σ w[y] with
inverse-frequency class weights, its gradient divided by A, clipping at a
global norm of 1.0 (scale min(1, 1 / (‖g‖ + 1e-6))), then Adam (β 0.9,
0.999, ε 1e-8) with the weight decay added to the gradient before the
moments.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from port_bench.reference import full_f32
from port_bench.reference.frontend import concat, draw, features, step_seed

BETAS, EPS = (0.9, 0.999), 1e-8


def derived_seed(seed: int, tag: int) -> int:
    """A seed for one purpose (tag) of the run seed."""
    return int(np.random.SeedSequence([seed, tag]).generate_state(1, np.uint64)[0] >> 1)


def architecture(config: dict):
    """The reference module of the config's model.architecture."""
    return importlib.import_module(f"port_bench.reference.{config['model']['architecture']}")


def build(config: dict, precision: str = "f32") -> torch.nn.Module:
    m = config["model"]
    return architecture(config).Model(m["num_classes"], m["dropout"], precision)


def class_weights(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Inverse-frequency weights n / (C · count) of the train labels."""
    counts = np.bincount(labels, minlength=num_classes).astype(np.float64)
    return (len(labels) / (num_classes * np.maximum(counts, 1))).astype(np.float32)


DENSE = (torch.nn.Linear, torch.nn.Conv2d)
NORMS = (torch.nn.BatchNorm2d, torch.nn.LayerNorm)


def seeded_state(config: dict, seed: int, calib: torch.Tensor) -> dict[str, torch.Tensor]:
    """Weights from seed, made on calib's device in one draw z, split over
    the parameters in their order. By the module that owns a parameter:
    - `nn.Conv2d` / `nn.Linear` weights N(0, 2 / fan_in), the output layer's
      (the last 2-D leaf) N(0, 1 / fan_in); their biases N(0, 0.05²);
    - `nn.BatchNorm2d` and `nn.LayerNorm` scales 1 + N(0, 0.1²) and shifts
      N(0, 0.1²), so that a normalized activation keeps its scale (with
      LayerNorm scales near 0, q·k would be near 0 and every attention row
      near uniform);
    - a parameter that none of these owns (a positional table, a class
      token) N(0, 0.02²), the std of timm's truncated normal.
    Then, where the model has BatchNorms, each one's running statistics are
    set to its batch statistics over the calibration waveforms calib (B, L),
    unaugmented, so that eval mode sees normalized activations as a trained
    model does."""
    device = calib.device
    model = build(config).to(device)
    params = list(model.named_parameters())
    g = torch.Generator(device=device).manual_seed(derived_seed(seed, 2))
    z = torch.randn(sum(p.numel() for _, p in params), generator=g, device=device)
    last = [n for n, p in params if p.ndim == 2][-1]
    owner = {id(p): m for m in model.modules() for p in m.parameters(recurse=False)}
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for (name, p), part in zip(params, z.split([p.numel() for _, p in params])):
            part, m = part.view_as(p), owner[id(p)]
            if isinstance(m, NORMS):
                p.copy_(1.0 + 0.1 * part if p is m.weight else 0.1 * part)
            elif not isinstance(m, DENSE):
                p.copy_(0.02 * part)
            elif p.ndim > 1:
                fan_in = p[0].numel()
                p.copy_(part * (1.0 / fan_in if name == last else 2.0 / fan_in) ** 0.5)
            else:
                p.copy_(0.05 * part)
        if bns:
            for bn in bns:
                bn.calibrate = True
            with full_f32():
                model(features(calib, config["data"]), train=True)
            for bn in bns:
                bn.calibrate = False
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _weighted_ce(logits, labels, weights):
    logp = torch.log_softmax(logits, dim=-1)
    w = weights[labels]
    return -(w * logp.gather(-1, labels[:, None])[:, 0]).sum(), w.sum()


def follow_train(config: dict, state0: dict, wavs: torch.Tensor, labels: torch.Tensor,
                 weights: torch.Tensor, lr: float, seed: int, precision: str = "f32",
                 half_batch: bool = False, frozen: bool = False) -> dict:
    """The first S optimizer steps from state0 on wavs (S, A, B, L) and
    labels (S, A, B), step s drawing from the generator seeded
    step_seed(seed, 0, s). Returns the steps' losses (mean over the
    microbatches), each leaf's first gradient as Adam takes it (after
    clipping, with the weight decay) by norm and whole (on the host), and
    each leaf's and each BatchNorm running statistic's change after the S
    steps by norm. Two planted faults: half_batch takes each microbatch's
    loss over its first half only; frozen makes every step return the
    state unchanged (no update, the running statistics as they were, and
    Adam's state, from which the first gradient is read, stays zero)."""
    device = wavs.device
    data, wd = config["data"], float(config["training"]["weight_decay"])
    steps, accum, batch, length = wavs.shape
    state0 = {k: v.to(device) for k, v in state0.items()}
    model = build(config, precision).to(device)
    model.load_state_dict(state0)
    named = list(model.named_parameters())
    params = [p for _, p in named]
    m1 = [torch.zeros_like(p) for p in params]
    m2 = [torch.zeros_like(p) for p in params]
    losses, grad1, grad1_tensors = [], {}, {}
    with full_f32():
        for s in range(steps):
            g = torch.Generator(device=device).manual_seed(step_seed(seed, 0, s))
            d = concat([draw(g, batch, length, data["n_mels"], 1 + length // data["hop_length"],
                             device) for _ in range(accum)])
            feats = features(wavs[s].reshape(accum * batch, length), data, d)
            feats = feats.reshape((accum, batch) + feats.shape[1:])
            for p in params:
                p.grad = None
            step_losses = []
            for i in range(accum):
                logits = model(feats[i], train=True, g=g)
                y = labels[s, i]
                if half_batch:
                    logits, y = logits[: batch // 2], y[: batch // 2]
                num, den = _weighted_ce(logits, y, weights)
                loss = num / den
                (loss / accum).backward()
                step_losses.append(loss.detach())
            losses.append(float(torch.stack(step_losses).mean()))
            if frozen:
                continue
            with torch.no_grad():
                grads = [p.grad for p in params]
                norm = torch.sqrt(sum((gr.double() ** 2).sum() for gr in grads)).float()
                scale = torch.clamp(1.0 / (norm + 1e-6), max=1.0)
                t = s + 1
                for i, (p, gr) in enumerate(zip(params, grads)):
                    gr = gr * scale + wd * p
                    if s == 0:
                        grad1[named[i][0]] = float(gr.norm())
                        grad1_tensors[named[i][0]] = gr.cpu()
                    m1[i].mul_(BETAS[0]).add_((1 - BETAS[0]) * gr)
                    m2[i].mul_(BETAS[1]).add_((1 - BETAS[1]) * gr * gr)
                    denom = (m2[i] / (1 - BETAS[1] ** t)).sqrt() + EPS
                    p.sub_(lr * (m1[i] / (1 - BETAS[0] ** t)) / denom)
    if frozen:
        grad1 = {n: 0.0 for n, _ in named}
        grad1_tensors = {n: torch.zeros_like(p, device="cpu") for n, p in named}
    change = {n: float((p.detach() - state0[n]).norm()) for n, p in named}
    stats = {n: 0.0 if frozen else float((b - state0[n]).norm())
             for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))}
    return {"losses": losses, "grad1": grad1, "grad1_tensors": grad1_tensors, "change": change,
            "stats": stats}


@torch.no_grad()
def eval_losses(config: dict, state: dict, wavs: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor, batch_size: int, precision: str = "f32") -> list[float]:
    """Each validation batch's loss, Σ w[y]·ce / Σ w[y], over the loader's
    batches in order (the last one short); the trainer reports their mean."""
    model = build(config, precision).to(wavs.device)
    model.load_state_dict(state)
    ratios = []
    with full_f32():
        for s in range(0, len(wavs), batch_size):
            logits = model(features(wavs[s:s + batch_size], config["data"]), train=False)
            num, den = _weighted_ce(logits, labels[s:s + batch_size], weights)
            ratios.append(float(num / den))
    return ratios

