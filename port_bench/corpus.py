"""Seeded respiratory-like clips, and an ICBHI-layout corpus of them.

One vectorised generator, run on the device from a `torch.Generator`: per
clip a breathing envelope over low-passed noise, with a wheeze (a tone with
vibrato) in the wheezes and both classes and crackles (sparse impulses) in
the crackles and both classes. A whole corpus costs a few FFTs, so it is
made anew in every run. The class counts are ICBHI 2017's shares of the
corpus (`ICBHI_CLASS_PROBS`, copied from the port's `data/synthetic.py`)
by largest remainder, dealt out in a seeded order: every seed gets the same
counts.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

ICBHI_CLASS_PROBS = (0.528, 0.270, 0.128, 0.073)  # normal, crackles, wheezes, both
CHUNK = 128  # clips a generator call, which bounds the device memory it takes


class Corpus(NamedTuple):
    pcm: np.ndarray      # (N, L) int16, in the files' sorted order
    labels: np.ndarray   # (N,) int64 recording labels


def class_counts(n: int, probs=ICBHI_CLASS_PROBS) -> list[int]:
    """n split by `probs`, by largest remainder."""
    raw = np.asarray(probs) / np.sum(probs) * n
    counts = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - counts), kind="stable")[: n - counts.sum()]:
        counts[i] += 1
    return counts.tolist()


def seeded_labels(n: int, seed: int) -> np.ndarray:
    """(n,) labels with `class_counts(n)`, in an order drawn from seed."""
    labels = np.repeat(np.arange(len(ICBHI_CLASS_PROBS)), class_counts(n))
    np.random.default_rng([seed, 1]).shuffle(labels)
    return labels


def _clips(labels: torch.Tensor, length: int, sr: int, g: torch.Generator) -> torch.Tensor:
    """(n, length) float32 clips in [-1, 1) for the given labels."""
    n, dev = labels.shape[0], labels.device

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape or (n, 1), generator=g, device=dev)

    t = torch.arange(length, device=dev, dtype=torch.float32) / sr
    env = (0.5 + 0.5 * torch.sin(2 * torch.pi * u(0.2, 0.35) * t + u(0, 2 * torch.pi))) ** 2
    noise = torch.randn(n, length, generator=g, device=dev)
    spec = torch.fft.rfft(noise)
    f = torch.fft.rfftfreq(length, 1.0 / sr).to(dev)
    spec = spec / (1.0 + (f / u(300.0, 900.0)) ** 2)  # a breath's low-passed hiss
    breath = torch.fft.irfft(spec, n=length)
    breath = breath / breath.std(dim=1, keepdim=True)
    x = u(0.05, 0.2) * env * (0.3 + breath)
    wheeze = (labels == 2) | (labels == 3)
    crackle = (labels == 1) | (labels == 3)
    f0 = u(200.0, 800.0) * (1.0 + 0.02 * torch.sin(2 * torch.pi * u(3.0, 7.0) * t))
    tone = u(0.02, 0.1) * torch.sin(2 * torch.pi * f0 * t) * env
    x = x + wheeze[:, None] * tone
    clicks = (torch.rand(n, length, generator=g, device=dev) < 4e-4) * \
        torch.randn(n, length, generator=g, device=dev)
    x = x + crackle[:, None] * 0.3 * clicks
    return x.clamp(-1.0, 32767.0 / 32768.0)


def make_clips(labels: np.ndarray, length: int, sr: int, seed: int, device) -> np.ndarray:
    """(N, length) int16 PCM clips for `labels` on the host, made on
    `device` from `seed` CHUNK clips at a time."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = np.empty((len(labels), length), np.int16)
    for s in range(0, len(labels), CHUNK):
        lab = torch.as_tensor(labels[s:s + CHUNK], device=device)
        x = _clips(lab, length, sr, g)
        out[s:s + CHUNK] = torch.round(x * 32768.0).clamp(-32768, 32767).to(torch.int16).cpu().numpy()
    return out


def wav_bytes(pcm: np.ndarray, sr: int) -> bytes:
    """A mono 16-bit PCM RIFF/WAVE file of `pcm`."""
    data = pcm.astype("<i2").tobytes()
    header = (b"RIFF" + (36 + len(data)).to_bytes(4, "little") + b"WAVE"
              + b"fmt " + (16).to_bytes(4, "little") + (1).to_bytes(2, "little")
              + (1).to_bytes(2, "little") + sr.to_bytes(4, "little")
              + (2 * sr).to_bytes(4, "little") + (2).to_bytes(2, "little")
              + (16).to_bytes(2, "little") + b"data" + len(data).to_bytes(4, "little"))
    return header + data


def annotation(label: int, duration: float) -> str:
    """Three breathing cycles over the clip whose OR of flags is `label`
    (0 normal, 1 crackles, 2 wheezes, 3 both), as ICBHI's tab-separated
    `start end crackles wheezes` lines."""
    flags = {0: [(0, 0)] * 3, 1: [(0, 0), (1, 0), (0, 0)], 2: [(0, 1), (0, 0), (0, 0)],
             3: [(1, 0), (0, 0), (0, 1)]}[int(label)]
    step = duration / 3
    return "".join(f"{i * step:.3f}\t{(i + 1) * step:.3f}\t{c}\t{w}\n"
                   for i, (c, w) in enumerate(flags))


def write_icbhi(root: Path, n: int, sr: int, duration: float, seed: int, device) -> Corpus:
    """n recordings of `duration` s at sr in ICBHI's layout,
    root/audio_and_txt_files/<name>.wav and .txt, made from seed."""
    length = int(sr * duration)
    labels = seeded_labels(n, seed)
    pcm = make_clips(labels, length, sr, seed, device)
    audio = Path(root) / "audio_and_txt_files"
    audio.mkdir(parents=True, exist_ok=True)
    names = [f"{i:04d}_1b1_Al_sc_Meditron" for i in range(n)]  # sorted = index order
    for name, row, label in zip(names, pcm, labels):
        (audio / f"{name}.wav").write_bytes(wav_bytes(row, sr))
        (audio / f"{name}.txt").write_text(annotation(label, duration))
    return Corpus(pcm, labels.astype(np.int64))
