"""Synthetic ICBHI-like recordings (numpy only).

Port of `generate_icbhi_dataset` and what it calls from
`audio_classification_icbhi_tpu/data/synthetic.py`, line for line, so the
same seed writes byte-identical files: breathing-noise base, crackle
transients and wheeze tones (``hard=False``), or the non-separable regime
with confusers, pink noise and per-patient profiles (``hard=True``). The
ICBHI corpus is not in the repository, so tests and `chip_smoke.py` train on
these. Also ported: the segmented per-class layout
(`generate_segmented_dataset`, `icbhi_class_counts`) and the corpus fixture
shaped like the real download (`generate_icbhi_corpus_fixture`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from audio_classification_icbhi_tpu_torch.data.annotations import SEGMENT_DIR_NAMES
from audio_classification_icbhi_tpu_torch.data.wavio import write_wav

# Real ICBHI 2017 per-cycle class frequencies: normal 3642, crackles 1864,
# wheezes 886, both 506 of 6898 cycles (ICBHI 2017 challenge paper, Table 1).
ICBHI_CLASS_PROBS = (0.528, 0.270, 0.128, 0.073)


def _breath_noise(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    """Low-passed noise amplitude-modulated at a breathing rate (~0.3 Hz)."""
    noise = rng.standard_normal(n + 64)
    kernel = np.hanning(65)
    kernel /= kernel.sum()
    lp = np.convolve(noise, kernel, mode="valid")[:n]
    t = np.arange(n) / sr
    phase = rng.uniform(0, 2 * np.pi)
    envelope = 0.55 + 0.45 * np.sin(2 * np.pi * 0.3 * t + phase)
    return (lp * envelope).astype(np.float32)


def _add_crackles(rng: np.random.Generator, x: np.ndarray, sr: int, density: float = 6.0):
    """Short (~5 ms) damped wideband bursts."""
    n = len(x)
    num = max(1, int(density * n / sr))
    for _ in range(num):
        pos = rng.integers(0, n - 128)
        burst = rng.standard_normal(128) * np.exp(-np.arange(128) / 20.0)
        x[pos : pos + 128] += 0.9 * burst.astype(np.float32)
    return x


def _add_wheeze(rng: np.random.Generator, x: np.ndarray, sr: int):
    """Sustained tonal whistle with slight vibrato, 200-800 Hz."""
    n = len(x)
    t = np.arange(n) / sr
    f0 = rng.uniform(200, 800)
    vibrato = 1.0 + 0.02 * np.sin(2 * np.pi * 4.0 * t)
    tone = np.sin(2 * np.pi * f0 * vibrato * t) + 0.3 * np.sin(2 * np.pi * 2 * f0 * t)
    envelope = 0.5 + 0.5 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 2 * np.pi))
    x += (0.5 * tone * envelope).astype(np.float32)
    return x


def _pink_noise(rng: np.random.Generator, n: int, exp: float = 0.5) -> np.ndarray:
    """1/f^(2*exp)-shaped noise (FFT method) — broadband background like ward
    noise; exp is a patient/ward 'noise color' (0.5 = pink)."""
    white = rng.standard_normal(n)
    spec = np.fft.rfft(white)
    freqs = np.arange(spec.shape[0], dtype=np.float64)
    freqs[0] = 1.0
    spec /= freqs**exp
    return np.fft.irfft(spec, n).astype(np.float32)


def make_patient_profile(rng: np.random.Generator) -> dict:
    """Per-patient/recording acoustic identity for the hard regime.

    Real ICBHI recordings differ systematically by patient and device
    (stethoscope location, recorder gain, ward noise, heart prominence);
    the official evaluation is patient-disjoint, so these factors are the
    distribution shift the training recipe (augmentation, weighting) exists
    to absorb. All cycles of one recording share a profile; the
    whole-recording dataset's positional split then yields patient-disjoint
    train/val automatically.
    """
    return {
        "gain_db": float(rng.uniform(-12.0, 0.0)),
        "snr_bias_db": float(rng.normal(0.0, 3.0)),
        "noise_exp": float(rng.uniform(0.35, 0.65)),
        "heart_p": float(rng.uniform(0.2, 0.9)),
        "heart_amp": float(rng.uniform(0.05, 0.30)),
        "hum_p": float(rng.choice([0.0, 0.8])),  # device either hums or not
        "hum_amp": float(rng.uniform(0.01, 0.08)),
        "intensity_scale": float(np.exp(rng.uniform(np.log(0.4), np.log(1.3)))),
    }


def _heart_sounds(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    """S1/S2 heart-sound pairs: ~30 ms low-frequency damped thumps at a
    0.9-1.4 Hz heart rate. Transient + wideband-ish at onset → a crackle
    confuser that appears in every class."""
    x = np.zeros(n, np.float32)
    period = int(sr / rng.uniform(0.9, 1.4))
    width = int(0.03 * sr)
    t = np.arange(width)
    first = int(rng.integers(0, period))
    for start in range(first, n - width - int(0.3 * period), period):
        for off, amp in ((0, 1.0), (int(0.3 * period), 0.6)):
            p = start + off
            f = rng.uniform(25, 45)
            thump = np.sin(2 * np.pi * f * t / sr) * np.exp(-t / (0.008 * sr))
            x[p : p + width] += amp * thump.astype(np.float32)
    return x


def _friction_rub(rng: np.random.Generator, x: np.ndarray, sr: int):
    """Pleural-rub-like transients: longer (15-40 ms) band-limited bursts.
    NOT crackles (different morphology) but close enough to confuse — added
    to some NORMAL clips so transient-ness alone cannot separate classes."""
    n = len(x)
    num = max(1, int(rng.poisson(1.5 * n / sr)))
    for _ in range(num):
        width = int(rng.integers(int(0.015 * sr), int(0.04 * sr)))
        pos = int(rng.integers(0, n - width))
        burst = rng.standard_normal(width + 32)
        kernel = np.hanning(33)
        kernel /= kernel.sum()
        burst = np.convolve(burst, kernel, mode="valid")[:width]
        burst *= np.hanning(width)
        x[pos : pos + width] += rng.uniform(0.1, 0.3) * burst.astype(np.float32)
    return x


def _snore_tone(rng: np.random.Generator, x: np.ndarray, sr: int):
    """Low-frequency (60-160 Hz) tonal artifact in NORMAL clips — overlaps the
    bottom of the wheeze f0 range so tonality alone cannot separate classes."""
    n = len(x)
    t = np.arange(n) / sr
    f0 = rng.uniform(60.0, 160.0)
    tone = np.sin(2 * np.pi * f0 * t) + 0.4 * np.sin(2 * np.pi * 2 * f0 * t)
    envelope = 0.5 + 0.5 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 2 * np.pi))
    x += rng.uniform(0.03, 0.12) * (tone * envelope).astype(np.float32)
    return x


def _add_crackles_hard(rng: np.random.Generator, x: np.ndarray, sr: int,
                       scale: float = 1.0, coverage: str = "sparse"):
    """Faint crackles whose amplitudes span a continuum that crosses the
    noise floor (the faint tail is genuinely undetectable -> irreducible
    class overlap).

    coverage="sparse": counts draw low, so some positive clips carry only
    2-3 events — a 35-frame time mask can delete the clip's only evidence.
    coverage="dense": counts draw high (crackle trains spanning the breath,
    how the ICBHI literature describes real coarse/fine crackle cycles), so
    evidence is temporally redundant — the regime where masking can
    regularize instead of destroying labels."""
    n = len(x)
    dur = n / sr
    rate = rng.uniform(12.0, 30.0) if coverage == "dense" else rng.uniform(1.0, 5.0)
    num = max(1, int(rng.poisson(rate * dur)))
    # per-clip intensity scale: some patients' crackles are simply fainter
    clip_scale = scale * float(np.exp(rng.uniform(np.log(0.25), np.log(1.0))))
    for _ in range(num):
        width = int(rng.integers(60, 160))
        pos = int(rng.integers(0, n - width))
        amp = clip_scale * rng.uniform(0.04, 0.35)
        burst = rng.standard_normal(width) * np.exp(-np.arange(width) / (width / 6.0))
        x[pos : pos + width] += amp * burst.astype(np.float32)
    return x


def _add_wheeze_hard(rng: np.random.Generator, x: np.ndarray, sr: int,
                     scale: float = 1.0, coverage: str = "sparse"):
    """Faint wheeze: amplitude continuum crossing the noise floor, f0
    log-uniform over 90-1000 Hz (overlapping both the breath band and the
    normal-clip snore artifact), gated to a contiguous portion of the cycle
    — a random 30-100% when coverage="sparse" (sometimes only a sliver
    survives a time mask), 70-100% when coverage="dense" (real ICBHI
    wheezes are sustained through most of the expiratory phase)."""
    n = len(x)
    t = np.arange(n) / sr
    f0 = float(np.exp(rng.uniform(np.log(90.0), np.log(1000.0))))
    vibrato = 1.0 + 0.02 * np.sin(2 * np.pi * rng.uniform(3.0, 6.0) * t)
    tone = np.sin(2 * np.pi * f0 * vibrato * t) + 0.3 * np.sin(2 * np.pi * 2 * f0 * t)
    frac = rng.uniform(0.7, 1.0) if coverage == "dense" else rng.uniform(0.3, 1.0)
    start = int(rng.uniform(0.0, 1.0 - frac) * n)
    gate = np.zeros(n, np.float32)
    width = max(1, int(frac * n))
    gate[start : start + width] = np.hanning(width).astype(np.float32)
    x += scale * rng.uniform(0.02, 0.25) * (tone * gate).astype(np.float32)
    return x


def synth_respiratory_cycle(
    rng: np.random.Generator,
    label: int,
    duration: float = 2.5,
    sample_rate: int = 16000,
    hard: bool = False,
    snr_db: tuple[float, float] = (-6.0, 12.0),
    profile: dict | None = None,
    coverage: str = "sparse",
) -> np.ndarray:
    """One synthetic breathing cycle of class label (0=normal 1=crackles
    2=wheezes 3=both), float32 in [-1, 1].

    hard=True switches to the non-separable regime (see module docstring);
    snr_db is the per-clip pink-noise SNR range it draws from; profile
    (make_patient_profile) pins the patient/device factors all cycles of one
    recording share; coverage ("sparse" | "dense") controls how much of the
    cycle the adventitious events span — "dense" matches how the ICBHI
    literature describes real cycles (crackle trains, sustained expiratory
    wheezes) and is the regime where masking augmentation has redundant
    evidence to regularize over.
    """
    n = int(duration * sample_rate)
    x = 0.3 * _breath_noise(rng, n, sample_rate)
    if not hard:
        if label in (1, 3):
            x = _add_crackles(rng, x, sample_rate)
        if label in (2, 3):
            x = _add_wheeze(rng, x, sample_rate)
    else:
        prof = profile or {}
        scale = float(prof.get("intensity_scale", 1.0))
        # Confusers first — present regardless of class.
        if rng.uniform() < prof.get("heart_p", 0.6):
            amp = prof.get("heart_amp", rng.uniform(0.05, 0.30))
            x += amp * _heart_sounds(rng, n, sample_rate)
        if rng.uniform() < prof.get("hum_p", 0.25):
            t = np.arange(n) / sample_rate
            hum_f = float(rng.choice([50.0, 60.0]))
            hum = np.sin(2 * np.pi * hum_f * t) + 0.5 * np.sin(2 * np.pi * 3 * hum_f * t)
            x += prof.get("hum_amp", rng.uniform(0.01, 0.08)) * hum.astype(np.float32)
        # Crackle-like and wheeze-like artifacts in clips WITHOUT that label:
        # transient-ness / tonality alone must not separate the classes.
        if label in (0, 2) and rng.uniform() < 0.25:
            x = _friction_rub(rng, x, sample_rate)
        if label in (0, 1) and rng.uniform() < 0.25:
            x = _snore_tone(rng, x, sample_rate)
        if label in (1, 3):
            x = _add_crackles_hard(rng, x, sample_rate, scale=scale, coverage=coverage)
        if label in (2, 3):
            x = _add_wheeze_hard(rng, x, sample_rate, scale=scale, coverage=coverage)
        # Pink background at a drawn SNR, then a record-gain roll (both
        # patient-pinned when a profile is given).
        snr = rng.uniform(*snr_db) + prof.get("snr_bias_db", 0.0)
        noise = _pink_noise(rng, n, exp=prof.get("noise_exp", 0.5))
        sig_rms = float(np.sqrt(np.mean(x**2))) + 1e-9
        noise_rms = float(np.sqrt(np.mean(noise**2))) + 1e-9
        x = x + noise * (sig_rms / noise_rms) * 10.0 ** (-snr / 20.0)
        x = x * 10.0 ** (prof.get("gain_db", rng.uniform(-12.0, 0.0)) / 20.0)
    peak = np.abs(x).max()
    if peak > 0.99:
        x = 0.99 * x / peak
    return x.astype(np.float32)


def generate_icbhi_dataset(
    root: str | Path,
    num_recordings: int = 24,
    cycles_per_recording: int = 4,
    sample_rate: int = 16000,
    seed: int = 0,
    hard: bool = False,
    class_probs: tuple[float, ...] | None = None,
    coverage: str = "sparse",
) -> Path:
    """Write a whole-recording layout dataset: root/audio_and_txt_files/
    {name}.wav + {name}.txt with tab-separated cycle annotations.

    hard=True uses the non-separable regime with a per-recording patient
    profile (make_patient_profile) — the recording's label is drawn from
    class_probs (default uniform) and its cycles are generated so their OR
    equals it (recording_label semantics, reference dataset.py:95-130); with
    the whole-recording dataset's positional split this yields
    patient-disjoint train/val, like the official ICBHI protocol. Without
    hard, class_probs skews the independent per-cycle label draw.
    """
    rng = np.random.default_rng(seed)
    audio_dir = Path(root) / "audio_and_txt_files"
    audio_dir.mkdir(parents=True, exist_ok=True)

    def draw_label():
        if class_probs is not None:
            return int(rng.choice(4, p=np.asarray(class_probs) / np.sum(class_probs)))
        return int(rng.integers(0, 4))

    for r in range(num_recordings):
        profile = make_patient_profile(rng) if hard else None
        if hard:
            rec_label = draw_label()
            labels = _cycle_labels_for_recording(rng, rec_label, cycles_per_recording)
        else:
            labels = [draw_label() for _ in range(cycles_per_recording)]
        cycles = []
        audio = []
        t0 = 0.0
        for label in labels:
            dur = float(rng.uniform(1.5, 3.0))
            audio.append(
                synth_respiratory_cycle(rng, label, dur, sample_rate, hard=hard,
                                        profile=profile, coverage=coverage)
            )
            crackle = 1 if label in (1, 3) else 0
            wheeze = 1 if label in (2, 3) else 0
            cycles.append((t0, t0 + dur, crackle, wheeze))
            t0 += dur
        wav = np.concatenate(audio)
        # Filenames follow the ICBHI convention: {patient}_{idx}_{chest}_{mode}_{device}
        name = f"{101 + r}_1b1_Al_sc_Synth"
        write_wav(audio_dir / f"{name}.wav", wav, sample_rate)
        lines = [f"{s:.3f}\t{e:.3f}\t{c}\t{w}" for s, e, c, w in cycles]
        (audio_dir / f"{name}.txt").write_text("\n".join(lines) + "\n")
    return Path(root)


def generate_segmented_dataset(
    root: str | Path,
    per_class: int = 8,
    duration: float = 2.5,
    sample_rate: int = 16000,
    seed: int = 0,
    hard: bool = False,
    class_counts: tuple[int, ...] | None = None,
    coverage: str = "sparse",
) -> Path:
    """Write the segmented per-class layout: root/{normal,crackle,wheeze,both}/*.wav.

    class_counts, when given, overrides per_class with explicit per-class
    sizes (use with ICBHI_CLASS_PROBS to mirror the real skew); hard=True
    uses the non-separable regime with per-clip duration jitter (±20%).
    """
    rng = np.random.default_rng(seed)
    root = Path(root)
    counts = class_counts if class_counts is not None else (per_class,) * len(SEGMENT_DIR_NAMES)
    for label, dirname in enumerate(SEGMENT_DIR_NAMES):
        d = root / dirname
        d.mkdir(parents=True, exist_ok=True)
        for i in range(counts[label]):
            dur = duration * float(rng.uniform(0.8, 1.2)) if hard else duration
            wav = synth_respiratory_cycle(rng, label, dur, sample_rate, hard=hard,
                                          coverage=coverage)
            write_wav(d / f"{101 + i}_1b1_Al_sc_Synth_seg{i:03d}_{dirname}.wav", wav, sample_rate)
    return root


def icbhi_class_counts(total: int) -> tuple[int, ...]:
    """Per-class counts mirroring the real ICBHI skew, summing to ~total."""
    return tuple(max(1, round(total * p)) for p in ICBHI_CLASS_PROBS)


# Equipment/location/mode vocabulary of the real ICBHI 2017 download
# (reference src/data/dataset.py:95-130 globs `audio_and_txt_files/*.wav`
# named {patient}_{rec_idx}_{chest}_{mode}_{device}.wav). AKGC417L recorded
# at 4 kHz, Litt3200 at 10 kHz (actually 4 kHz in the official set, 10 kHz
# kept here to exercise a second resample ratio), Meditron/LittC2SE at
# 44.1 kHz — the mixed native rates the loader must resample.
_CORPUS_DEVICES = (
    ("AKGC417L", 4000),
    ("Litt3200", 10000),
    ("Meditron", 44100),
    ("LittC2SE", 44100),
)
_CHEST_LOCATIONS = ("Al", "Ar", "Pl", "Pr", "Ll", "Lr", "Tc")
_ACQ_MODES = ("sc", "mc")


def generate_icbhi_corpus_fixture(
    root: str | Path,
    num_recordings: int = 12,
    cycles_per_recording: int = 4,
    seed: int = 0,
) -> Path:
    """A fixture shaped like the REAL ICBHI 2017 download — deliberately
    messier than generate_icbhi_dataset's clean synthetic layout — for
    rehearsing the full --data path before the real corpus is available:

    - mixed NATIVE sample rates per device (4 kHz / 10 kHz / 44.1 kHz),
      exercising wavio.resample_np in the loaders and the segmenter;
    - real filename grammar {patient}_{rec_idx}_{chest}_{mode}_{device}
      with varying recording indices (1b1, 2p3, ...) across the device/
      location/mode vocabulary;
    - annotation edge cases found in the real files: CRLF line endings,
      trailing whitespace and trailing tabs, float fields written with
      varying precision, a zero-length cycle (start == end), a stray
      header/comment line, and a file without a trailing newline.

    Labels stay patient-consistent (cycle OR == recording label) so the
    positional split remains patient-disjoint, like the official protocol.
    """
    rng = np.random.default_rng(seed)
    audio_dir = Path(root) / "audio_and_txt_files"
    audio_dir.mkdir(parents=True, exist_ok=True)

    for r in range(num_recordings):
        device, native_sr = _CORPUS_DEVICES[r % len(_CORPUS_DEVICES)]
        chest = _CHEST_LOCATIONS[r % len(_CHEST_LOCATIONS)]
        mode = _ACQ_MODES[r % len(_ACQ_MODES)]
        rec_idx = f"{1 + r % 3}{'bp'[r % 2]}{1 + r % 4}"
        name = f"{101 + r}_{rec_idx}_{chest}_{mode}_{device}"

        rec_label = int(rng.integers(0, 4))
        labels = _cycle_labels_for_recording(rng, rec_label, cycles_per_recording)
        profile = make_patient_profile(rng)
        audio, cycles, t0 = [], [], 0.0
        for label in labels:
            dur = float(rng.uniform(1.2, 3.5))
            audio.append(
                synth_respiratory_cycle(rng, label, dur, native_sr, hard=True,
                                        profile=profile)
            )
            cycles.append((t0, t0 + dur,
                           1 if label in (1, 3) else 0,
                           1 if label in (2, 3) else 0))
            t0 += dur
        write_wav(audio_dir / f"{name}.wav", np.concatenate(audio), native_sr)

        # annotation text with real-download grit, varying by recording
        lines = []
        if r % 5 == 0:
            lines.append("Start\tEnd\tCrackles\tWheezes")  # stray header
        for i, (s, e, c, w) in enumerate(cycles):
            prec = (2, 3, 4)[i % 3]
            row = f"{s:.{prec}f}\t{e:.{prec}f}\t{c}\t{w}"
            if i % 3 == 1:
                row += "\t"      # trailing tab (extra empty field)
            if i % 4 == 2:
                row += "   "     # trailing spaces
            lines.append(row)
        if r % 4 == 1:
            # zero-length cycle (start == end): real files contain these;
            # the segmenter must skip it via min_duration, not crash
            t = cycles[-1][1]
            lines.append(f"{t:.3f}\t{t:.3f}\t0\t0")
        eol = "\r\n" if r % 2 == 0 else "\n"  # CRLF half the time
        text = eol.join(lines)
        if r % 3 != 2:
            text += eol  # some files end without a newline
        (audio_dir / f"{name}.txt").write_bytes(text.encode())
    return Path(root)


def _cycle_labels_for_recording(rng, rec_label: int, k: int) -> list[int]:
    """k cycle labels whose OR (crackle, wheeze flags) equals rec_label."""
    if rec_label == 0:
        return [0] * k
    if rec_label in (1, 2):
        labs = [rec_label if rng.uniform() < 0.6 else 0 for _ in range(k)]
        labs[int(rng.integers(0, k))] = rec_label
        return labs
    labs = [int(rng.choice([0, 1, 2, 3], p=[0.2, 0.3, 0.3, 0.2])) for _ in range(k)]
    if not any(l in (1, 3) for l in labs):
        labs[int(rng.integers(0, k))] = 1
    if not any(l in (2, 3) for l in labs):
        candidates = [i for i, l in enumerate(labs) if l not in (1, 3)]
        i = int(rng.choice(candidates)) if candidates else int(rng.integers(0, k))
        labs[i] = 3 if labs[i] in (1, 3) else 2
    return labs
