"""The analyzers' pictures: the 3-panel view, the coloured timeline and the
spectrogram overlay.

Port of `audio_classification_icbhi_tpu/analyzers/viz.py:25-213`, panel for
panel:
- `three_panel`: the waveform, the detections as vertical lines with the
  thresholds, the confidence timeline (the realtime and parallel
  variants);
- `timeline`: the waveform over coloured blocks (normal light grey, wheeze
  green, crackle purple, both red) with a summary box (the timeline
  variant);
- `spectrogram`: the timeline view with the whole recording's mel panel
  between, in librosa's convention (slaney mels and norm, power_to_db
  against the maximum), with the detections shaded (the spec variant).
  `spectrogram_db` computes that panel with the port's
  `ops/mel.log_mel_spectrogram` on the engine's device.

matplotlib is imported inside each drawing function
(`utils/plotting.pyplot`), so importing this module, and `COLORS`, never
needs it: the machine with the card has none.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch.ops import mel as mel_ops
from audio_classification_icbhi_tpu_torch.utils.plotting import pyplot

COLORS = {
    "normal": "#F5F5F5",
    "wheeze": "#22C55E",
    "crackle": "#9333EA",
    "both": "#EF4444",
}


def detection_label(r) -> str:
    """A window's COLORS key."""
    if r.has_crackle and r.has_wheeze:
        return "both"
    if r.has_crackle:
        return "crackle"
    if r.has_wheeze:
        return "wheeze"
    return "normal"


def _finish(plt, fig, save_path, show):
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight", facecolor="white")
        print(f"\n✓ Visualization saved to: {save_path}")
    if show:
        plt.show()
    plt.close(fig)


def _plot_waveform(ax, audio, sample_rate, title="Audio Waveform"):
    duration = len(audio) / sample_rate
    t = np.linspace(0, duration, len(audio))
    ax.plot(t, audio, color="gray", linewidth=0.5, alpha=0.7)
    ax.set_ylabel("Amplitude", fontsize=12)
    ax.set_title(title, fontsize=14, fontweight="bold")
    ax.grid(True, alpha=0.3)
    ax.set_xlim([0, duration])
    return duration


def three_panel(results, audio, sample_rate, crackle_threshold=None, wheeze_threshold=None,
                save_path=None, show=False):
    plt = pyplot()
    fig, axes = plt.subplots(3, 1, figsize=(16, 10))
    duration = _plot_waveform(axes[0], audio, sample_rate)

    ax2 = axes[1]
    seen = set()  # label the first drawn line of each kind
    for r in results:
        mid = (r.start_time + r.end_time) / 2
        if r.has_crackle:
            ax2.vlines(mid, 0, min(r.crackle_confidence, 1.0), colors="purple",
                       linewidth=4, alpha=0.7, label="" if "c" in seen else "Crackle")
            seen.add("c")
        if r.has_wheeze:
            ax2.vlines(mid, 0, min(r.wheeze_confidence, 1.0), colors="green",
                       linewidth=4, alpha=0.7, label="" if "w" in seen else "Wheeze")
            seen.add("w")
    if crackle_threshold is not None:
        ax2.axhline(y=crackle_threshold, color="purple", linestyle="--", linewidth=2,
                    alpha=0.5, label=f"Crackle Threshold ({crackle_threshold:.2f})")
    if wheeze_threshold is not None:
        ax2.axhline(y=wheeze_threshold, color="green", linestyle="--", linewidth=2,
                    alpha=0.5, label=f"Wheeze Threshold ({wheeze_threshold:.2f})")
    ax2.set_ylabel("Confidence", fontsize=12)
    ax2.set_title("Respiratory Sound Detection (Purple=Crackles, Green=Wheezes)",
                  fontsize=14, fontweight="bold")
    ax2.set_ylim([0, 1.0])
    ax2.set_xlim([0, duration])
    ax2.grid(True, alpha=0.3)
    if ax2.get_legend_handles_labels()[1]:  # no detections, no legend
        ax2.legend(loc="upper right", fontsize=9)

    ax3 = axes[2]
    times = [(r.start_time + r.end_time) / 2 for r in results]
    cc = [min(r.crackle_confidence, 1.0) for r in results]
    wc = [min(r.wheeze_confidence, 1.0) for r in results]
    ax3.plot(times, cc, color="purple", linewidth=2, marker="o", markersize=5,
             label="Crackles", alpha=0.8)
    ax3.plot(times, wc, color="green", linewidth=2, marker="o", markersize=5,
             label="Wheezes", alpha=0.8)
    ax3.fill_between(times, cc, alpha=0.2, color="purple")
    ax3.fill_between(times, wc, alpha=0.2, color="green")
    if crackle_threshold is not None:
        ax3.axhline(y=crackle_threshold, color="purple", linestyle="--", linewidth=1, alpha=0.5)
    if wheeze_threshold is not None:
        ax3.axhline(y=wheeze_threshold, color="green", linestyle="--", linewidth=1, alpha=0.5)
    ax3.set_xlabel("Time (seconds)", fontsize=12)
    ax3.set_ylabel("Confidence", fontsize=12)
    ax3.set_title("Confidence Timeline", fontsize=14, fontweight="bold")
    ax3.set_ylim([0, 1.0])
    ax3.set_xlim([0, duration])
    ax3.grid(True, alpha=0.3)
    ax3.legend(loc="upper right", fontsize=10)
    fig.tight_layout()
    _finish(plt, fig, save_path, show)


def _draw_timeline_axis(ax, results, duration):
    from matplotlib.patches import Patch, Rectangle

    ax.set_xlim([0, duration])
    ax.set_ylim([0, 1])
    for r in results:
        ax.add_patch(Rectangle((r.start_time, 0), r.end_time - r.start_time, 1,
                               facecolor=COLORS[detection_label(r)], edgecolor="#1E293B",
                               linewidth=1.5, alpha=0.9))
    ax.set_xlabel("Time (seconds)", fontsize=12, fontweight="bold")
    ax.set_yticks([])
    ax.set_title("Respiratory Sound Detection Timeline", fontsize=14, fontweight="bold", pad=15)
    ax.grid(True, axis="x", alpha=0.3, linestyle="--", linewidth=0.8)
    legend = [Patch(facecolor=COLORS[k], edgecolor="#1E293B", label=k.capitalize(),
                    linewidth=1.5)
              for k in ("normal", "wheeze", "crackle", "both")]
    ax.legend(handles=legend, loc="upper right", fontsize=11, framealpha=0.95,
              edgecolor="#1E293B", title="Detection Type", title_fontsize=11)
    total = max(len(results), 1)
    counts = {k: sum(1 for r in results if detection_label(r) == k) for k in COLORS}
    stats = (
        f"Summary: {len(results)} segments\n"
        f"Normal: {counts['normal']} ({100 * counts['normal'] / total:.0f}%) | "
        f"Wheeze: {counts['wheeze']} ({100 * counts['wheeze'] / total:.0f}%) | "
        f"Crackle: {counts['crackle']} ({100 * counts['crackle'] / total:.0f}%) | "
        f"Both: {counts['both']} ({100 * counts['both'] / total:.0f}%)"
    )
    ax.text(0.02, 0.98, stats, transform=ax.transAxes, fontsize=10,
            verticalalignment="top", family="monospace",
            bbox=dict(boxstyle="round", facecolor="white", alpha=0.9, edgecolor="#1E293B"))


def timeline(results, audio, sample_rate, save_path=None, show=False):
    plt = pyplot()
    fig, axes = plt.subplots(2, 1, figsize=(18, 8), gridspec_kw={"height_ratios": [1, 2]})
    duration = _plot_waveform(axes[0], audio, sample_rate)
    axes[0].set_xticklabels([])
    _draw_timeline_axis(axes[1], results, duration)
    fig.tight_layout()
    _finish(plt, fig, save_path, show)


def spectrogram_db(audio, sample_rate, n_fft=2048, hop_length=512, n_mels=128,
                   device: str | torch.device = "cpu") -> np.ndarray:
    """The spectrogram panel: (n_mels, T) dB over the whole recording, slaney
    mels and norm, power_to_db against the maximum (top_db 80), computed on
    `device` in f32."""
    wav = torch.as_tensor(np.asarray(audio, np.float32), device=device)
    with torch.inference_mode():
        mel_db = mel_ops.log_mel_spectrogram(wav, sample_rate, n_fft, hop_length, n_mels,
                                             mel_scale="slaney", norm="slaney",
                                             to_db="power_max")
    return mel_db.cpu().numpy()


def spectrogram(results, audio, sample_rate, save_path=None, show=False, n_fft=2048,
                hop_length=512, n_mels=128, device: str | torch.device = "cpu"):
    """The timeline view with the whole recording's mel panel between
    (`spectrogram_db` on `device`)."""
    plt = pyplot()
    fig, axes = plt.subplots(3, 1, figsize=(18, 12), gridspec_kw={"height_ratios": [1, 1.4, 1]})
    duration = _plot_waveform(axes[0], audio, sample_rate)
    axes[0].set_xticklabels([])

    mel_db = spectrogram_db(audio, sample_rate, n_fft, hop_length, n_mels, device)
    ax_spec = axes[1]
    img = ax_spec.imshow(mel_db, aspect="auto", origin="lower", cmap="viridis",
                         extent=[0, duration, 0, sample_rate / 2])
    fig.colorbar(img, ax=ax_spec, format="%+2.0f dB").set_label(
        "Intensity (dB)", fontsize=10, fontweight="bold")
    ax_spec.set_ylabel("Frequency (Hz, mel-spaced)", fontsize=11)
    ax_spec.set_title("Mel Spectrogram with Detections", fontsize=13, fontweight="bold")
    for r in results:
        label = detection_label(r)
        if label != "normal":
            ax_spec.axvspan(r.start_time, r.end_time, color=COLORS[label], alpha=0.3, zorder=10)

    _draw_timeline_axis(axes[2], results, duration)
    fig.tight_layout()
    _finish(plt, fig, save_path, show)
