"""The interactive viewer: a recording's waveform over its coloured detection
timeline, a cursor, and playback.

    python -m audio_classification_icbhi_tpu_torch.interactive --audio rec.wav --model m.ckpt
        [--segment-duration 1.0] [--overlap 0.5] [--device cuda|cpu]

Port of the repository's `interactive_analyzer.py:23-268`: a 1600 x 900
pygame window, SPACE play / pause, R restart, ESC exit; the cursor advances
by each frame's measured time. The analysis runs first, on
`AnalyzerEngine(mode="legacy")` (the JAX script's `BatchAudioAnalyzer`),
on `--device` (cuda by default; it raises where there is no GPU).
`Playback` probes sounddevice, then pygame.mixer, then plays nothing, so
the viewer runs without a sound device.

pygame and sounddevice are imported only when the viewer starts: the
machine with the card has neither. With SDL's dummy drivers
(SDL_VIDEODRIVER=dummy, SDL_AUDIODRIVER=dummy) the viewer runs headless;
ICBHI_UI_AUTOEXIT=N closes it after N frames.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from audio_classification_icbhi_tpu_torch.analyzers import AnalyzerEngine
from audio_classification_icbhi_tpu_torch.analyzers.viz import COLORS, detection_label


class Playback:
    """Seekable one-shot playback of a mono float32 waveform. `backend` is
    the first that works of sounddevice, pygame.mixer and "none"
    (silent)."""

    def __init__(self, audio: np.ndarray, sample_rate: int, pygame=None):
        self.audio = np.asarray(audio, dtype=np.float32)
        self.sample_rate = sample_rate
        self.backend = "none"
        self._sd = None
        self._pg = None
        self._sound = None
        self._mixer_channels = 1
        try:
            import sounddevice as sd

            sd.check_output_settings(samplerate=sample_rate, channels=1)
            self._sd = sd
            self.backend = "sounddevice"
            return
        except Exception:  # no sounddevice, or no output device: try the next
            pass
        try:
            if pygame is None:
                import pygame
            pygame.mixer.init(frequency=sample_rate, channels=1)
            # the mixer may come up stereo whatever was asked
            self._mixer_channels = (pygame.mixer.get_init() or (0, 0, 1))[2]
            self._pg = pygame
            self.backend = "pygame.mixer"
        except Exception as e:  # the viewer runs silent
            print(f"(audio playback unavailable: {e})")

    def _pcm(self, samples: np.ndarray) -> np.ndarray:
        pcm = (np.clip(samples, -1, 1) * 32767).astype(np.int16)
        if self._mixer_channels > 1:
            pcm = np.repeat(pcm[:, None], self._mixer_channels, axis=1)
        return np.ascontiguousarray(pcm)

    def play_from(self, t: float) -> None:
        start = int(t * self.sample_rate)
        if start >= len(self.audio):
            return
        if self._sd is not None:
            self._sd.play(self.audio[start:], self.sample_rate)  # replaces any stream
        elif self._pg is not None:
            self._pg.mixer.stop()
            self._sound = self._pg.sndarray.make_sound(self._pcm(self.audio[start:]))
            self._sound.play()

    def stop(self) -> None:
        if self._sd is not None:
            self._sd.stop()
        elif self._pg is not None:
            self._pg.mixer.stop()


class InteractiveAudioVisualizer:
    WIDTH, HEIGHT = 1600, 900

    def __init__(self, audio_path, results, audio, sample_rate):
        import pygame

        self.pygame = pygame
        pygame.init()
        self.screen = pygame.display.set_mode((self.WIDTH, self.HEIGHT))
        pygame.display.set_caption("Interactive Respiratory Sound Analyzer")
        self.font = pygame.font.SysFont("monospace", 22)
        self.big_font = pygame.font.SysFont("monospace", 30, bold=True)

        self.audio_path = audio_path
        self.results = results
        self.audio = np.asarray(audio, dtype=np.float32)
        self.sample_rate = sample_rate
        self.duration = len(audio) / sample_rate
        self.current_time = 0.0
        self.playing = False

        self.bg_color = (18, 23, 33)
        self.wave_color = (100, 116, 139)
        self.cursor_color = (255, 255, 255)
        self._colors_rgb = {
            k: tuple(int(v[i : i + 2], 16) for i in (1, 3, 5)) for k, v in COLORS.items()
        }

        self.playback = Playback(self.audio, sample_rate, pygame)
        if self.playback.backend != "none":
            print(f"(audio playback: {self.playback.backend})")
        self.frames_drawn = 0

        # the waveform's polyline, one sample a pixel
        idx = np.linspace(0, len(self.audio) - 1, self.WIDTH - 100).astype(int)
        self.wave_px = self.audio[idx]

    def draw_timeline(self):
        pg = self.pygame
        x0, w = 50, self.WIDTH - 100
        wy, wh = 120, 300  # the waveform band
        mid = wy + wh // 2
        amp = np.abs(self.wave_px).max() or 1.0
        pts = [(x0 + i, mid - int(v / amp * (wh // 2 - 10))) for i, v in enumerate(self.wave_px)]
        if len(pts) > 1:
            pg.draw.lines(self.screen, self.wave_color, False, pts, 1)
        ty, th = 500, 140  # the detection blocks
        for r in self.results:
            rx = x0 + int(r.start_time / self.duration * w)
            rw = max(int((r.end_time - r.start_time) / self.duration * w), 2)
            pg.draw.rect(self.screen, self._colors_rgb[detection_label(r)], (rx, ty, rw, th))
            pg.draw.rect(self.screen, (30, 41, 59), (rx, ty, rw, th), 1)
        cx = x0 + int(self.current_time / self.duration * w)  # the cursor across both
        pg.draw.line(self.screen, self.cursor_color, (cx, wy), (cx, ty + th), 2)

    def draw_info(self):
        title = self.big_font.render(
            f"t = {self.current_time:6.2f}s / {self.duration:.2f}s"
            f"   [{'PLAYING' if self.playing else 'PAUSED'}]",
            True, (226, 232, 240),
        )
        self.screen.blit(title, (50, 40))
        y = 680
        r = self.get_current_result()
        if r is not None:
            lines = [
                f"segment {r.start_time:.2f}-{r.end_time:.2f}s  class={r.predicted_class}",
                f"crackle: {'YES' if r.has_crackle else 'no '}  "
                f"conf={min(r.crackle_confidence, 1):.2f}",
                f"wheeze:  {'YES' if r.has_wheeze else 'no '}  "
                f"conf={min(r.wheeze_confidence, 1):.2f}",
            ]
            cols = [(226, 232, 240), self._colors_rgb["crackle"], self._colors_rgb["wheeze"]]
            for line, col in zip(lines, cols):
                self.screen.blit(self.font.render(line, True, col), (50, y))
                y += 32
        self.screen.blit(
            self.font.render("SPACE play/pause   R restart   ESC exit", True, (148, 163, 184)),
            (50, self.HEIGHT - 50),
        )

    def get_current_result(self):
        for r in self.results:
            if r.start_time <= self.current_time <= r.end_time:
                return r
        return None

    def run(self):
        pg = self.pygame
        clock = pg.time.Clock()
        # ICBHI_UI_AUTOEXIT=N: close after N frames (dummy drivers have no
        # one to press ESC); 0 or unset runs until the user quits
        auto_exit = int(os.environ.get("ICBHI_UI_AUTOEXIT", "0") or 0)
        running = True
        while running:
            for event in pg.event.get():
                if event.type == pg.QUIT:
                    running = False
                elif event.type == pg.KEYDOWN:
                    if event.key == pg.K_SPACE:
                        self.playing = not self.playing
                        if self.playing:
                            self.playback.play_from(self.current_time)
                        else:
                            self.playback.stop()
                    elif event.key == pg.K_r:
                        self.current_time = 0.0
                        self.playing = False
                        self.playback.stop()
                    elif event.key == pg.K_ESCAPE:
                        running = False
            self.screen.fill(self.bg_color)
            self.draw_timeline()
            self.draw_info()
            pg.display.flip()
            self.frames_drawn += 1
            if auto_exit and self.frames_drawn >= auto_exit:
                print(f"UI auto-exit after {self.frames_drawn} frames")
                running = False
            # advance by the frame's measured time, so the cursor keeps pace
            # with the audio when frames come slower than 60 a second
            elapsed_ms = clock.tick(60)
            if self.playing:
                self.current_time += elapsed_ms / 1000.0
                if self.current_time >= self.duration:
                    self.current_time = 0.0
                    self.playing = False
                    self.playback.stop()
        self.playback.stop()
        pg.quit()


def main(argv=None) -> InteractiveAudioVisualizer:
    """Analyze, then run the viewer until it closes; returns the viewer."""
    parser = argparse.ArgumentParser(description="Interactive respiratory sound analyzer")
    parser.add_argument("--audio", type=str, required=True, help="Path to audio file")
    parser.add_argument("--model", type=str, required=True, help="Path to model checkpoint")
    parser.add_argument("--segment-duration", type=float, default=1.0)
    parser.add_argument("--overlap", type=float, default=0.5)
    parser.add_argument("--device", type=str, choices=["cuda", "cpu"], default="cuda",
                        help="Device the analysis runs on (default: cuda)")
    args = parser.parse_args(argv)

    print("Analyzing audio...")
    analyzer = AnalyzerEngine(args.model, segment_duration=args.segment_duration,
                              overlap=args.overlap, sample_rate=16000, mode="legacy",
                              device=args.device)
    results, audio = analyzer.analyze_audio(args.audio)
    analyzer.print_summary(results)

    print("\nLaunching interactive visualizer...")
    print("Controls:\n  SPACE: Play/Pause\n  R: Restart\n  ESC: Exit")
    viewer = InteractiveAudioVisualizer(audio_path=args.audio, results=results, audio=audio,
                                        sample_rate=analyzer.sample_rate)
    viewer.run()
    return viewer


if __name__ == "__main__":
    main()
