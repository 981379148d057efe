"""The harness on the CPU: discovery by name, the result line, what a run
loads, and the yardstick's counts."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import counts, run
from port_bench.reference import cnn, resnet

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "port_bench"
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 77  # above 32 signed bits


def test_cells_found_by_name():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in CELLS:
        spec = run.cell(manifest, name)
        assert (BENCH / "loops" / f"{spec.traffic['kind']}.py").exists()
        assert set(spec.limits)
        for m in spec.per_layer:
            assert callable(run.reader(m["name"]))


def test_new_config_mix_and_metric_are_files_alone(tmp_path, small):
    """A configuration, a traffic mix and a per-layer metric added as new
    files, with entries in BENCHMARK.json, run with no edit to any file
    that was there."""
    shutil.copytree(BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns("tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "lwcnn-icbhi8s.json").read_text())
    cfg["config"]["model"]["dropout"] = 0.1
    (tmp_path / "port_bench" / "configs" / "lwcnn-drop01.json").write_text(json.dumps(cfg))
    (tmp_path / "port_bench" / "traffic" / "few-recordings.json").write_text(
        json.dumps({"kind": "train_epochs", "recordings": 40, "calibration_clips": 8}))
    (tmp_path / "port_bench" / "metrics" / "epochs_run.py").write_text(
        "def read(run, outcome):\n    return outcome.info['epochs']\n")
    (tmp_path / "port_bench" / "checks" / "lwcnn-few.json").write_text(
        (BENCH / "checks" / "lwcnn-train-epochs.json").read_text())
    manifest["configs"].append({"name": "lwcnn-drop01", "source": "x",
                                "file": "port_bench/configs/lwcnn-drop01.json", "reduced": [],
                                "why": "x"})
    manifest["workloads"].append({"name": "lwcnn-few", "config": "lwcnn-drop01",
                                  "traffic": "few-recordings", "chips": 1, "why": "x"})
    manifest["per_layer"].append({"name": "epochs_run", "unit": "epochs", "better": "higher",
                                  "source": "program_counter", "layer": "Fused epoch",
                                  "moves": "train_clips_per_s", "workloads": ["lwcnn-few"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    over = {"config": small["config"], "traffic": {"calibration_clips": 8}}
    line = run.execute("lwcnn-few", SEED, 0.5, True, device="cpu", root=tmp_path, overrides=over)
    assert line["metrics"]["epochs_run"]["value"] >= 1
    assert line["correct"], line["checks"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(small, trace):
    line = run.execute(CELLS[0], SEED, 0.3, trace, device="cpu", overrides=small)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and set(keys) <= {*keys[:5], "breakdown", "checks"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert (("busy_s" in line["device"]) and ("window_s" in line["device"])) == trace
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0
    json.dumps(line)


def test_no_card_no_result():
    """Without a CUDA device the runner exits non-zero and prints no line."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    res = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""


FORBIDDEN = {"jax", "jaxlib", "flax", "audio_classification_icbhi_tpu"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    """No harness source imports jax, jaxlib, flax or the JAX package,
    top-level names compared whole (the port's name begins with the JAX
    package's); nothing under reference/ imports the port."""
    for path in BENCH.rglob("*.py"):
        top = _imports(path)
        assert not top & FORBIDDEN, (path, top & FORBIDDEN)
        if "reference" in path.parts:
            assert "audio_classification_icbhi_tpu_torch" not in top, path


def _modules_after(code: str) -> set[str]:
    res = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(small):
    """A whole run (set-up, window, reference) in a fresh process leaves no
    module of those names loaded."""
    mods = _modules_after(
        "import sys; sys.path.insert(0, '.')\nfrom port_bench import run\n"
        f"run.execute('lwcnn-train-epochs', {SEED}, 0.3, False, device='cpu', "
        f"overrides={small!r})\n"
        "assert not run.forbidden_modules(), run.forbidden_modules()")
    assert not mods & FORBIDDEN
    assert "audio_classification_icbhi_tpu_torch" in mods


def test_reference_loads_nothing_of_the_port():
    mods = _modules_after(
        "import sys; sys.path.insert(0, '.')\n"
        "import port_bench.reference.readings, port_bench.reference.cnn, "
        "port_bench.reference.resnet, port_bench.compare, port_bench.corpus")
    assert not mods & (FORBIDDEN | {"audio_classification_icbhi_tpu_torch"})


def test_lightweight_cnn_flops():
    """1.04 GFLOP a 128 x 251 clip, by hand: 2 · h · w · cin · cout · 9 a
    block at halving sizes, plus the head."""
    hand = 2 * 9 * (128 * 251 * 1 * 32 + 64 * 125 * 32 * 64 + 32 * 62 * 64 * 128
                    + 16 * 31 * 128 * 256 + 8 * 15 * 256 * 256) + 2 * (256 * 128 + 128 * 4)
    assert hand == 1_040_147_456
    assert cnn.forward_gflop(128, 251) == pytest.approx(hand / 1e9, rel=1e-12)
    assert round(cnn.forward_gflop(128, 251), 2) == 1.04
    assert counts.train_gflop(1.0, 0.25) == 2.75


def test_resnet_flops_match_the_chip_smoke_figure():
    """1.416 GFLOP at 128 x 157 (PERF.md's ResNet row), 2.256 at 251."""
    assert resnet.forward_gflop(128, 157) == pytest.approx(1.416095744, rel=1e-9)
    assert resnet.forward_gflop(128, 251) == pytest.approx(2.255996928, rel=1e-9)


def test_log_mel_bound_at_32_clips():
    """32 x 128,000 at 2048 / 512 / 128 mels: 251 frames a clip."""
    frames = 32 * 251
    # bins strictly inside each triangle: every bin inside (f_0, f_129) lies
    # on two triangles, but those in the first and last gaps on one
    sr, n_fft = 16000, 2048
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel = np.linspace(0, 2595 * np.log10(1 + sr / 2 / 700), 130)
    pts = 700 * (10 ** (mel / 2595) - 1)
    inside = (freqs > pts[0]) & (freqs < pts[-1])
    nnz = 2 * inside.sum() - ((freqs > pts[0]) & (freqs < pts[1])).sum() \
        - ((freqs > pts[-2]) & (freqs < pts[-1])).sum()
    assert nnz == counts.mel_nnz(sr, n_fft, 128) == 2025
    ops = frames / 2 * 5 * 2048 * 11 + frames * (3 * 1025 + 2 * 2025) + 5 * frames * 128
    bytes_ = 4 * 32 * 128_000 + 4 * 32 * 128 * 251
    assert ops == 514_730_720 and bytes_ == 20_496_384
    bound = counts.log_mel_bound_s(32, 128_000, sr, n_fft, 512, 128)
    assert bound["operations"] == pytest.approx(ops / 67e12, rel=1e-12)
    assert bound["bytes"] == pytest.approx(bytes_ / 3.35e12, rel=1e-12)
