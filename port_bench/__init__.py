"""The benchmark of the PyTorch and CUDA port, `audio_classification_icbhi_tpu_torch`.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the checkout's root names the cells. Everything a cell
needs is found by name under this folder: its configuration in
`configs/<config>.json`, its traffic mix in `traffic/<traffic>.json` (whose
`kind` names the loop in `loops/<kind>.py`), the limits of its
correctness check in `checks/<workload>.json`, and each per-layer metric's
reader in `metrics/<metric>.py`. The plain reference that decides `correct`
lives in `reference/` and imports nothing of the port.

A new model architecture is a file too: `reference/<architecture>.py` with
`Model(num_classes, dropout, precision)` and `forward(x, train, g)` on
(B, 1, n_mels, T) images, `forward_gflop(h, w, classes)` and
`first_layer_gflop(h, w)`, the output layer as the last 2-D parameter, and
its layers as `nn.Conv2d`, `nn.Linear`, `nn.BatchNorm2d` or `nn.LayerNorm`
modules, by which the seeded weights are drawn (`reference/__init__.py`
states the rules). A model with no BatchNorm has no statistics numbers.
"""
