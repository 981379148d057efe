"""Percent of the card's dense peak at the config's precision that the
window's model work reaches: each train clip 3 forwards less the first
layer's input gradient, each validation clip one forward (padding rows
not counted), over the window's host seconds."""

from port_bench.counts import model_gflop, peak_flops


def read(run, outcome):
    cfg, info = outcome.info["config"], outcome.info
    fwd, train = model_gflop(cfg)
    flops = 1e9 * (info["train_clips"] * train + info["val_clips"] * fwd)
    return 100.0 * flops / info["window_s"] / peak_flops(cfg)
