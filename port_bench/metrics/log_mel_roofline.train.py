"""Percent of its least time that the masked front-end call of the train
step (`features_from_wavs(..., augment=True)` at A · B rows, the waveform
augmentation included) reaches, by CUDA events over 20 calls replayed as a
CUDA graph, as the fused step runs it; the least time is the log-mel
function's (`counts.log_mel_bound_s`)."""

from port_bench.counts import log_mel_share


def read(run, outcome):
    p = outcome.probes
    if "front_end_ms" not in p:
        return None
    return log_mel_share(outcome.info["config"], p["front_end_rows"], p["front_end_ms"])
