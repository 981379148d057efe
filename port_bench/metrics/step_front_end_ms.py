"""Device ms of the replayed train step's input and front end (the cache
gather, dequantize, the augmentation's draws, the masked log-mel), between
the program's marks in the graph, the median over the epochs' last replays
(`step.front_end`); nothing where the program records none."""

import importlib
import statistics


def read(run, outcome):
    try:
        tracing = importlib.import_module("audio_classification_icbhi_tpu_torch.tracing")
    except ImportError:
        return None
    s = tracing.stat("step.front_end")
    return statistics.median(s.ring) if s is not None and s.ring else None
