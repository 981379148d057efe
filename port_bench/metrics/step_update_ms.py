"""Device ms of the replayed train step's update (the gradient reduce, the
clip, the optimizer's step), between the program's marks in the graph, the
median over the epochs' last replays (`step.update`); nothing where the
program records none."""

import importlib
import statistics


def read(run, outcome):
    try:
        tracing = importlib.import_module("audio_classification_icbhi_tpu_torch.tracing")
    except ImportError:
        return None
    s = tracing.stat("step.update")
    return statistics.median(s.ring) if s is not None and s.ring else None
