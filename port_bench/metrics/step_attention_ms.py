"""Device ms of the replayed train step's attention calls, forward and
backward, summed over its layers and microbatches, between the program's
marks around the attention kernels in the graph, the median over the
epochs' last replays (`step.attention`); nothing where the program records
none."""

import importlib
import statistics


def read(run, outcome):
    try:
        tracing = importlib.import_module("audio_classification_icbhi_tpu_torch.tracing")
    except ImportError:
        return None
    s = tracing.stat("step.attention")
    return statistics.median(s.ring) if s is not None and s.ring else None
