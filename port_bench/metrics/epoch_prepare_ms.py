"""Host ms of a fused epoch's set-up, from `set_epoch` to its first replay:
the program's span `fused_epoch.prepare` (the rate, index batches and
labels) and the `train_many.upload` that follows it (the rows' upload,
the rate's buffer, the graph's lookup), the median over the epochs of
their sum; nothing where the program lacks either span. Epoch 0 calls
`train_many` outside the Trainer, so the two are paired from the last."""

import importlib
import statistics


def read(run, outcome):
    try:
        tracing = importlib.import_module("audio_classification_icbhi_tpu_torch.tracing")
    except ImportError:
        return None
    prep, up = tracing.stat("fused_epoch.prepare"), tracing.stat("train_many.upload")
    if prep is None or up is None:
        return None
    return statistics.median(a + b for a, b in zip(reversed(prep.ring), reversed(up.ring)))
