"""Host ms of fused validation's set-up up to its first eval-group replay:
the program's span `fused_val.prepare` (index and mask batches) and the
`eval_many.upload` that follows it (the rows' upload, the graph's
lookup), the median over the validations of their sum; nothing where the
program lacks either span."""

import importlib
import statistics


def read(run, outcome):
    try:
        tracing = importlib.import_module("audio_classification_icbhi_tpu_torch.tracing")
    except ImportError:
        return None
    prep, up = tracing.stat("fused_val.prepare"), tracing.stat("eval_many.upload")
    if prep is None or up is None:
        return None
    return statistics.median(a + b for a, b in zip(reversed(prep.ring), reversed(up.ring)))
