"""Device ms an optimizer step: CUDA events around every `train_epoch` of
the window, over its optimizer steps."""


def read(run, outcome):
    return sum(outcome.spans.device_ms("train_epoch")) / outcome.info["steps"]
