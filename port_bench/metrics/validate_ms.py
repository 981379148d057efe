"""Host ms of one `validate` call (it ends in a device-to-host read),
mean over the window's epochs."""


def read(run, outcome):
    v = outcome.spans.host["validate"]
    return 1e3 * sum(v) / len(v)
