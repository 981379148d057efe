"""Host ms of building the Trainer (datasets, device cache, model,
optimizer, step functions), synchronised."""


def read(run, outcome):
    return 1e3 * outcome.spans.host["trainer_init"][0]
