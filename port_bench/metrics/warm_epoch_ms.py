"""Host ms of epoch 0, the warm-up: the first validation and every step
of the epoch, in which the train and eval graphs are captured."""


def read(run, outcome):
    return 1e3 * outcome.spans.host["warm_epoch"][0]
