"""Percent of the traced segment (three epochs after the window) in which
no kernel, copy or fill ran on the device, from the profiler's timeline;
nothing where the profiler kept fewer records of the graphs' replays than
the graphs have nodes."""


def read(run, outcome):
    t = outcome.trace
    if not t or t["window_s"] <= 0 or not outcome.probes.get("profiler_complete"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
