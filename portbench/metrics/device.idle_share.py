"""Share of the traced window in which nothing ran on the card: one less
the union of every kernel, copy and set in the profiler's trace over the
window, in %."""


def read(run):
    if run.device is None or run.device["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.device["busy_s"] / run.device["window_s"])
