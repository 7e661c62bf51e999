"""Share (%) of the traced window in which no operation ran on the
device (profiler timeline)."""


def read(run):
    if not run.red or run.red["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.red["busy_s"] / run.red["window_s"])
