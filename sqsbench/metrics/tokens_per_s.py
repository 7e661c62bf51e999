"""All tokens delivered to all devices in the window over the window's
wall seconds (requests still under way count)."""
from harness import readers, stats


def read(run):
    return stats.ratio(readers.tokens(run), run.served.window_s)
