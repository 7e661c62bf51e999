"""95th percentile of the gaps between a request's delivered tokens in
the window (modeled clock), in the chat cells: a host-paced tail."""
from harness import readers


def read(run):
    return readers.tail_ms(run.served.gaps_s)
