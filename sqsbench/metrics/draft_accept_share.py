"""Accepted drafts over live drafts sent, in the window (%)."""
from harness import readers, stats


def read(run):
    rs = readers.window_rounds(run)
    v = stats.ratio(sum(r.n_accept for r in rs), sum(r.n_live for r in rs))
    return None if v is None else 100.0 * v
