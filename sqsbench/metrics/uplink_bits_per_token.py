"""Packed draft payload bits sent in the window over the tokens
delivered (framing excluded)."""
from harness import readers, stats


def read(run):
    rs = readers.window_rounds(run)
    return stats.ratio(sum(r.up_bits for r in rs), readers.tokens(run))
