"""Device-seconds per delivered token: each window round's cost (its wall
time with the admissions that stalled it, plus its modeled link time)
times the devices active in it, summed, over the tokens delivered."""
from harness import readers, stats


def read(run):
    rs = readers.window_rounds(run)
    cost = sum((r.stall_s + r.wall_s + r.link_s) * r.active for r in rs)
    v = stats.ratio(cost, readers.tokens(run))
    return None if v is None else 1000.0 * v
