"""Mean edge draft time a round: the system's own t_slm (wall time of the
L_max + 1 decode steps with the SQS kernels, to a synchronise)."""
from harness import readers


def read(run):
    return readers.per_round_ms(run, lambda r: r.t_slm)
