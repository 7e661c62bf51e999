"""Mean cloud verify time a round: the system's own t_llm (the extend
over L_max + 1 tokens, accept and resample, to a synchronise)."""
from harness import readers


def read(run):
    return readers.per_round_ms(run, lambda r: r.t_llm)
