"""Mean host time a round outside the draft and the verify: payload
build, pack and unpack, the dense q-hat, verdict pack and apply (the
span of run_round minus t_slm and t_llm)."""
from harness import readers


def read(run):
    return readers.per_round_ms(run, lambda r: r.wall_s - r.t_slm - r.t_llm)
