"""``ttft_p95_ms`` in the chat cells, where the host paces the round that
carries the first token."""
from harness import readers


def read(run):
    return readers.tail_ms(run.served.ttft_s)
