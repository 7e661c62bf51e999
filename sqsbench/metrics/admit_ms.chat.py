"""``admit_ms`` in the chat cells, where admissions share the card with
the rounds that set tokens_per_s."""
from harness import readers


def read(run):
    return readers.admit_ms(run)
