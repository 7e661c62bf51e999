"""Process start to the first timed round: weights, kernel library,
admissions of the whole fleet and the warm-up rounds."""


def read(run):
    return run.setup_s
