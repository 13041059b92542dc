"""Seconds from the start of the process to the first timed call: imports,
kernel builds, weights, the pool of inputs and the warm-up."""


def read(record):
    return record["setup_s"]
