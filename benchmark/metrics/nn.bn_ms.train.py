"""Device ms a step in the batch-norm family (batch statistics, forward
and backward)."""
from benchmark.readers import family_ms


def read(record):
    return family_ms(record, "train", "batch norm")
