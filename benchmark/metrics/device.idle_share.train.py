"""The share of the traced window in which no device activity ran (the
union of their intervals), training, in %."""
from benchmark.readers import idle_share


def read(record):
    return idle_share(record, "train")
