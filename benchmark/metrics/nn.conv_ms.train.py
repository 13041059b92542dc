"""Device ms a step in the convolution family (cuDNN, forward and backward)."""
from benchmark.readers import family_ms


def read(record):
    return family_ms(record, "train", "convolution")
