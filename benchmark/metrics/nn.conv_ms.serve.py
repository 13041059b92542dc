"""Device ms a request in the convolution family (cuDNN)."""
from benchmark.readers import family_ms


def read(record):
    return family_ms(record, "serve", "convolution")
