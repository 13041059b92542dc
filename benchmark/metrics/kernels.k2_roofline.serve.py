"""K2 (``probstats_kernel``): its least time at the three stages' shapes
over its device time, a request, in %."""
from benchmark.readers import roofline


def read(record):
    return roofline(record, "k2", "probstats_kernel")
