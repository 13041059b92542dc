"""Device ms a step in the elementwise and gather / scatter families: the
plain warp, the cost volumes, the statistics and the losses under autograd."""
from benchmark.readers import family_ms


def read(record):
    return family_ms(record, "train", "elementwise", "gather / scatter")
