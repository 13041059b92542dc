"""Counted FLOPs a step (the reference's convolutions, forward and
backward, at the cell's shapes) times steps a second, over the H100's bf16
dense peak, in %."""
from benchmark.readers import mfu
from benchmark.yardstick import BF16_FLOPS_PER_S


def read(record):
    return mfu(record, "train", BF16_FLOPS_PER_S)
