"""Counted FLOPs a request (the reference's convolutions at the cell's
shapes) times requests a second, over the H100's bf16 dense peak, in %."""
from benchmark.readers import mfu
from benchmark.yardstick import BF16_FLOPS_PER_S


def read(record):
    return mfu(record, "serve", BF16_FLOPS_PER_S)
