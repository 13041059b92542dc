"""K5 (``prob_conv3d_kernel``, CostRegNet's Cout=1 prob conv): device ms a
request. None where the program launches no such kernel."""
from benchmark.readers import kernel_ms


def read(record):
    return kernel_ms(record, "prob_conv3d_kernel")
