"""K6 (``linear_attn_summary_kernel`` and ``linear_attn_apply_kernel``,
FMT's linear attention where no gradient is needed): device ms a request
of both kernels together. The names hold no key of the trace's families,
so both are filed under "other". None where the program launches no such
kernel (a cascade without FMT, or a program without K6)."""
from benchmark.readers import kernel_ms


def read(record):
    return kernel_ms(record, "linear_attn_")
