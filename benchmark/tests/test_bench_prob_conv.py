"""The reader of ``kernels.prob_conv_ms.serve`` on canned traces: K5's
device ms a request where the kernel ran, None where it did not (the
parent's program, a run without its trace), and its kernel counted in the
convolution family, where ``nn.conv_ms.serve`` reads it."""
from benchmark import cells, yardstick

NAME = ("void (anonymous namespace)::prob_conv3d_kernel<__nv_bfloat16, true>"
        "(__nv_bfloat16 const*, long long, long long, long long, long long, long long, "
        "__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int)")


def test_reads_the_kernel_a_request():
    read = cells.reader("kernels.prob_conv_ms.serve")
    trace = {"units": 20, "kernels": {NAME: [0.006, 60],
                                      "probstats_kernel<float, 8, 2>": [1.0, 60]}}
    assert abs(read({"kind": "serve", "trace": trace}) - 0.3) < 1e-12
    assert read({"kind": "serve", "trace": {"units": 20, "kernels": {}}}) is None
    assert read({"kind": "serve"}) is None


def test_counted_as_convolution():
    assert yardstick.family(NAME) == "convolution"
