"""The reader of ``kernels.linear_attention_ms.serve`` on canned traces:
K6's two kernels' device ms a request where they ran, None where they did
not (the parent's program, a run without its trace), and both kernels
filed under "other", outside the convolution family that
``nn.conv_ms.serve`` reads."""
from benchmark import cells, yardstick

SUMMARY = ("void (anonymous namespace)::linear_attn_summary_kernel<__nv_bfloat16>"
           "(__nv_bfloat16 const*, __nv_bfloat16 const*, float*, int)")
APPLY = ("void (anonymous namespace)::linear_attn_apply_kernel<__nv_bfloat16>"
         "(__nv_bfloat16 const*, float const*, __nv_bfloat16*, int, int, int, float)")


def test_reads_both_kernels_a_request():
    read = cells.reader("kernels.linear_attention_ms.serve")
    trace = {"units": 20, "kernels": {SUMMARY: [0.004, 240], APPLY: [0.006, 240],
                                      "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n": [1.0, 240]}}
    assert abs(read({"kind": "serve", "trace": trace}) - 0.5) < 1e-12
    assert read({"kind": "serve", "trace": {"units": 20, "kernels": {}}}) is None
    assert read({"kind": "serve"}) is None


def test_filed_under_other():
    assert yardstick.family(SUMMARY) == yardstick.family(APPLY) == "other"
