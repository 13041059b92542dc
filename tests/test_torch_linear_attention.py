"""FMT's linear attention (kernel K6, ``ops/kernels/linear_attention.py``)
on the CPU: the wrapper's plain version against the chain ``nn/fmt.py`` ran
before the kernel, bit for bit; its argument checks; the route that
``nn.fmt.linear_attention`` takes (the kernel where no gradient is needed,
at 8 heads of 4, in fp32 or bf16; the plain chain under autograd, at other
widths or dtypes, and with ``plain``); the FMT pathway on CPU tensors,
which launches nothing; and the wrapper's constants against the source's.
The kernel is held against fp64 on the card in
``test_torch_kernels_cuda.py``."""
import re

import pytest
import torch
import torch.nn.functional as F

from damvsnet_tpu_torch.nn import fmt
from damvsnet_tpu_torch.nn.fmt import FMTWithPathway
from damvsnet_tpu_torch.ops.kernels import build
from damvsnet_tpu_torch.ops.kernels import linear_attention as la

torch.set_num_threads(1)


def _chain_as_written(q, k, v, eps=1e-6):
    """``nn/fmt.py::linear_attention`` before the kernel, as it was written."""
    dtype = q.dtype
    q = F.elu(q.float()) + 1.0
    k = F.elu(k.float()) + 1.0
    kv = torch.einsum("nshd,nshm->nhmd", k, v.float())
    ksum = k.sum(dim=1)
    rep = q.shape[0] // k.shape[0]
    if rep > 1:
        kv, ksum = kv.repeat_interleave(rep, dim=0), ksum.repeat_interleave(rep, dim=0)
    z = 1.0 / (torch.einsum("nlhd,nhd->nlh", q, ksum) + eps)
    return (torch.einsum("nlhd,nhmd->nlhm", q, kv) * z[..., None]).to(dtype)


def _qkv(dtype=torch.float32, bq=4, bk=1, lq=50, s=60, widths=(8, 4), seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(bq, lq, *widths, generator=g).to(dtype)
    k, v = (torch.randn(bk, s, *widths, generator=g).to(dtype) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("key_batch", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_is_the_chain(key_batch, dtype):
    """Key batch 1 (the cross layers, and the reference's self layers at
    query batch 1) and 4 (the sources' self layers)."""
    q, k, v = _qkv(dtype, 4, key_batch)
    want = _chain_as_written(q, k, v)
    n0 = la.fused_linear_attention.launches
    with torch.no_grad():
        got = la.fused_linear_attention(q, k, v)
        routed = fmt.linear_attention(q, k, v)
    assert la.fused_linear_attention.launches == n0
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, want) and torch.equal(routed, want)
    assert torch.equal(la.linear_attention_plain(q, k, v), want)


@pytest.mark.parametrize("grad, needs_grad, widths, dtype, plain, route", [
    (False, False, (8, 4), torch.bfloat16, False, "kernel"),  # serving: no_grad
    (False, True, (8, 4), torch.float32, False, "kernel"),    # no_grad, inputs that track
    (True, False, (8, 4), torch.bfloat16, False, "kernel"),   # nothing needs a gradient
    (True, True, (8, 4), torch.bfloat16, False, "plain"),     # autograd: training
    (True, True, (8, 4), torch.float32, False, "plain"),
    (False, False, (4, 8), torch.bfloat16, False, "plain"),   # 4 heads of 8
    (False, False, (16, 4), torch.float32, False, "plain"),   # 16 heads of 4
    (False, False, (8, 4), torch.float16, False, "plain"),    # a dtype it does not take
    (False, False, (8, 4), torch.bfloat16, True, "plain"),    # the cascade's plain reference
])
def test_route(monkeypatch, grad, needs_grad, widths, dtype, plain, route):
    calls = []
    plain_chain = la.linear_attention_plain
    monkeypatch.setattr(la, "fused_linear_attention", lambda q, k, v, eps: calls.append(
        "kernel") or plain_chain(q, k, v, eps))
    monkeypatch.setattr(la, "linear_attention_plain", lambda q, k, v, eps: calls.append(
        "plain") or plain_chain(q, k, v, eps))
    q, k, v = (t.requires_grad_(needs_grad) for t in _qkv(dtype, widths=widths))
    with torch.set_grad_enabled(grad):
        got = fmt.linear_attention(q, k, v, plain=plain)
    assert calls == [route] and got.shape == q.shape and got.dtype == dtype


def test_mixed_dtypes_take_the_plain_chain(monkeypatch):
    calls = []
    plain_chain = la.linear_attention_plain
    monkeypatch.setattr(la, "linear_attention_plain", lambda q, k, v, eps: calls.append(
        "plain") or plain_chain(q, k, v, eps))
    q, k, v = _qkv(torch.bfloat16)
    with torch.no_grad():
        fmt.linear_attention(q, k.float(), v)
    assert calls == ["plain"]


def _pathway_features(dtype, views=3, h=8, w=12, seed=1):
    g = torch.Generator().manual_seed(seed)
    return {f"stage{s + 1}": torch.randn(1, views, h << s, w << s, 32 >> s,
                                         generator=g).to(dtype) for s in range(3)}


@pytest.mark.parametrize("grad", [False, True])
def test_fmt_pathway_on_cpu_launches_nothing(grad):
    """The pathway's 8 attention calls at 3 views (the reference's 4 self
    layers, the sources' 4 layers as one batch) on CPU tensors: the
    wrapper's plain version, bit for bit the plain route, no launch."""
    torch.manual_seed(0)
    port = FMTWithPathway(8).eval()
    feats = _pathway_features(torch.bfloat16)
    n0 = la.fused_linear_attention.launches
    with torch.set_grad_enabled(grad):
        got = port(feats, torch.bfloat16)
        want = port(feats, torch.bfloat16, plain=True)
    assert la.fused_linear_attention.launches == n0
    for s in got:
        assert torch.equal(got[s], want[s])


def _bad(case):
    q, k, v = _qkv()
    return {"key batch 3 of 4": (q, k.repeat(3, 1, 1, 1), v.repeat(3, 1, 1, 1)),
            "v tokens": (q, k, v[:, :-1]),
            "v batch": (q, k, v.repeat(2, 1, 1, 1)),
            "widths 8 x 2": (q[..., :2], k[..., :2], v[..., :2]),
            "4 heads": (q[:, :, :4], k[:, :, :4], v[:, :, :4]),
            "3-d": (q.flatten(2), k.flatten(2), v.flatten(2)),
            "float16": (q.half(), k.half(), v.half()),
            "float64": (q.double(), k.double(), v.double()),
            "mixed": (q, k.bfloat16(), v),
            "no keys": (q, k[:, :0], v[:, :0]),
            "no queries": (q[:, :0], k, v)}[case]


@pytest.mark.parametrize("case", ["key batch 3 of 4", "v tokens", "v batch", "widths 8 x 2",
                                  "4 heads", "3-d", "float16", "float64", "mixed", "no keys",
                                  "no queries"])
def test_wrapper_rejects_bad_input(case):
    with torch.no_grad(), pytest.raises(ValueError, match="fused_linear_attention"):
        la.fused_linear_attention(*_bad(case))


def test_constants_are_the_sources():
    """The wrapper's widths and scratch size are the kernel's."""
    text = (build.CSRC / "linear_attention.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    assert (const("kHeads"), const("kDim"), const("kMaxSplits")) == (
        la.HEADS, la.HEAD_DIM, la.MAX_SPLITS)
    assert la.SUMMARY == la.HEADS * la.HEAD_DIM * (la.HEAD_DIM + 1) == 160
