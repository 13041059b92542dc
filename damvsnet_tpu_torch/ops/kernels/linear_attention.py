"""FMT's linear attention where no gradient is needed: wrapper of
csrc/linear_attention.cu (K6).

Replaces no TPU kernel: the JAX package leaves this math to XLA's einsums.
The plain chain (``linear_attention_plain``, ``nn/fmt.py``'s attention as
written) ran its two summaries as fp32 cuBLAS products with a 62,208-token
inner dimension and 4 x 4 outputs; the kernel pair computes the same
summaries in fp32 (a split reduction over the tokens, summed in a fixed
order) and applies them to the queries in one pass, reading q, k and v
once in their own dtype and rounding the output once to q's. It has no
backward: ``nn/fmt.py`` takes it only where no gradient is needed, at the
widths it is built for (``HEADS`` heads of ``HEAD_DIM``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._common import DTYPE_CODES, F32, INT, VP, Entry, check_cuda, counts

HEADS, HEAD_DIM = 8, 4
# kMaxSplits in csrc/linear_attention.cu: the chunks of a key batch entry's
# tokens, each one 160-float partial summary (KV, then the keys' sum)
MAX_SPLITS = 128
SUMMARY = HEADS * (HEAD_DIM * HEAD_DIM + HEAD_DIM)

_K6 = Entry("linear_attention", "linear_attention_launch", VP, VP, VP, INT, VP, VP,
            INT, INT, INT, INT, F32)


def linear_attention_plain(q, k, v, eps: float = 1e-6):
    """q [Bq, L, H, D], k and v [Bk, S, H, D] -> [Bq, L, H, D] in q's dtype.
    Bk divides Bq: query batch entry i attends to key batch entry i // (Bq
    / Bk), so the sources of one scene, batched view-major inside each
    scene, share their reference's summaries. Differentiable."""
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


@counts(_K6)
def fused_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           eps: float = 1e-6) -> torch.Tensor:
    """``linear_attention_plain(q, k, v, eps)`` for q [Bq, L, 8, 4] and k, v
    [Bk, S, 8, 4] of one dtype (fp32 or bf16), contiguous, Bk dividing Bq.
    Returns [Bq, L, 8, 4] in q's dtype, one contiguous buffer. Raises on
    other shapes or dtypes; then CPU tensors run the plain version, and
    CUDA tensors launch the kernels or raise (and raise where a gradient is
    needed)."""
    name = "fused_linear_attention"
    widths = (HEADS, HEAD_DIM)
    for t, tag in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype not in DTYPE_CODES or t.dim() != 4 or tuple(t.shape[2:]) != widths:
            raise ValueError(f"{name}: {tag} must be a float32 or bfloat16 [B, tokens, "
                             f"{HEADS}, {HEAD_DIM}] tensor, got {t.dtype} {tuple(t.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k and v must share a dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    bq, lq = q.shape[:2]
    bk, s = k.shape[:2]
    if tuple(v.shape[:2]) != (bk, s):
        raise ValueError(f"{name}: v {tuple(v.shape)} does not match k {tuple(k.shape)}")
    if bq % bk:
        raise ValueError(f"{name}: the key batch {bk} does not divide the query batch {bq}")
    if lq == 0 or s == 0:
        raise ValueError(f"{name}: empty tokens, q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q.device.type == "cpu":
        return linear_attention_plain(q, k, v, eps)
    dev = check_cuda(name, q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(f"{name}: the kernels have no backward; take "
                           "linear_attention_plain under autograd")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    partial = torch.empty((bk, MAX_SPLITS, SUMMARY), dtype=torch.float32, device=dev)
    _K6.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), DTYPE_CODES[q.dtype],
               partial.data_ptr(), out.data_ptr(), bq, bk, lq, s, eps)
    return out
