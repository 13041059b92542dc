"""FMT, the feature-matching transformer (counterpart of
damvsnet_tpu/nn/fmt.py; TransMVSNet lineage).

  * ``linear_attention``: elu(x)+1 kernelized attention, O(N d^2): the
    per-head d x d summary KV = sum_s K_s V_s^T and the normalizer's
    sum_s K_s run over every token (62,208 at the serving stage 1), so
    they, and the whole attention, are computed in fp32 and the result
    rounded once to the queries' dtype. Where no gradient is needed, at 8
    heads of 4 (TransMVSNet's widths), in fp32 or bf16, it is the kernel
    pair K6 (``ops/kernels/linear_attention.py``); under autograd, at other
    widths and with ``plain``, the plain einsum chain. With ``sp_group``, a
    process group whose size divides the tokens, an attention with as many
    keys as queries runs sequence-parallel over its ranks
    (``parallel/fmt_sp.py``; JAX's ``sp_axis``).
  * ``AttentionLayer`` / ``EncoderLayer``: post-norm residual blocks with a
    2x FFN, dropout 0. LayerNorm's epsilon is flax's 1e-6 (the reference's
    torch LayerNorm has 1e-5).
  * ``FMT``: layer_names ['self', 'cross'] x 4. The reference view passes
    through the 4 self layers, each output kept; each source view
    alternates self and cross-to-ref(i // 2). The sources run as one batch.
    Its weight matrices start Xavier-uniform, as the reference's
    ``_reset_parameters`` sets them (LoFTR's; flax's Dense would start
    LeCun-normal); biases and LayerNorms keep torch's defaults.
  * ``FMTWithPathway``: FMT at stage 1, then the transformed features go
    down the FPN: 1x1 dim reductions, bilinear upsample-add, 3x3 smoothing.
    Under a profiler it opens ``cascade.fmt.ref`` (the reference's self
    layers), ``cascade.fmt.src`` (the sources' layers) and
    ``cascade.fmt.pathway`` (the FPN propagation), in that order, inside
    the cascade's ``cascade.fmt``.

Precision under a bf16 compute dtype follows flax's promotion: each Dense
runs in the compute dtype, each LayerNorm computes and returns fp32 (its
parameters are fp32), so the residual stream after the first norm is fp32;
the pathway's convolutions have no compute dtype in JAX and run in the
promoted dtype, fp32. Every stage's features leave the pathway in fp32.

Names follow the reference state_dict (``FMT_with_pathway.FMT.layers.{i}
.attention.{query,key,value,out}_projection``, ``.linear1``, ``.linear2``,
``.norm1``, ``.norm2``, ``dim_reduction_{1,2}``, ``smooth_{1,2}``), so the
JAX package's ``transplant_cascade(..., use_fmt=True)`` maps them.

Layout: features [B, N, H, W, C] per stage (NHWC per view); tokens are the
flattened (H*W).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import linear_attention as la
from ..ops.kernels._common import DTYPE_CODES
from ..ops.resize import resize_bilinear
from ..parallel.fmt_sp import sequence_parallel_applies, sequence_parallel_linear_attention
from ..train.profiler import span
from .blocks import conv
from .posenc import sine_position_encoding

LN_EPS = 1e-6  # flax.linen.LayerNorm's default


def linear_attention(q, k, v, eps: float = 1e-6, plain: bool = False):
    """q [Bq, L, H, D], k and v [Bk, S, H, D] -> [Bq, L, H, D] in q's dtype.
    Bk divides Bq: query batch entry i attends to key batch entry i // (Bq
    / Bk), so the sources of one scene, batched view-major inside each
    scene, share their reference's summaries. The kernel pair K6 where it
    applies (the widths it is built for, fp32 or bf16) unless a gradient is
    needed (it has no backward) or ``plain``; else the plain chain."""
    takes = q.dtype in DTYPE_CODES and all(
        t.dtype == q.dtype and tuple(t.shape[2:]) == (la.HEADS, la.HEAD_DIM) for t in (q, k, v))
    if (plain or not takes or (torch.is_grad_enabled()
                               and (q.requires_grad or k.requires_grad or v.requires_grad))):
        return la.linear_attention_plain(q, k, v, eps)
    return la.fused_linear_attention(q, k, v, eps)


def dense(x: torch.Tensor, m: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=compute): input, kernel and bias cast to it."""
    return F.linear(x.to(dtype), m.weight.to(dtype), m.bias.to(dtype))


def layer_norm(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    """flax LayerNorm with fp32 parameters: computed and returned in fp32."""
    return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias, m.eps)


class AttentionLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, sp_group=None):
        super().__init__()
        self.n_heads = n_heads
        self.sp_group = sp_group
        self.query_projection = nn.Linear(d_model, d_model)
        self.key_projection = nn.Linear(d_model, d_model)
        self.value_projection = nn.Linear(d_model, d_model)
        self.out_projection = nn.Linear(d_model, d_model)

    def forward(self, queries, keys, values, dtype, plain=False):
        n, l, _ = queries.shape
        h = self.n_heads
        q = dense(queries, self.query_projection, dtype).view(n, l, h, -1)
        k = dense(keys, self.key_projection, dtype).view(keys.shape[0], keys.shape[1], h, -1)
        v = dense(values, self.value_projection, dtype).view(values.shape[0],
                                                             values.shape[1], h, -1)
        if sequence_parallel_applies(self.sp_group, l, k.shape[1]):
            out = sequence_parallel_linear_attention(q, k, v, self.sp_group)
        else:
            out = linear_attention(q, k, v, plain=plain)
        return dense(out.reshape(n, l, -1), self.out_projection, dtype)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, sp_group=None):
        super().__init__()
        self.attention = AttentionLayer(d_model, n_heads, sp_group)
        self.linear1 = nn.Linear(d_model, 2 * d_model)
        self.linear2 = nn.Linear(2 * d_model, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, source, dtype, plain=False):
        x = layer_norm(x + self.attention(x, source, source, dtype, plain), self.norm1)
        y = dense(torch.relu(dense(x, self.linear1, dtype)), self.linear2, dtype)
        return layer_norm(x + y, self.norm2)


class FMT(nn.Module):
    def __init__(self, d_model: int = 32, n_heads: int = 8,
                 layer_names=("self", "cross") * 4, sp_group=None):
        super().__init__()
        if any(name not in ("self", "cross") for name in layer_names):
            raise KeyError(f"FMT layer names are 'self' or 'cross', got {layer_names}")
        self.d_model = d_model
        self.layer_names = tuple(layer_names)
        self.layers = nn.ModuleList(EncoderLayer(d_model, n_heads, sp_group)
                                    for _ in layer_names)
        for p in self.parameters():  # the reference's _reset_parameters
            if p.dim() > 1:
                nn.init.xavier_uniform_(p)

    def ref_forward(self, ref_feature, dtype, plain=False):
        """ref_feature [B, H, W, C] -> each self layer's output, [B, H, W, C]."""
        b, h, w, c = ref_feature.shape
        x = sine_position_encoding(ref_feature).reshape(b, h * w, c)
        outs = []
        for layer, name in zip(self.layers, self.layer_names):
            if name == "self":
                x = layer(x, x, dtype, plain)
                outs.append(x.view(b, h, w, c))
        return outs

    def src_forward(self, ref_feature_list, src_feature, dtype, plain=False):
        """Alternating self / cross-to-ref(i // 2). src_feature [B*V, H, W,
        C], the V sources of each scene consecutive; ref_feature_list as
        ``ref_forward`` returns it, batch B."""
        bv, h, w, c = src_feature.shape
        refs = [r.reshape(r.shape[0], h * w, c) for r in ref_feature_list]
        x = sine_position_encoding(src_feature).reshape(bv, h * w, c)
        for i, (layer, name) in enumerate(zip(self.layers, self.layer_names)):
            x = layer(x, x if name == "self" else refs[i // 2], dtype, plain)
        return x.view(bv, h, w, c)


class FMTWithPathway(nn.Module):
    def __init__(self, base_channels: int = 8, sp_group=None):
        super().__init__()
        b = base_channels
        self.FMT = FMT(d_model=4 * b, sp_group=sp_group)
        self.dim_reduction_1 = nn.Conv2d(4 * b, 2 * b, 1, bias=False)
        self.dim_reduction_2 = nn.Conv2d(2 * b, b, 1, bias=False)
        self.smooth_1 = nn.Conv2d(2 * b, 2 * b, 3, padding=1, bias=False)
        self.smooth_2 = nn.Conv2d(b, b, 3, padding=1, bias=False)

    @staticmethod
    def _nhwc_conv(x, m):
        """A conv of an NHWC map in its own dtype, NHWC out."""
        return conv(x.permute(0, 3, 1, 2), m).permute(0, 2, 3, 1)

    def _upsample_add(self, x, y):
        return resize_bilinear(x, y.shape[1:3], align_corners=False) + y

    def forward(self, feats: dict, dtype: torch.dtype, plain: bool = False) -> dict:
        """feats {stage: [B, N, H, W, C]} (view 0 the reference) -> the same
        structure, every stage in fp32 (see the module's docstring); the
        Dense layers run in ``dtype``, the compute dtype; ``plain``: the
        attention's plain chain in place of K6."""
        x1 = feats["stage1"]
        b, n = x1.shape[:2]
        with span("cascade.fmt.ref"):
            refs = self.FMT.ref_forward(x1[:, 0], dtype, plain)
        with span("cascade.fmt.src"):
            srcs = self.FMT.src_forward(refs, x1[:, 1:].reshape(b * (n - 1), *x1.shape[2:]),
                                        dtype, plain)
        with span("cascade.fmt.pathway"):
            s1 = torch.cat([refs[-1][:, None], srcs.view(b, n - 1, *srcs.shape[1:])], dim=1)
            flat = lambda t: t.reshape(b * n, *t.shape[2:])  # noqa: E731
            s2 = self._nhwc_conv(self._upsample_add(
                self._nhwc_conv(flat(s1), self.dim_reduction_1), flat(feats["stage2"])),
                self.smooth_1)
            s3 = self._nhwc_conv(self._upsample_add(
                self._nhwc_conv(s2, self.dim_reduction_2), flat(feats["stage3"])),
                self.smooth_2)
        return {"stage1": s1, "stage2": s2.reshape(b, n, *s2.shape[1:]),
                "stage3": s3.reshape(b, n, *s3.shape[1:])}
