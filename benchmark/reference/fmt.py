"""The plain reference of DA-MVSNet with TransMVSNet's feature-matching
transformer (FMT), as the DA-MVSNet reference wires it under ``--use_fmt``
(models/FMT.py, models/position_encoding.py, the ``use_fmt`` branch of
models/cas_mvsnet.py): fp32 PyTorch, TF32 off, nothing of the program
imported. A configuration takes it with ``"reference": "fmt"``.

Written from the published description: TransMVSNet (Ding et al., CVPR
2022, arXiv:2111.14600), whose attention is LoFTR's linear attention and
whose positional encoding is LoFTR's sine encoding.

  encoding   pe[4k] = sin(x div_k), pe[4k+1] = cos(x div_k), pe[4k+2] =
             sin(y div_k), pe[4k+3] = cos(y div_k), positions 1-based,
             div_k = exp(2k (-ln 1e4) / (d/2)) (LoFTR's temp_bug_fix form),
             added to the stage-1 features of every view
  attention  elu(x)+1 feature map; per head, KV = sum_s K_s V_s^T and the
             normaliser Z_l = 1 / (Q_l . sum_s K_s + 1e-6), out_l = Z_l Q_l KV
  layer      post-norm: x = LN(x + Wo attn(Wq x, Wk src, Wv src));
             x = LN(x + W2 relu(W1 x)); d_model 32, 8 heads of width 4, FFN
             32 -> 64 -> 32
  FMT        layer names ['self', 'cross'] x 4: the reference view passes
             through the 4 self layers and keeps each output; each source
             view alternates self-attention with cross-attention to the
             reference's output i // 2
  pathway    stage 2 = smooth_1(up(dim_reduction_1(stage 1)) + stage 2),
             stage 3 = smooth_2(up(dim_reduction_2(stage 2)) + stage 3): 1x1
             reductions, bilinear upsampling (align_corners=False), 3x3
             smoothing, no bias, no normalisation

Departures from the published FMT:

  * LayerNorm's epsilon is torch's default 1e-5, as the published module
    builds it; the program keeps its JAX counterpart's 1e-6, which that
    package's parity tests hold. The gap is measured in
    tests/test_torch_fmt_reference.py.
  * The encoding is computed for the map's own (H, W). LoFTR's module
    slices a table built once for a fixed ``max_shape``; the values are the
    same wherever that table covers the map.
  * LoFTR divides the values by the key count before the sum and multiplies
    it back after, a guard against fp16 overflow; in fp32 it changes only
    rounding, so it is left out.
  * Serving only: dropout is off in eval mode, and ``settings`` refuses
    training (no training cell runs FMT).

``precision="fp8"`` (the control) rounds every Dense layer's input and
weight to float8 e4m3 with a per-tensor scale, as ``model.Cascade`` rounds
the convolutions', so a precision below the stated one moves FMT too.

The sources pass through the layers one view at a time, as published; the
program batches them.
"""
from __future__ import annotations

import copy
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import reference as base
from .model import Cascade, _Fp8Forward

D_MODEL = 32
N_HEADS = 8
LAYER_NAMES = ("self", "cross") * 4
LN_EPS = 1e-5  # torch.nn.LayerNorm's default, the published module's
ATTENTION_EPS = 1e-6  # LoFTR's LinearAttention
PATHWAY = "FMT_with_pathway"


def sine_encoding(c, h, w, device):
    """[1, C, H, W] LoFTR sine encoding of an H x W map, fp32."""
    pe = torch.zeros(c, h, w, device=device)
    ones = torch.ones(h, w, device=device)
    y, x = ones.cumsum(0), ones.cumsum(1)
    div = torch.exp(torch.arange(0, c // 2, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / (c // 2)))[:, None, None]
    pe[0::4], pe[1::4] = torch.sin(x * div), torch.cos(x * div)
    pe[2::4], pe[3::4] = torch.sin(y * div), torch.cos(y * div)
    return pe[None]


class FmtCascade(Cascade):
    """``model.Cascade`` whose views' features pass through FMT and the
    pathway (``features``)."""

    def dense(self, x, name):
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        if self.fp8:
            x, w = _Fp8Forward.apply(x), _Fp8Forward.apply(w)
        return F.linear(x, w, b)

    def layer_norm(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.p[f"{name}.weight"],
                            self.p[f"{name}.bias"], LN_EPS)

    def attention(self, x, source, name):
        n, length, _ = x.shape
        q = self.dense(x, f"{name}.query_projection").view(n, length, N_HEADS, -1)
        k = self.dense(source, f"{name}.key_projection").view(n, source.shape[1], N_HEADS, -1)
        v = self.dense(source, f"{name}.value_projection").view(n, source.shape[1], N_HEADS, -1)
        q, k = F.elu(q) + 1.0, F.elu(k) + 1.0
        kv = torch.einsum("nshd,nshv->nhdv", k, v)
        z = 1.0 / (torch.einsum("nlhd,nhd->nlh", q, k.sum(dim=1)) + ATTENTION_EPS)
        out = torch.einsum("nlhd,nhdv,nlh->nlhv", q, kv, z)
        return self.dense(out.reshape(n, length, -1), f"{name}.out_projection")

    def encoder_layer(self, x, source, i):
        """Layer i of FMT on tokens x [B, L, C] attending to ``source``."""
        t = f"{PATHWAY}.FMT.layers.{i}"
        x = self.layer_norm(x + self.attention(x, source, f"{t}.attention"), f"{t}.norm1")
        y = self.dense(torch.relu(self.dense(x, f"{t}.linear1")), f"{t}.linear2")
        return self.layer_norm(x + y, f"{t}.norm2")

    def transform(self, ref, srcs):
        """FMT on the stage-1 maps: ref [B, C, H, W] and each source's ->
        the reference's last self layer's output and each source's output,
        [B, C, H, W]."""
        b, c, h, w = ref.shape
        pe = sine_encoding(c, h, w, ref.device)
        tokens = lambda m: (m + pe).flatten(2).transpose(1, 2)  # noqa: E731
        maps = lambda t: t.transpose(1, 2).reshape(b, c, h, w)  # noqa: E731
        x, kept = tokens(ref), []
        for i, name in enumerate(LAYER_NAMES):
            if name == "self":
                x = self.encoder_layer(x, x, i)
                kept.append(x)
        out = []
        for src in srcs:
            x = tokens(src)
            for i, name in enumerate(LAYER_NAMES):
                x = self.encoder_layer(x, x if name == "self" else kept[i // 2], i)
            out.append(maps(x))
        return maps(kept[-1]), out

    def pathway(self, s1, s2, s3):
        """The transformed stage-1 map carried down the FPN: stages 2 and 3."""
        def up_add(x, y):
            return F.interpolate(x, size=y.shape[2:], mode="bilinear", align_corners=False) + y
        s2 = self.conv(up_add(self.conv(s1, f"{PATHWAY}.dim_reduction_1"), s2),
                       f"{PATHWAY}.smooth_1", padding=1)
        s3 = self.conv(up_add(self.conv(s2, f"{PATHWAY}.dim_reduction_2"), s3),
                       f"{PATHWAY}.smooth_2", padding=1)
        return s2, s3

    def features(self, nchw):
        feats = super().features(nchw)
        ref, srcs = self.transform(feats["stage1"][0], feats["stage1"][1:])
        out = {k: [] for k in feats}
        for v, s1 in enumerate([ref] + srcs):
            s2, s3 = self.pathway(s1, feats["stage2"][v], feats["stage3"][v])
            for k, f in (("stage1", s1), ("stage2", s2), ("stage3", s3)):
                out[k].append(f)
        return out


def settings(cfg, kind):
    """The default reference's serving settings with ``use_fmt: true``.
    Raises ValueError for training, for ``use_fmt`` absent or false, and
    for whatever the default reference refuses."""
    if kind != "serve":
        raise ValueError(f"kind {kind!r}: the reference {__name__} serves only; no training "
                         "cell runs FMT")
    plain = copy.deepcopy(cfg)
    groups = [g for g in (plain["model"], plain[kind]["model"]) if "use_fmt" in g]
    if len(groups) != 1 or groups[0]["use_fmt"] is not True:
        raise ValueError(f"the reference {__name__} is FMT's: 'use_fmt' must be true, set "
                         "once")
    groups[0]["use_fmt"] = False
    out = base.settings(plain, kind)
    out["model"]["use_fmt"] = True
    return out


def table():
    """[(reference name, flax key, permutation or None)] of FMT and its
    pathway: Dense kernel [in, out] -> weight [out, in]; LayerNorm scale ->
    weight; Conv kernel [kh, kw, I, O] -> weight [O, I, kh, kw]."""
    rows = []
    for i in range(len(LAYER_NAMES)):
        t, f = f"{PATHWAY}.FMT.layers.{i}", f"params/fmt_pathway/fmt/layer{i}"
        dense = [(f"{t}.attention.{p}", f"{f}/AttentionLayer_0/{p}")
                 for p in ("query_projection", "key_projection", "value_projection",
                           "out_projection")]
        for tn, fk in dense + [(f"{t}.linear1", f"{f}/linear1"),
                               (f"{t}.linear2", f"{f}/linear2")]:
            rows += [(f"{tn}.weight", f"{fk}/kernel", (1, 0)), (f"{tn}.bias", f"{fk}/bias", None)]
        for norm in ("norm1", "norm2"):
            rows += [(f"{t}.{norm}.weight", f"{f}/{norm}/scale", None),
                     (f"{t}.{norm}.bias", f"{f}/{norm}/bias", None)]
    for name in ("dim_reduction_1", "dim_reduction_2", "smooth_1", "smooth_2"):
        rows.append((f"{PATHWAY}.{name}.weight", f"params/fmt_pathway/{name}/kernel",
                     (3, 2, 0, 1)))
    return rows


def load_weights(path, model_cfg, device="cpu"):
    """The default reference's (params, buffers) with FMT's and the
    pathway's parameters added (``table``)."""
    params, buffers = base.load_weights(path, model_cfg, device)
    with np.load(path) as npz:
        for name, key, perm in table():
            arr = np.asarray(npz[key], dtype=np.float32)
            if perm is not None:
                arr = arr.transpose(perm)
            params[name] = torch.tensor(np.ascontiguousarray(arr), device=device)
    return params, buffers


def serve(params, buffers, model_cfg, batch, precision="fp32", cascade=FmtCascade):
    """The default reference's ``serve`` through ``cascade``."""
    return base.serve(params, buffers, model_cfg, batch, precision, cascade=cascade)


def counted_pass(params, buffers, rcfg, batch, training):
    """The default reference's ``counted_pass`` through ``FmtCascade``: FMT's
    matmuls are counted with the convolutions."""
    return base.counted_pass(params, buffers, rcfg, batch, training, cascade=FmtCascade)
