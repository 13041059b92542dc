"""The reference's own map from a flax flat-path checkpoint (such as
``weights/bench_ckpt.npz``) to parameters and running statistics named as
the reference DA-MVSNet state_dict names them.

Covered: the configurations the benchmark runs (fpn FeatureNet, geo
fusion, CostRegNet, with or without the adaptive weight nets). Layouts,
flax -> torch:

  Conv    kernel [k..., I, O] -> weight [O, I, k...]
  ConvT   kernel [k..., I, O] -> weight [I, O, k...] (the flip is torch's)
  BatchNorm scale / bias -> weight / bias; batch_stats mean / var ->
  running_mean / running_var
"""
from __future__ import annotations

import numpy as np
import torch

_NA = "_NormAct_0/BatchNorm_0"
_GEO_SEQ_CONV = ("rgb_conv_init", "depth_conv_init")
_GEO_BASIC = ("rgb_encoder_layer1", "rgb_encoder_layer2", "rgb_encoder_layer3",
              "rgb_encoder_layer4", "rgb_encoder_layer5", "depth_layer1",
              "depth_layer2", "depth_layer3", "depth_layer4", "depth_layer5")
_GEO_SEQ_DECONV = ("rgb_decoder_layer4", "rgb_decoder_layer2", "rgb_decoder_layer0",
                   "rgb_decoder_layer", "rgb_decoder_output", "decoder_layer3",
                   "decoder_layer4", "decoder_layer5", "decoder_layer6",
                   "decoder_layer7", "rgbdepth_decoder_stage2",
                   "rgbdepth_decoder_stage3", "final_decoder_stage2",
                   "final_decoder_stage3")


def _conv_perm(nd):
    return (nd + 1, nd) + tuple(range(nd))


def _deconv_perm(nd):
    return (nd, nd + 1) + tuple(range(nd))


def table(adaptive: bool, geo_fusion: bool):
    """[(torch name, flax key, permutation or None)] of the cascade."""
    rows = []

    def conv(t, f, nd, bias=False, transposed=False):
        perm = _deconv_perm(nd) if transposed else _conv_perm(nd)
        rows.append((f"{t}.weight", f"params/{f}/kernel", perm))
        if bias:
            rows.append((f"{t}.bias", f"params/{f}/bias", None))

    def bn(t, f):
        rows.append((f"{t}.weight", f"params/{f}/scale", None))
        rows.append((f"{t}.bias", f"params/{f}/bias", None))
        rows.append((f"{t}.running_mean", f"batch_stats/{f}/mean", None))
        rows.append((f"{t}.running_var", f"batch_stats/{f}/var", None))

    def block(t, f, nd, transposed=False):
        conv(f"{t}.conv", f if transposed else f"{f}/Conv_0", nd, transposed=transposed)
        bn(f"{t}.bn", f"{f}/{_NA}")

    idx = 0
    for name, n in (("conv0", 2), ("conv1", 3), ("conv2", 3)):
        for j in range(n):
            block(f"feature.{name}.{j}", f"feature/Conv2dBlock_{idx}", 2)
            idx += 1
    for name in ("out1", "out2", "out3"):
        conv(f"feature.{name}", f"feature/{name}", 2)
    for name in ("inner1", "inner2"):
        conv(f"feature.{name}", f"feature/{name}", 2, bias=True)
    if geo_fusion:
        t, f = "GeoFeatureFusionNet", "geo_fusion"
        for layer in _GEO_SEQ_CONV:
            conv(f"{t}.{layer}.0", f"{f}/{layer}/Conv_0", 2)
            bn(f"{t}.{layer}.1", f"{f}/{layer}/{_NA}")
        for layer in _GEO_BASIC:
            for tc, tb, fs in (("conv1", "bn1", "conv1"), ("conv2", "bn2", "conv2"),
                               ("downsample.0", "downsample.1", "downsample")):
                conv(f"{t}.{layer}.{tc}", f"{f}/{layer}/{fs}/Conv_0", 2)
                bn(f"{t}.{layer}.{tb}", f"{f}/{layer}/{fs}/{_NA}")
        for layer in _GEO_SEQ_DECONV:
            conv(f"{t}.{layer}.0", f"{f}/{layer}", 2, transposed=True)
            bn(f"{t}.{layer}.1", f"{f}/{layer}/{_NA}")
    for i in range(3):
        t, f = f"cost_regularization.{i}", f"cost_reg_stage{i + 1}"
        for j in range(7):
            block(f"{t}.conv{j}", f"{f}/Conv3dBlock_{j}", 3)
        for k, name in enumerate(("conv7", "conv9", "conv11")):
            block(f"{t}.{name}", f"{f}/Deconv3dBlock_{k}", 3, transposed=True)
        conv(f"{t}.prob", f"{f}/prob", 3)
        if adaptive:
            for j in range(2):
                block(f"DepthNet.weight_net.{i}.w_net.{j}",
                      f"agg_weight_stage{i + 1}/Conv3dBlock_{j}", 3)
    return rows


def load(path: str, adaptive: bool, geo_fusion: bool, device="cpu"):
    """(params, buffers): {name: fp32 tensor} on ``device``. The buffers
    are the running statistics. The checkpoint's keys of modules this
    configuration lacks are left unread; a key the table names and the
    checkpoint lacks raises."""
    with np.load(path) as npz:
        flat = {k: npz[k] for k in npz.files}
    params, buffers = {}, {}
    for tname, fkey, perm in table(adaptive, geo_fusion):
        arr = np.asarray(flat[fkey], dtype=np.float32)
        if perm is not None:
            arr = arr.transpose(perm)
        dest = buffers if fkey.startswith("batch_stats/") else params
        dest[tname] = torch.tensor(np.ascontiguousarray(arr), device=device)
    return params, buffers
