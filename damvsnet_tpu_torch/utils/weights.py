"""Weight bridge: flax flat-path checkpoints -> the port's state_dict.

The port's modules carry the reference DA-MVSNet state_dict names, so a
reference PyTorch checkpoint loads with ``load_state_dict`` and the JAX
package's ``transplant_cascade(port.state_dict())`` maps the port's weights
onto JAX variables. This module is the other direction: a flax checkpoint
flattened to "params/<path>" / "batch_stats/<path>" keys (as in
``weights/bench_ckpt.npz``) becomes a state_dict for a model of the given
configuration (3 stages; by default the full serving model: geo fusion,
adaptive aggregation). The table of keys follows the configuration: no
weight-net rows in variance mode, no geo-fusion rows without it; the U-Net
widths (``cr_base_chs``) are the arrays' own, and ``load_state_dict``
checks them against the model.

Layout permutations (flax -> torch, the inverse of the JAX package's
transplant):
  Conv2d  kernel [kh, kw, I, O]       -> weight [O, I, kh, kw]
  Conv3d  kernel [kd, kh, kw, I, O]   -> weight [O, I, kd, kh, kw]
  ConvT2d kernel [kh, kw, I, O]       -> weight [I, O, kh, kw]
  ConvT3d kernel [kd, kh, kw, I, O]   -> weight [I, O, kd, kh, kw]
The JAX package emulates torch's transposed convolution by flipping the
kernel itself, so a transposed kernel only transposes; the flip is torch's.
BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
running_mean/running_var; num_batches_tracked (absent in flax) is 0.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

_CONV = {2: (3, 2, 0, 1), 3: (4, 3, 0, 1, 2)}
_DECONV = {2: (2, 3, 0, 1), 3: (3, 4, 0, 1, 2)}

_GEO_SEQ_CONV = ("rgb_conv_init", "depth_conv_init")
_GEO_BASIC = ("rgb_encoder_layer1", "rgb_encoder_layer2", "rgb_encoder_layer3",
              "rgb_encoder_layer4", "rgb_encoder_layer5", "depth_layer1",
              "depth_layer2", "depth_layer3", "depth_layer4", "depth_layer5")
_GEO_SEQ_DECONV = ("rgb_decoder_layer4", "rgb_decoder_layer2",
                   "rgb_decoder_layer0", "rgb_decoder_layer",
                   "rgb_decoder_output", "decoder_layer3", "decoder_layer4",
                   "decoder_layer5", "decoder_layer6", "decoder_layer7",
                   "rgbdepth_decoder_stage2", "rgbdepth_decoder_stage3",
                   "final_decoder_stage2", "final_decoder_stage3")
_COSTREG_DECONV = {"conv7": "Deconv3dBlock_0", "conv9": "Deconv3dBlock_1",
                   "conv11": "Deconv3dBlock_2"}


def _table(agg_mode="adaptive", use_geo_fusion=True):
    """[(torch key, flax key or None, permutation or None)] for a model of
    this configuration. A None flax key marks num_batches_tracked."""
    rows = []

    def conv(tkey, fpath, nd, bias=False):
        rows.append((f"{tkey}.weight", f"params/{fpath}/kernel", _CONV[nd]))
        if bias:
            rows.append((f"{tkey}.bias", f"params/{fpath}/bias", None))

    def deconv(tkey, fpath, nd):
        rows.append((f"{tkey}.weight", f"params/{fpath}/kernel", _DECONV[nd]))

    def bn(tkey, fpath):
        f = f"{fpath}/_NormAct_0/BatchNorm_0"
        rows.extend([(f"{tkey}.weight", f"params/{f}/scale", None),
                     (f"{tkey}.bias", f"params/{f}/bias", None),
                     (f"{tkey}.running_mean", f"batch_stats/{f}/mean", None),
                     (f"{tkey}.running_var", f"batch_stats/{f}/var", None),
                     (f"{tkey}.num_batches_tracked", None, None)])

    def block(tkey, fpath, nd, transposed=False):
        if transposed:
            deconv(f"{tkey}.conv", fpath, nd)
        else:
            conv(f"{tkey}.conv", f"{fpath}/Conv_0", nd)
        bn(f"{tkey}.bn", fpath)

    idx = 0
    for name, n in (("conv0", 2), ("conv1", 3), ("conv2", 3)):
        for j in range(n):
            block(f"feature.{name}.{j}", f"feature/Conv2dBlock_{idx}", 2)
            idx += 1
    for name in ("out1", "out2", "out3"):
        conv(f"feature.{name}", f"feature/{name}", 2)
    for name in ("inner1", "inner2"):
        conv(f"feature.{name}", f"feature/{name}", 2, bias=True)

    g, p = "GeoFeatureFusionNet", "geo_fusion"
    if use_geo_fusion:
        for layer in _GEO_SEQ_CONV:
            conv(f"{g}.{layer}.0", f"{p}/{layer}/Conv_0", 2)
            bn(f"{g}.{layer}.1", f"{p}/{layer}")
        for layer in _GEO_BASIC:
            for tconv, tbn, fsub in (("conv1", "bn1", "conv1"),
                                     ("conv2", "bn2", "conv2"),
                                     ("downsample.0", "downsample.1", "downsample")):
                conv(f"{g}.{layer}.{tconv}", f"{p}/{layer}/{fsub}/Conv_0", 2)
                bn(f"{g}.{layer}.{tbn}", f"{p}/{layer}/{fsub}")
        for layer in _GEO_SEQ_DECONV:
            deconv(f"{g}.{layer}.0", f"{p}/{layer}", 2)
            bn(f"{g}.{layer}.1", f"{p}/{layer}")

    for i in range(3):
        t, f = f"cost_regularization.{i}", f"cost_reg_stage{i + 1}"
        for j in range(7):
            block(f"{t}.conv{j}", f"{f}/Conv3dBlock_{j}", 3)
        for tname, fname in _COSTREG_DECONV.items():
            block(f"{t}.{tname}", f"{f}/{fname}", 3, transposed=True)
        conv(f"{t}.prob", f"{f}/prob", 3)
        if agg_mode == "adaptive":
            for j in range(2):
                block(f"DepthNet.weight_net.{i}.w_net.{j}",
                      f"agg_weight_stage{i + 1}/Conv3dBlock_{j}", 3)
    return rows


def state_dict_from_flax(flat: dict, agg_mode: str = "adaptive",
                         use_geo_fusion: bool = True) -> dict:
    """Flax flat-path arrays -> the state_dict (CPU tensors) of a model of
    this configuration.

    Raises if a weight of the model has no flax key, or if a flax key is
    left over."""
    remaining = dict(flat)
    sd = {}
    for tkey, fkey, perm in _table(agg_mode, use_geo_fusion):
        if fkey is None:
            sd[tkey] = torch.zeros((), dtype=torch.long)
            continue
        if fkey not in remaining:
            raise KeyError(f"flax checkpoint has no {fkey!r} (for {tkey!r})")
        arr = np.asarray(remaining.pop(fkey), dtype=np.float32)
        if perm is not None:
            arr = arr.transpose(perm)
        sd[tkey] = torch.tensor(arr)  # a copy: npz arrays are read-only
    if remaining:
        keys = sorted(remaining)
        raise ValueError(f"flax keys left over ({len(keys)}): {keys[:8]}")
    return sd


def _flax_modules(rows) -> set[str]:
    """The top-level flax modules (``feature``, ``geo_fusion``,
    ``agg_weight_stage1``, ...) that a table reads."""
    return {fkey.split("/")[1] for _, fkey, _ in rows if fkey is not None}


def load_bench_weights(model, path):
    """Load a flax flat-path .npz (e.g. weights/bench_ckpt.npz) into the
    port's model in place. The checkpoint's keys under a module that the
    model's configuration lacks (the weight nets ``agg_weight_stage*`` of a
    variance model, ``geo_fusion`` without geo fusion) are dropped, with
    one warning that says how many; otherwise strict, so a key left over on
    either side raises. Returns the model."""
    with np.load(path) as npz:
        flat = {k: npz[k] for k in npz.files}
    rows = _table(model.agg_mode, model.use_geo_fusion)
    absent = _flax_modules(_table()) - _flax_modules(rows)
    dropped = [k for k in flat if k.split("/")[1] in absent]
    for k in dropped:
        del flat[k]
    if dropped:
        warnings.warn(f"{path}: the model has no {', '.join(sorted(absent))}; dropped "
                      f"the checkpoint's {len(dropped)} keys under them", stacklevel=2)
    model.load_state_dict(state_dict_from_flax(flat, model.agg_mode, model.use_geo_fusion),
                          strict=True)
    return model
