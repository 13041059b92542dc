"""Weight bridge: flax flat-path checkpoints -> the port's state_dict.

The port's modules carry the reference DA-MVSNet state_dict names, so a
reference PyTorch checkpoint loads with ``load_state_dict`` and the JAX
package's ``transplant_cascade(port.state_dict())`` maps the port's weights
onto JAX variables (FMT included, ``use_fmt=True``). This module is the
other direction: a flax checkpoint flattened to "params/<path>" /
"batch_stats/<path>" keys (as in ``weights/bench_ckpt.npz``) becomes a
state_dict for a model of the given configuration (3 stages; by default
the full serving model: fpn, geo fusion, adaptive aggregation). The table
of keys follows the configuration: no weight-net rows in variance mode, no
geo-fusion rows without it, the FMT pathway with ``use_fmt``, GeoRegNet2d
for CostRegNet with ``reg_mode="georeg"``, RefineNet with ``refine``, the
U-Net decoder for the FPN's laterals with ``arch_mode="unet"``; the U-Net
widths (``cr_base_chs``) are the arrays' own, and ``load_state_dict``
checks them against the model. ``module_state_dict_from_flax`` does the
same for one library module (Reg2d, Hourglass3d, AggWeightNetVolume2,
PositionEncodingSuperGlue, ...) on its own variables. ``save_bench_weights``
walks the same table backwards: a port model's state to the flat layout,
so that weights the port trained load as the JAX package's do.

Layout permutations (flax -> torch, the inverse of the JAX package's
transplant):
  Conv2d  kernel [kh, kw, I, O]       -> weight [O, I, kh, kw]
  Conv3d  kernel [kd, kh, kw, I, O]   -> weight [O, I, kd, kh, kw]
  ConvT2d kernel [kh, kw, I, O]       -> weight [I, O, kh, kw]
  ConvT3d kernel [kd, kh, kw, I, O]   -> weight [I, O, kd, kh, kw]
  Conv1d  kernel [1, I, O]            -> weight [O, I, 1]
  Dense   kernel [I, O]               -> Linear weight [O, I]
The JAX package emulates torch's transposed convolution by flipping the
kernel itself, so a transposed kernel only transposes; the flip is torch's.
BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
running_mean/running_var; num_batches_tracked (absent in flax) is 0;
LayerNorm scale/bias -> weight/bias.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

_CONV = {1: (2, 1, 0), 2: (3, 2, 0, 1), 3: (4, 3, 0, 1, 2)}
_DECONV = {2: (2, 3, 0, 1), 3: (3, 4, 0, 1, 2)}
_NORM_ACT = "_NormAct_0/BatchNorm_0"

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
_GEOREG_DECONV = ("decoder_layer4", "decoder_layer3", "decoder_layer2",
                  "decoder_layer1", "decoder_layer", "prob")
_HOURGLASS_CONV = ("conv1a", "conv1b", "conv2a", "conv2b", "redir2", "redir1")
_FMT_LAYERS = 8  # layer_names ('self', 'cross') x 4


def _j(sep, *parts):
    return sep.join(p for p in parts if p)


class _Rows(list):
    """[(torch key, flax key or None, permutation or None)]; a None flax key
    marks num_batches_tracked. Keys are built from a torch prefix ``t``
    and a flax path ``f`` (without the collection)."""

    def add(self, t, f, perm=None, coll="params"):
        self.append((t, f"{coll}/{f}", perm))

    def conv(self, t, f, nd, bias=False):
        self.add(_j(".", t, "weight"), _j("/", f, "kernel"), _CONV[nd])
        if bias:
            self.add(_j(".", t, "bias"), _j("/", f, "bias"))

    def dense(self, t, f):
        self.add(_j(".", t, "weight"), _j("/", f, "kernel"), (1, 0))
        self.add(_j(".", t, "bias"), _j("/", f, "bias"))

    def layer_norm(self, t, f):
        self.add(_j(".", t, "weight"), _j("/", f, "scale"))
        self.add(_j(".", t, "bias"), _j("/", f, "bias"))

    def bn(self, t, f):
        """A BatchNorm at flax path f."""
        self.layer_norm(t, f)
        self.add(_j(".", t, "running_mean"), _j("/", f, "mean"), coll="batch_stats")
        self.add(_j(".", t, "running_var"), _j("/", f, "var"), coll="batch_stats")
        self.append((_j(".", t, "num_batches_tracked"), None, None))

    def block(self, t, f, nd, transposed=False, bn=True):
        """A JAX Conv/Deconv{2,3}dBlock at f -> the port's block at t
        (``.conv``, and ``.bn``, or the conv's bias without BN)."""
        cf = f if transposed else _j("/", f, "Conv_0")
        perm = (_DECONV if transposed else _CONV)[nd]
        self.add(_j(".", t, "conv.weight"), _j("/", cf, "kernel"), perm)
        if bn:
            self.bn(_j(".", t, "bn"), _j("/", f, _NORM_ACT))
        else:
            self.add(_j(".", t, "conv.bias"), _j("/", cf, "bias"))


def _feature(r, t, f, arch_mode="fpn"):
    idx = 0
    for name, n in (("conv0", 2), ("conv1", 3), ("conv2", 3)):
        for j in range(n):
            r.block(_j(".", t, f"{name}.{j}"), _j("/", f, f"Conv2dBlock_{idx}"), 2)
            idx += 1
    for name in ("out1", "out2", "out3"):
        r.conv(_j(".", t, name), _j("/", f, name), 2)
    if arch_mode == "unet":
        for name in ("deconv1", "deconv2"):
            r.block(_j(".", t, f"{name}.deconv"), _j("/", f, name, "Deconv2dBlock_0"), 2,
                    transposed=True)
            r.block(_j(".", t, f"{name}.conv"), _j("/", f, name, "Conv2dBlock_0"), 2)
    else:
        for name in ("inner1", "inner2"):
            r.conv(_j(".", t, name), _j("/", f, name), 2, bias=True)


def _geo_fusion(r, t, f):
    for layer in _GEO_SEQ_CONV:
        r.conv(_j(".", t, layer, "0"), _j("/", f, layer, "Conv_0"), 2)
        r.bn(_j(".", t, layer, "1"), _j("/", f, layer, _NORM_ACT))
    for layer in _GEO_BASIC:
        for tconv, tbn, fsub in (("conv1", "bn1", "conv1"), ("conv2", "bn2", "conv2"),
                                 ("downsample.0", "downsample.1", "downsample")):
            r.conv(_j(".", t, layer, tconv), _j("/", f, layer, fsub, "Conv_0"), 2)
            r.bn(_j(".", t, layer, tbn), _j("/", f, layer, fsub, _NORM_ACT))
    for layer in _GEO_SEQ_DECONV:
        r.add(_j(".", t, layer, "0.weight"), _j("/", f, layer, "kernel"), _DECONV[2])
        r.bn(_j(".", t, layer, "1"), _j("/", f, layer, _NORM_ACT))


def _fmt_pathway(r, t, f):
    """FMTWithPathway; flax's FMT layers are fmt/layer{i}, the attention
    AttentionLayer_0 (the JAX package's transplant, utils/transplant.py:115-141)."""
    for i in range(_FMT_LAYERS):
        tl, fl = _j(".", t, f"FMT.layers.{i}"), _j("/", f, f"fmt/layer{i}")
        for proj in ("query_projection", "key_projection", "value_projection",
                     "out_projection"):
            r.dense(_j(".", tl, "attention", proj), _j("/", fl, "AttentionLayer_0", proj))
        r.dense(_j(".", tl, "linear1"), _j("/", fl, "linear1"))
        r.dense(_j(".", tl, "linear2"), _j("/", fl, "linear2"))
        r.layer_norm(_j(".", tl, "norm1"), _j("/", fl, "norm1"))
        r.layer_norm(_j(".", tl, "norm2"), _j("/", fl, "norm2"))
    for name in ("dim_reduction_1", "dim_reduction_2", "smooth_1", "smooth_2"):
        r.conv(_j(".", t, name), _j("/", f, name), 2)


def _costreg(r, t, f, prob_bias=False):
    for j in range(7):
        r.block(_j(".", t, f"conv{j}"), _j("/", f, f"Conv3dBlock_{j}"), 3)
    for tname, fname in _COSTREG_DECONV.items():
        r.block(_j(".", t, tname), _j("/", f, fname), 3, transposed=True)
    r.conv(_j(".", t, "prob"), _j("/", f, "prob"), 3, bias=prob_bias)


def _reg2d(r, t, f):
    """Reg2d: CostRegNet's names, its 1x1x1 prob head with a bias."""
    _costreg(r, t, f, prob_bias=True)


def _georeg(r, t, f):
    r.block(_j(".", t, "conv_init"), _j("/", f, "conv_init"), 3)
    for k in range(1, 6):
        for sub in ("conv1", "conv2", "downsample"):
            r.block(_j(".", t, f"encoder_layer{k}", sub), _j("/", f, f"encoder_layer{k}", sub), 3)
    for name in _GEOREG_DECONV:
        r.block(_j(".", t, name), _j("/", f, name), 3, transposed=True)


def _refine(r, t, f):
    for j, name in enumerate(("conv1", "conv2", "conv3", "res")):
        r.block(_j(".", t, name), _j("/", f, f"Conv2dBlock_{j}"), 2)


def _hourglass(r, t, f):
    for name in _HOURGLASS_CONV:
        r.block(_j(".", t, name), _j("/", f, name), 3)
    for name in ("dconv2", "dconv1"):
        r.block(_j(".", t, name), _j("/", f, name), 3, transposed=True)


def _aggweight2(r, t, f):
    for name in ("conv0", "res0", "res1", "conv1"):
        r.block(_j(".", t, name), _j("/", f, name), 3)


def _superglue(r, t, f):
    for name in ("mlp0", "mlp1", "mlp_out"):
        r.conv(_j(".", t, name), _j("/", f, name), 1, bias=True)
    for name in ("bn0", "bn1"):
        r.bn(_j(".", t, name), _j("/", f, name))


# the library modules no cascade builds, each as the JAX package's module
# at the top of its own variables (no flax prefix)
_MODULES = {"feature": _feature, "fmt_pathway": _fmt_pathway, "reg2d": _reg2d,
            "georeg": _georeg, "refine": _refine, "hourglass3d": _hourglass,
            "aggweight2": _aggweight2, "superglue": _superglue}


def module_table(kind: str, **kw):
    """The rows of one module (a key of ``_MODULES``; ``feature`` takes
    ``arch_mode``) whose flax variables are its own, unprefixed."""
    r = _Rows()
    _MODULES[kind](r, "", "", **kw)
    return r


def _table(agg_mode="adaptive", use_geo_fusion=True, use_fmt=False,
           reg_mode="costreg", refine=False, arch_mode="fpn"):
    """The rows of a cascade of this configuration."""
    r = _Rows()
    _feature(r, "feature", "feature", arch_mode)
    if use_fmt:
        _fmt_pathway(r, "FMT_with_pathway", "fmt_pathway")
    if use_geo_fusion:
        _geo_fusion(r, "GeoFeatureFusionNet", "geo_fusion")
    for i in range(3):
        if reg_mode == "georeg":
            _georeg(r, f"cost_regularization.{i}", f"geo_reg_stage{i + 1}")
        else:
            _costreg(r, f"cost_regularization.{i}", f"cost_reg_stage{i + 1}")
        if agg_mode == "adaptive":
            for j in range(2):
                r.block(f"DepthNet.weight_net.{i}.w_net.{j}",
                        f"agg_weight_stage{i + 1}/Conv3dBlock_{j}", 3)
    if refine:
        _refine(r, "refine_network", "refine_network")
    return r


def model_config(model) -> dict:
    """The configuration fields of a CascadeMVSNet that the table reads."""
    return {k: getattr(model, k) for k in ("agg_mode", "use_geo_fusion", "use_fmt",
                                           "reg_mode", "refine", "arch_mode")}


def _state_dict(flat: dict, rows) -> dict:
    remaining = dict(flat)
    sd = {}
    for tkey, fkey, perm in rows:
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


def state_dict_from_flax(flat: dict, agg_mode: str = "adaptive",
                         use_geo_fusion: bool = True, **variants) -> dict:
    """Flax flat-path arrays -> the state_dict (CPU tensors) of a cascade of
    this configuration (``variants``: use_fmt, reg_mode, refine, arch_mode,
    as ``CascadeMVSNet`` takes them; there is no share_cr table, as no
    shared-regularizer model builds).

    Raises if a weight of the model has no flax key, or if a flax key is
    left over."""
    return _state_dict(flat, _table(agg_mode, use_geo_fusion, **variants))


def module_state_dict_from_flax(flat: dict, kind: str, **kw) -> dict:
    """One library module's flat-path flax variables (unprefixed) -> its
    port's state_dict, as strictly as ``state_dict_from_flax``."""
    return _state_dict(flat, module_table(kind, **kw))


def _flax_modules(rows) -> set[str]:
    """The top-level flax modules (``feature``, ``geo_fusion``,
    ``agg_weight_stage1``, ...) that a table reads."""
    return {fkey.split("/")[1] for _, fkey, _ in rows if fkey is not None}


def save_bench_weights(model, path) -> dict:
    """Write the model's state to ``path`` as a compressed .npz in the flat
    layout that ``load_bench_weights`` reads (weights/bench_ckpt.npz's:
    fp32 arrays keyed "params/<path>" / "batch_stats/<path>"): the
    configuration's table walked backwards, each layout permutation
    inverted; num_batches_tracked has no flax key and is left out. Returns
    the arrays written."""
    sd = model.state_dict()
    flat = {}
    for tkey, fkey, perm in _table(**model_config(model)):
        if fkey is None:
            continue
        arr = sd[tkey].detach().float().cpu().numpy()
        flat[fkey] = arr.transpose(np.argsort(perm)) if perm is not None else arr
    np.savez_compressed(path, **flat)
    return flat


def load_bench_weights(model, path, seeded=()):
    """Load a flax flat-path .npz (e.g. weights/bench_ckpt.npz) into the
    port's model in place. The checkpoint's keys under a module that the
    model's configuration lacks (the weight nets ``agg_weight_stage*`` of a
    variance model, ``geo_fusion`` without geo fusion, ``cost_reg_stage*``
    of a GeoReg model) are dropped, with one warning that says how many.
    ``seeded`` names top-level modules of the model (``FMT_with_pathway``,
    ``feature``, ``cost_regularization``, ``refine_network``, ...) that keep
    the weights they hold, their seeded initialisation: the checkpoint's
    keys under them are dropped too, and a second warning names them.
    Otherwise strict, so a key missing or left over on either side raises.
    Returns the model."""
    with np.load(path) as npz:
        flat = {k: npz[k] for k in npz.files}
    children = {name for name, _ in model.named_children()}
    if not set(seeded) <= children:
        raise ValueError(f"seeded modules {sorted(set(seeded) - children)} are not "
                         f"modules of the model ({sorted(children)})")
    full = _table(**model_config(model))
    rows = [r for r in full if r[0].split(".")[0] not in seeded]
    absent = _flax_modules(_table()) - _flax_modules(full)
    seeded_flax = _flax_modules(full) - _flax_modules(rows)
    for drop, what in ((absent, f"the model has no {', '.join(sorted(absent))}"),
                       (seeded_flax, f"{', '.join(seeded)} keep their seeded initialisation")):
        dropped = [k for k in flat if k.split("/")[1] in drop]
        for k in dropped:
            del flat[k]
        if dropped or (drop is seeded_flax and seeded):
            warnings.warn(f"{path}: {what}; dropped the checkpoint's {len(dropped)} keys "
                          "under them", stacklevel=2)
    result = model.load_state_dict(_state_dict(flat, rows), strict=False)
    missing = [k for k in result.missing_keys if k.split(".")[0] not in seeded]
    if missing or result.unexpected_keys:
        raise RuntimeError(f"{path}: missing {missing[:8]}, unexpected "
                           f"{result.unexpected_keys[:8]}")
    return model
