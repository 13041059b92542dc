"""The weight bridge between the JAX package's flax checkpoints and the
port's state_dict (reference DA-MVSNet names)."""
import os

import numpy as np
import pytest
import torch

import jax

from damvsnet_tpu.utils.transplant import transplant_cascade
from damvsnet_tpu_torch.model import CascadeMVSNet
from damvsnet_tpu_torch.utils.weights import (load_bench_weights, save_bench_weights,
                                              state_dict_from_flax)

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "weights", "bench_ckpt.npz")
# the reference constructs two stage-1 geo-fusion heads that never run; the
# port and the JAX package omit them, transplant_cascade still reads them
DEAD_GEO_HEADS = ("rgbdepth_decoder_stage1", "final_decoder_stage1")


def _flat(variables):
    leaves = jax.tree_util.tree_flatten_with_path(variables)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in leaves}


@pytest.fixture(scope="module")
def ckpt():
    with np.load(CKPT) as npz:
        return {k: npz[k] for k in npz.files}


@pytest.fixture(scope="module")
def loaded_model():
    return load_bench_weights(CascadeMVSNet(device="cpu"), CKPT)


def test_bench_ckpt_loads_every_key(ckpt, loaded_model):
    """Every one of the checkpoint's keys lands in the full port model and
    every port weight gets one (strict load, nothing left over)."""
    assert len(ckpt) == 460
    sd = loaded_model.state_dict()
    n_bn = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) - n_bn == len(ckpt)
    np.testing.assert_array_equal(
        sd["feature.conv0.0.conv.weight"].numpy(),
        ckpt["params/feature/Conv2dBlock_0/Conv_0/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["cost_regularization.0.conv7.conv.weight"].numpy(),
        ckpt["params/cost_reg_stage1/Deconv3dBlock_0/kernel"].transpose(3, 4, 0, 1, 2))


def test_transplant_of_port_state_dict_gives_back_ckpt(ckpt, loaded_model):
    sd = {k: v.numpy() for k, v in loaded_model.state_dict().items()}
    for head in DEAD_GEO_HEADS:
        p = f"GeoFeatureFusionNet.{head}"
        sd[f"{p}.0.weight"] = np.zeros((1, 1, 1, 1), np.float32)
        for s in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{p}.1.{s}"] = np.zeros((1,), np.float32)
        sd[f"{p}.1.num_batches_tracked"] = np.zeros((), np.int64)
    back = _flat(transplant_cascade(sd))
    extra = {k for k in back if any(h in k for h in DEAD_GEO_HEADS)}
    assert set(back) - extra == set(ckpt)
    for k, v in ckpt.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_bridge_raises_on_keys_left_over(ckpt):
    with pytest.raises(ValueError, match="left over"):
        state_dict_from_flax({**ckpt, "params/feature/extra/kernel": np.zeros(1)})
    missing = dict(ckpt)
    del missing["params/cost_reg_stage2/prob/kernel"]
    with pytest.raises(KeyError, match="cost_reg_stage2/prob"):
        state_dict_from_flax(missing)


def test_variance_model_drops_exactly_the_weight_nets(ckpt, tmp_path):
    """A variance model loads bench_ckpt.npz less its agg_weight_stage*
    keys, and says so; any other key left over still raises."""
    model = CascadeMVSNet(device="cpu", agg_mode="variance")
    with pytest.warns(UserWarning, match="no agg_weight_stage1, agg_weight_stage2, "
                      "agg_weight_stage3; dropped the checkpoint's 30 keys"):
        load_bench_weights(model, CKPT)
    sd = model.state_dict()
    assert not any(k.startswith("DepthNet") for k in sd)
    n_agg = sum("/agg_weight_stage" in k for k in ckpt)
    assert n_agg == 30
    assert len(sd) - sum(k.endswith("num_batches_tracked") for k in sd) == len(ckpt) - n_agg
    np.testing.assert_array_equal(
        sd["cost_regularization.2.prob.weight"].numpy(),
        ckpt["params/cost_reg_stage3/prob/kernel"].transpose(4, 3, 0, 1, 2))
    extra = tmp_path / "extra.npz"
    np.savez(extra, **ckpt, **{"params/feature/extra/kernel": np.zeros(1)})
    with pytest.raises(ValueError, match="left over"), pytest.warns(UserWarning):
        load_bench_weights(CascadeMVSNet(device="cpu", agg_mode="variance"), str(extra))


@pytest.mark.parametrize("agg_mode", ["adaptive", "variance"])
def test_model_without_geo_fusion_drops_exactly_its_keys(ckpt, agg_mode):
    """Without geo fusion the checkpoint's geo_fusion keys are dropped too,
    in one warning, and every other weight lands."""
    model = CascadeMVSNet(device="cpu", agg_mode=agg_mode, use_geo_fusion=False)
    absent = ("geo_fusion",) if agg_mode == "adaptive" else (
        "agg_weight_stage1", "agg_weight_stage2", "agg_weight_stage3", "geo_fusion")
    n_absent = sum(k.split("/")[1] in absent for k in ckpt)
    with pytest.warns(UserWarning, match=f"no {', '.join(absent)}; dropped the "
                      f"checkpoint's {n_absent} keys") as record:
        load_bench_weights(model, CKPT)
    assert len(record) == 1
    sd = model.state_dict()
    assert not any(k.startswith("GeoFeatureFusionNet") for k in sd)
    assert len(sd) - sum(k.endswith("num_batches_tracked") for k in sd) == len(ckpt) - n_absent
    np.testing.assert_array_equal(
        sd["feature.out3.weight"].numpy(),
        ckpt["params/feature/out3/kernel"].transpose(3, 2, 0, 1))


# ---- the variants' tables (use_fmt, georeg, refine, unet) ----

VARIANTS = {"use_fmt": {"use_fmt": True}, "georeg": {"reg_mode": "georeg"},
            "refine": {"refine": True}, "unet": {"arch_mode": "unet"}}


def _variant_flat(config):
    """A seeded port model of this configuration, its weights as flat flax
    variables through the table read backwards."""
    from damvsnet_tpu_torch.utils.weights import _table
    from torch_helpers import port_flax_flat
    torch.manual_seed(0)
    model = CascadeMVSNet(device="cpu", **config)
    return model, port_flax_flat(model, _table(**config))


def test_transplant_of_fmt_port_state_dict_gives_back_the_flax_variables(ckpt):
    """The checkpoint plus a seeded FMT pathway, through the bridge into an
    FMT port model and back through the JAX package's transplant_cascade
    (use_fmt=True): the same arrays, key for key."""
    _, flat = _variant_flat({"use_fmt": True})
    fmt = {k: v for k, v in flat.items() if k.split("/")[1] == "fmt_pathway"}
    assert len(fmt) == 8 * 16 + 4  # per layer 6 Dense and 2 LayerNorm, 2 arrays each
    model = CascadeMVSNet(device="cpu", use_fmt=True)
    model.load_state_dict(state_dict_from_flax({**ckpt, **fmt}, use_fmt=True), strict=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    for head in DEAD_GEO_HEADS:
        p = f"GeoFeatureFusionNet.{head}"
        sd[f"{p}.0.weight"] = np.zeros((1, 1, 1, 1), np.float32)
        for s in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{p}.1.{s}"] = np.zeros((1,), np.float32)
        sd[f"{p}.1.num_batches_tracked"] = np.zeros((), np.int64)
    back = _flat(transplant_cascade(sd, use_fmt=True))
    extra = {k for k in back if any(h in k for h in DEAD_GEO_HEADS)}
    assert set(back) - extra == set(ckpt) | set(fmt)
    for k, v in {**ckpt, **fmt}.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_table_is_strict(variant):
    """Each new configuration's table takes exactly its model's keys: the
    full set loads strictly, one missing raises KeyError, one left over
    ValueError."""
    config = VARIANTS[variant]
    model, flat = _variant_flat(config)
    sd = state_dict_from_flax(flat, **config)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    own = [k for k in flat if k.split("/")[1] in
           {"fmt_pathway", "geo_reg_stage2", "refine_network", "feature"}]
    missing = dict(flat)
    del missing[own[-1]]
    with pytest.raises(KeyError, match=own[-1]):
        state_dict_from_flax(missing, **config)
    with pytest.raises(ValueError, match="left over"):
        state_dict_from_flax({**flat, "params/cost_reg_stage9/prob/kernel": np.zeros(1)},
                             **config)


def test_seeded_modules_keep_their_init(ckpt):
    """bench_ckpt.npz has no FMT: an FMT model's load raises on the missing
    keys unless the FMT pathway is named as seeded; then it keeps its init,
    every other weight loads, and a warning names it."""
    with pytest.raises(KeyError, match="fmt_pathway"):
        load_bench_weights(CascadeMVSNet(device="cpu", use_fmt=True), CKPT)
    torch.manual_seed(0)
    model = CascadeMVSNet(device="cpu", use_fmt=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.warns(UserWarning, match="FMT_with_pathway keep their seeded initialisation"):
        load_bench_weights(model, CKPT, seeded=("FMT_with_pathway",))
    sd = model.state_dict()
    fmt = [k for k in sd if k.startswith("FMT_with_pathway.")]
    assert fmt and all(torch.equal(sd[k], init[k]) for k in fmt)
    np.testing.assert_array_equal(
        sd["feature.out3.weight"].numpy(),
        ckpt["params/feature/out3/kernel"].transpose(3, 2, 0, 1))
    with pytest.raises(ValueError, match="not modules of the model"):
        load_bench_weights(CascadeMVSNet(device="cpu"), CKPT, seeded=("FMT_with_pathway",))


# ---- the port's exporter (save_bench_weights) ----

FMT_CKPT = os.path.join(os.path.dirname(CKPT), "bench_fmt_ckpt.npz")
FMT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(CKPT)), "benchmark", "configs",
                          "damvsnet_fmt_dtu.json")


@pytest.mark.parametrize("variant", ["default", "variance"] + sorted(VARIANTS))
def test_exporter_round_trips_through_load_bench_weights(variant, tmp_path):
    """A seeded model with its BatchNorm statistics moved, exported flat and
    loaded strictly into a model of another seed: every tensor equal, so
    none keeps the second model's seeded value; the flat keys are the
    configuration's table."""
    from damvsnet_tpu_torch.utils.weights import _table, model_config
    config = {"default": {}, "variance": {"agg_mode": "variance"}}.get(variant,
                                                                       VARIANTS.get(variant))
    torch.manual_seed(0)
    model = CascadeMVSNet(device="cpu", **config)
    with torch.no_grad():
        for k, v in model.named_buffers():
            if v.dtype.is_floating_point:
                v.uniform_(0.5, 1.5)
    path = tmp_path / "flat.npz"
    flat = save_bench_weights(model, path)
    assert set(flat) == {f for _, f, _ in _table(**model_config(model)) if f is not None}
    torch.manual_seed(1)
    back = load_bench_weights(CascadeMVSNet(device="cpu", **config), path)
    want, got = model.state_dict(), back.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k


def test_bench_fmt_ckpt_is_the_configurations_and_trained():
    """weights/bench_fmt_ckpt.npz is the file damvsnet_fmt_dtu pins by
    sha256; it loads strictly into an FMT model, and training moved every
    tensor from its start: bench_ckpt.npz's values, and FMT's seeded start
    in benchmark/fmt_weights.py, the reference's writer of the file."""
    import hashlib
    import json
    from benchmark import fmt_weights
    with open(FMT_CONFIG) as f:
        cfg = json.load(f)
    with open(FMT_CKPT, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == cfg["weights_sha256"]
    assert cfg["model"]["use_fmt"] is True
    start = load_bench_weights(CascadeMVSNet(device="cpu", use_fmt=True), CKPT,
                               seeded=("FMT_with_pathway",)).state_dict()
    start.update(fmt_weights.seeded_fmt(19, "cpu"))
    trained = load_bench_weights(CascadeMVSNet(device="cpu", use_fmt=True), FMT_CKPT)
    sd = {k: v for k, v in trained.state_dict().items() if v.dtype.is_floating_point}
    assert len([k for k in sd if k.startswith("FMT_with_pathway.")]) == 8 * 16 + 4
    assert not [k for k, v in sd.items() if torch.equal(v, start[k])]
