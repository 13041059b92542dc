"""The test CLI end to end on the CPU against the JAX package: one
synthetic scene (128x160, 3 views) exported by the JAX exporter, depth
inference with the trained weights of weights/bench_ckpt.npz (ndepths
16/8/8, fp32) through JAX's DepthRunner + save_scene_depth and through
``python -m damvsnet_tpu_torch.cli.test --device cpu``, then dypcd fusion.

Every depth and confidence file agrees to 1e-4 (the cascade's tolerance,
tests/test_fused_costvol.py:225), the cams and images are the same files,
and the PLY counts agree to 1 %. The photo-mask triplet is the synthetic
e2e run's (scripts/e2e_synthetic.py: 0.1, 0.15, 0.5): these weights give
final confidences near 0.52 here, under the DTU default's 0.9."""
import filecmp
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from damvsnet_tpu.cli import test as jax_cli_test
from damvsnet_tpu.data.general_eval import GeneralEvalDataset as JEvalDataset
from damvsnet_tpu.data.synthetic import export_synthetic_scene
from damvsnet_tpu.infer.fusion_dypcd import dypcd_filter as jdypcd
from damvsnet_tpu.infer.runner import DepthRunner as JRunner
from damvsnet_tpu.infer.runner import save_scene_depth as jsave
from damvsnet_tpu.model import CascadeMVSNet as JCascade
from damvsnet_tpu_torch.cli import test as cli_test
from damvsnet_tpu_torch.core.pfm import read_pfm
from damvsnet_tpu_torch.core.ply import read_ply
from damvsnet_tpu_torch.nn.fmt import FMTWithPathway
from damvsnet_tpu_torch.utils.weights import module_table
from torch_helpers import checkpoint_trees, jax_flags_parse_alike, port_flax_flat

torch.set_num_threads(1)
pytest.importorskip("cv2")

WEIGHTS = str(Path(__file__).resolve().parent.parent / "weights" / "bench_ckpt.npz")
SCAN, H, W, VIEWS, NDEPTHS, CONF = "scan_synth", 128, 160, 3, (16, 8, 8), "0.1,0.15,0.5"


def cli_args(root, outdir, *extra):
    return ["--testpath", str(root / "data"), "--testlist", str(root / "list.txt"),
            "--outdir", str(outdir), "--device", "cpu", "--dtype", "f32",
            "--loadckpt", WEIGHTS, "--ndepths", ",".join(map(str, NDEPTHS)),
            "--num_view", str(VIEWS), "--max_h", str(H), "--max_w", str(W),
            "--conf", CONF, *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(root, JAX outdir, port outdir): both packages' depth files and
    dypcd PLYs of one scene."""
    root = tmp_path_factory.mktemp("cli")
    export_synthetic_scene(str(root / "data"), scan=SCAN, height=H, width=W, nviews=VIEWS)
    (root / "list.txt").write_text(f"{SCAN}\n")

    # as damvsnet_tpu/cli/test.py builds it on the CPU (fp32, clamped hypotheses)
    params, stats = checkpoint_trees()
    jmodel = JCascade(ndepths=NDEPTHS, cr_base_chs=(8, 8, 8), compute_dtype=jnp.float32,
                      clamp_samples=True)
    runner = JRunner(jmodel, {"params": params, "batch_stats": stats}, log_fn=lambda *a: None)
    dataset = JEvalDataset(str(root / "data"), [SCAN], "test", VIEWS, 192, 1.06,
                           max_h=H, max_w=W)
    jsave(runner, dataset, str(root / "jax"), log_fn=lambda *a: None)
    jdypcd(str(root / "data"), str(root / "jax"), [SCAN],
           conf=tuple(float(x) for x in CONF.split(",")), log_fn=lambda *a: None)

    cli_test.main(cli_args(root, root / "port", "--filter_method", "dypcd"))
    return root, root / "jax", root / "port"


def _files(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder)
                  for d, _, files in os.walk(folder) for f in files)


def test_depth_files_match_jax(runs):
    _, jax_out, port_out = runs
    _assert_same_depth_files(port_out, jax_out)


def _assert_same_depth_files(port_out, jax_out, masks=True):
    """Every depth and confidence file at 1e-4, the other files byte for
    byte; ``masks=False`` leaves out dypcd's mask PNGs (a run without it)."""
    keep = lambda names: [n for n in names if masks or not n.startswith("mask/")]
    names = keep(_files(jax_out / SCAN))
    assert names == keep(_files(port_out / SCAN))
    pfms = [n for n in names if n.endswith(".pfm")]
    # per view: depth and confidence at three stages
    assert len(pfms) == 6 * VIEWS
    for name in pfms:
        got, want = read_pfm(port_out / SCAN / name)[0], read_pfm(jax_out / SCAN / name)[0]
        assert got.shape == want.shape and bool(np.isfinite(got).all()), name
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=name)
    full = read_pfm(port_out / SCAN / "confidence" / "00000000_stage1.pfm")[0]
    assert full.shape == (H, W)  # the lower stages' confidences at full resolution
    for name in names:
        if not name.endswith(".pfm"):
            assert filecmp.cmp(port_out / SCAN / name, jax_out / SCAN / name,
                               shallow=False), name


def test_ply_count_matches_jax(runs):
    _, jax_out, port_out = runs
    got, want = read_ply(port_out / f"{SCAN}.ply")[0], read_ply(jax_out / f"{SCAN}.ply")[0]
    assert len(want) > 0
    assert abs(len(got) - len(want)) <= 0.01 * len(want)


@pytest.mark.parametrize("method", ["consistency", "none"])
def test_other_filters_run(runs, tmp_path, method):
    root = runs[0]
    cli_test.main(cli_args(root, tmp_path, "--filter_method", method))
    # per view: 6 pfm files, the cam file and the image (dypcd's mask PNGs aside)
    assert len(_files(tmp_path / SCAN)) == 8 * VIEWS
    if method == "none":
        assert not (tmp_path / f"{SCAN}.ply").exists()
    else:
        assert len(read_ply(tmp_path / f"{SCAN}.ply")[0]) > 0


@pytest.fixture(scope="module")
def fmt_runs(runs):
    """JAX's depth files of the scene with use_fmt, and the .npz both CLIs
    load: the trained checkpoint plus a seeded FMT pathway (it has none)."""
    root = runs[0]
    torch.manual_seed(0)
    fmt = {k.replace("params/", "params/fmt_pathway/", 1): v for k, v in
           port_flax_flat(FMTWithPathway(8), module_table("fmt_pathway")).items()}
    with np.load(WEIGHTS) as npz:
        np.savez(root / "fmt_ckpt.npz", **{k: npz[k] for k in npz.files}, **fmt)
    params, stats = checkpoint_trees(extra_flat=fmt)
    jmodel = JCascade(ndepths=NDEPTHS, cr_base_chs=(8, 8, 8), compute_dtype=jnp.float32,
                      clamp_samples=True, use_fmt=True)
    runner = JRunner(jmodel, {"params": params, "batch_stats": stats}, log_fn=lambda *a: None)
    dataset = JEvalDataset(str(root / "data"), [SCAN], "test", VIEWS, 192, 1.06,
                           max_h=H, max_w=W)
    jsave(runner, dataset, str(root / "jax_fmt"), log_fn=lambda *a: None)
    return root / "jax_fmt", root / "fmt_ckpt.npz"


@pytest.mark.parametrize("flags", [
    ["--use_fmt"], ["--grad_method", "undetach"], ["--use_fmt", "--grad_method", "undetach"],
], ids=["use_fmt", "undetach", "use_fmt-undetach"])
def test_variant_flags_write_jax_depth_files(runs, request, tmp_path, flags):
    """The CLI builds what the JAX CLI builds from these flags and writes
    its depth files: with --use_fmt the JAX FMT model's on the same
    weights; --grad_method only moves training's gradients, so undetached
    serving writes the default run's files."""
    root, jax_out, _ = runs
    args = cli_args(root, tmp_path, "--filter_method", "none", *flags)
    if "--use_fmt" in flags:
        jax_out, ckpt = request.getfixturevalue("fmt_runs")
        args[args.index("--loadckpt") + 1] = str(ckpt)
    model = cli_test.main(args).model
    assert model.use_fmt == ("--use_fmt" in flags)
    assert model.grad_method == ("undetach" if "undetach" in flags else "detach")
    _assert_same_depth_files(tmp_path, jax_out, masks=False)


def test_share_cr_raises_as_jax_does(runs, tmp_path):
    """One regularizer cannot take the stages' three widths: the port
    refuses --share_cr where the JAX CLI's model fails at init
    (tests/test_torch_variants.py holds JAX's failure)."""
    with pytest.raises(ValueError, match="share_cr: one CostRegNet cannot take"):
        cli_test.main(cli_args(runs[0], tmp_path, "--share_cr"))


def test_port_checkpoint_loads_the_same_weights(runs, tmp_path):
    """--loadckpt with a checkpoint of the port's training CLI (.pt, weights
    only) gives the .npz run's depth files."""
    from damvsnet_tpu_torch.model import CascadeMVSNet
    from damvsnet_tpu_torch.utils.weights import load_bench_weights
    model = load_bench_weights(CascadeMVSNet(ndepths=NDEPTHS, device="cpu"), WEIGHTS)
    torch.save({"model": model.state_dict()}, tmp_path / "ckpt_000000.pt")
    args = cli_args(runs[0], tmp_path / "out", "--filter_method", "none")
    args[args.index("--loadckpt") + 1] = str(tmp_path / "ckpt_000000.pt")
    cli_test.main(args)
    for name in ("depth_est/00000001.pfm", "confidence/00000001_stage1.pfm"):
        assert filecmp.cmp(tmp_path / "out" / SCAN / name, runs[2] / SCAN / name,
                           shallow=False), name


def test_orbax_checkpoint_raises_naming_the_converter(runs, tmp_path):
    args = cli_args(runs[0], tmp_path)
    args[args.index("--loadckpt") + 1] = str(tmp_path)
    with pytest.raises(ValueError, match="scripts/export_bench_weights.py"):
        cli_test.main(args)


def test_every_jax_flag_parses_alike():
    """Every flag of the JAX test CLI is a flag of the port's with the same
    choices, default and type, and each value parses to the same namespace
    (``--grad_method`` and ``--agg_mode`` free-form in both: the model
    raises on a value it lacks)."""
    jax_flags_parse_alike(jax_cli_test.build_parser(), cli_test.build_parser(),
                          required=("--testpath", "p", "--testlist", "l"))
