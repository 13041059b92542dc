"""The port's fusion against the JAX package's on the same depth files:
the synthetic plane scene of tests/test_fusion.py (perfect depths) and the
same scene with seeded depth noise near the vote thresholds and a few zero
depths, so that votes disagree.

  * dypcd and pcd (host numpy, copies): the same PLY, count and colours
    equal, xyz within 1e-6 relative;
  * fuse_reference_view on the CPU against JAX's fusion_tpu: masks differ
    on at most 1e-3 of pixels, depth_avg within 1e-5 relative where both
    accept (JAX's own backend test allows 1 % of points);
  * consistency_filter's PLY counts within 1 %;
  * the port's native library against its numpy path (tests/test_native.py's
    checks), built outside native/, which it leaves unchanged.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from damvsnet_tpu.infer import fusion_tpu as jfusion_tpu
from damvsnet_tpu.infer.fusion_dypcd import dypcd_filter as jdypcd
from damvsnet_tpu.infer.fusion_pcd import pcd_filter as jpcd
from damvsnet_tpu_torch import native_ext
from damvsnet_tpu_torch.core.pfm import read_pfm, write_pfm
from damvsnet_tpu_torch.core.ply import read_ply
from damvsnet_tpu_torch.infer import fusion_device
from damvsnet_tpu_torch.infer.fusion_dypcd import (check_geometric_consistency, dypcd_filter,
                                                   read_camera_parameters)
from damvsnet_tpu_torch.infer.fusion_pcd import pcd_filter
from test_fusion import synthetic_scene  # noqa: F401  (the JAX tests' scene)

torch.set_num_threads(1)
pytest.importorskip("cv2")
QUIET = dict(log_fn=lambda *a: None)


@pytest.fixture(scope="module", params=["clean", "noisy"])
def scene(request, synthetic_scene, tmp_path_factory):  # noqa: F811
    """The clean scene, or a copy whose depths carry seeded noise of about
    the vote thresholds (relative 1.5e-3 .. 7.7e-3) and a few zero depths."""
    s = synthetic_scene
    if request.param == "clean":
        return s
    root = tmp_path_factory.mktemp("noisy")
    shutil.copytree(s["data"], root / "data")
    shutil.copytree(s["out"] / s["scan"], root / "out" / s["scan"])
    rs = np.random.default_rng(11)
    for name in sorted(os.listdir(root / "out" / s["scan"] / "depth_est")):
        path = root / "out" / s["scan"] / "depth_est" / name
        depth = read_pfm(path)[0]
        depth = depth * (1 + 0.0025 * rs.standard_normal(depth.shape)).astype(np.float32)
        depth[rs.random(depth.shape) < 0.01] = 0.0
        write_pfm(path, np.ascontiguousarray(depth, np.float32))
    return {**s, "root": root, "data": root / "data", "out": root / "out"}


def _ply(s):
    return read_ply(s["out"] / f"{s['scan']}.ply")


@pytest.mark.parametrize("method", ["dypcd", "pcd"])
def test_host_fusion_matches_jax(scene, method):
    s = scene
    args = (str(s["data"]), str(s["out"]), [s["scan"]])
    if method == "dypcd":
        jdypcd(*args, **QUIET)
        want = _ply(s)
        dypcd_filter(*args, **QUIET)
    else:
        jpcd(*args, thres_view=2, dtu_naming=False, **QUIET)
        want = _ply(s)
        pcd_filter(*args, thres_view=2, dtu_naming=False, **QUIET)
    got = _ply(s)
    assert len(got[0]) == len(want[0]) > 0
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])


def _views(s):
    folder = s["out"] / s["scan"]
    views = []
    for v in range(3):
        intr, ext = read_camera_parameters(folder / "cams" / f"{v:0>8}_cam.txt")
        views.append((read_pfm(folder / "depth_est" / f"{v:0>8}.pfm")[0], intr, ext))
    return views


@pytest.mark.parametrize("num_consistent", [None, 1])
def test_fuse_reference_view_matches_jax(scene, num_consistent):
    views = _views(scene)
    for ref in range(3):
        srcs = [views[v] for v in range(3) if v != ref]
        args = (views[ref][0], views[ref][1], views[ref][2],
                *(np.stack([x[i] for x in srcs]) for i in range(3)))
        want_mask, want_depth = jfusion_tpu.fuse_reference_view(
            *args, num_consistent=num_consistent)
        got_mask, got_depth = fusion_device.fuse_reference_view(
            *args, num_consistent=num_consistent, device="cpu")
        assert got_mask.dtype == bool and got_mask.shape == want_mask.shape
        assert (got_mask != want_mask).mean() <= 1e-3
        both = got_mask & want_mask
        assert both.sum() > 0
        np.testing.assert_allclose(got_depth[both], want_depth[both], rtol=1e-5)


def test_zero_reference_depth_fails_every_threshold(scene):
    views = _views(scene)
    depth = views[0][0].copy()
    depth[:4] = 0.0
    terms = fusion_device.camera_terms(views[0][1], views[0][2], views[1][1][None],
                                       views[1][2][None])
    t = [torch.as_tensor(np.ascontiguousarray(a, np.float32)) for a in
         (depth, views[0][1], views[1][0][None], views[1][1][None])]
    masks, final, reproj = fusion_device.consistency_masks(*t, terms, 0.25, 1.0 / 1300)
    assert not bool(masks[:, :, :4].any())
    assert not bool(reproj[:, :4].any())
    assert bool(masks[:, :, 4:].any())


def test_consistency_filter_matches_jax(scene):
    s = scene
    args = (str(s["data"]), str(s["out"]), [s["scan"]])
    jfusion_tpu.consistency_filter(*args, **QUIET)
    want = _ply(s)
    fusion_device.consistency_filter(*args, device="cpu", **QUIET)
    got = _ply(s)
    assert abs(len(got[0]) - len(want[0])) <= 0.01 * len(want[0])


def test_gipuma_filter_runs(scene, tmp_path):
    from damvsnet_tpu_torch.infer.gipuma_bridge import (gipuma_filter, mvsnet_to_gipuma,
                                                        read_gipuma_dmb)
    s = scene
    gipuma_filter(str(s["data"]), str(s["out"]), [s["scan"]], num_consistent=1,
                  device="cpu", **QUIET)
    assert len(_ply(s)[0]) > 0
    mvsnet_to_gipuma(str(s["out"] / s["scan"]), str(s["out"] / s["scan"]), str(tmp_path))
    dmb = read_gipuma_dmb(tmp_path / "2333_00000000" / "disp.dmb")
    assert dmb.shape == (s["h"], s["w"])


def test_native_matches_numpy_and_builds_outside_native(rng):
    """The port's library from native/fusion.cpp against the port's numpy
    path (tests/test_native.py's checks); the JAX package's committed
    library keeps its bytes and mtime."""
    committed = os.path.join(os.path.dirname(native_ext._SRC), "libdamvsnet_native.so")
    before = (os.stat(committed).st_mtime_ns, open(committed, "rb").read())
    lib = native_ext.get_lib()
    if lib is None:
        pytest.skip("g++ could not build native/fusion.cpp")
    path = native_ext.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(os.path.abspath(path)) != os.path.dirname(committed)

    from test_native import _scene_pair
    intr, exts, depths = _scene_pair(rng)
    want_masks, want_final, want_reproj, _, _ = check_geometric_consistency(
        depths[0], intr, exts[0], depths[1], intr, exts[1])
    masks, final, reproj = native_ext.dypcd_consistency_native(
        depths[0], intr, exts[0], depths[1], intr, exts[1])
    for t in range(9):
        assert (masks[t] == want_masks[t]).mean() > 0.99, t
    valid = want_final & final
    np.testing.assert_allclose(reproj[valid], want_reproj[valid], rtol=1e-3, atol=1e-3)

    from damvsnet_tpu_torch.eval.dtu_eval import nn_distances
    a = (rng.random((500, 3)) * 50).astype(np.float32)
    b = (rng.random((300, 3)) * 50).astype(np.float32)
    np.testing.assert_allclose(native_ext.grid_nn_distances(a, b), nn_distances(a, b),
                               rtol=1e-4, atol=1e-4)
    assert native_ext.grid_nn_distances(np.zeros((1, 3), np.float32),
                                        np.array([[500.0, 0, 0]], np.float32))[0] == 60.0
    pts = (rng.random((3000, 3)) * 10).astype(np.float32)
    kept = native_ext.reduce_points_native(pts, dst=0.5)
    assert 0 < len(kept) < len(pts)
    from scipy.spatial import cKDTree
    assert cKDTree(kept).query(kept, k=2)[0][:, 1].min() >= 0.5 - 1e-5
    assert (os.stat(committed).st_mtime_ns, open(committed, "rb").read()) == before


def test_card_vs_cpu_fusion_check_refuses_a_planted_vote_error(synthetic_scene):  # noqa: F811
    """chip_smoke.py's ``fusion_errors`` (phases 13 and 24) with the device
    under test on the CPU, on the plane scene with four sources (views 1
    and 2 twice) under seeded depth noise of about the vote thresholds.
    The same fusion passes with nothing excused. A planted source-vote
    error, the relative-depth threshold 10 % wider, flips votes far from any
    threshold: it is refused at FUSION_MARGIN_ULPS and excused only when
    the margin is widened to cover it."""
    import chip_smoke
    views = _views(synthetic_scene)
    rs = np.random.default_rng(5)

    def noisy(depth):
        return (depth * (1 + 0.0025 * rs.standard_normal(depth.shape))).astype(np.float32)
    srcs = [views[1], views[2], views[1], views[2]]
    args = (noisy(views[0][0]), views[0][1], views[0][2],
            np.stack([noisy(d) for d, _, _ in srcs]),
            np.stack([k for _, k, _ in srcs]), np.stack([e for _, _, e in srcs]))
    dist_base, rel_diff_base, _ = chip_smoke.fusion_thresholds()
    want = fusion_device.fuse_reference_view(*args, device="cpu")
    cpu_votes = chip_smoke.source_votes(args, "cpu")
    differ, d_rel, excused = chip_smoke.fusion_errors(args, want, want, lambda: cpu_votes)
    assert not differ.any() and d_rel.max() == 0 and excused == 0

    wider = 1.1 * rel_diff_base
    got = fusion_device.fuse_reference_view(*args, rel_diff_base=wider, device="cpu")
    terms = fusion_device.camera_terms(*args[1:3], *args[4:6])
    t = [torch.as_tensor(np.ascontiguousarray(a, np.float32)) for a in
         (args[0], args[1], args[3], args[4])]
    got_votes = fusion_device.consistency_masks(*t, terms, dist_base, wider)[1].numpy()
    both_flipped = (got[0] & want[0] & (got_votes != cpu_votes).any(0)).sum()
    assert both_flipped > 0
    differ, d_rel, excused = chip_smoke.fusion_errors(args, got, want, lambda: got_votes)
    assert d_rel.max() > chip_smoke.FUSION_DEPTH_RTOL and excused == 0
    differ, d_rel, excused = chip_smoke.fusion_errors(args, got, want, lambda: got_votes,
                                                      margin_ulps=1e5)
    assert d_rel.max() <= chip_smoke.FUSION_DEPTH_RTOL and excused == both_flipped
