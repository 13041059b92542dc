"""The port's DTU evaluation (a copy of damvsnet_tpu/eval/dtu_eval.py)
against the JAX package's on seeded clouds: the same numpy and scipy code,
so the results are equal exactly; and the protocol cases of
tests/test_eval_dtu.py pinned by hand (the full protocol on a known grid,
MATLAB's half-away-from-zero voxel rounding)."""
import json

import numpy as np
import pytest

from damvsnet_tpu.eval import dtu_eval as jdtu
from damvsnet_tpu_torch.cli import eval_dtu as cli_eval_dtu
from damvsnet_tpu_torch.core.ply import write_ply
from damvsnet_tpu_torch.eval import dtu_eval


@pytest.mark.parametrize("dst", [0.01, 0.5])
def test_reduce_points_matches_jax(rng, dst):
    pts = rng.random((3000, 3)) * 10
    np.testing.assert_array_equal(dtu_eval.reduce_points(pts, dst, seed=4),
                                  jdtu.reduce_points(pts, dst, seed=4))


@pytest.mark.parametrize("max_dist", [60.0, 0.3])
def test_nn_distances_matches_jax(rng, max_dist):
    a, b = rng.random((400, 3)) * 5, rng.random((300, 3)) * 5
    np.testing.assert_array_equal(dtu_eval.nn_distances(a, b, max_dist),
                                  jdtu.nn_distances(a, b, max_dist))
    assert (dtu_eval.nn_distances(np.zeros((0, 3)), b) == 60.0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_evaluate_scan_matches_jax(rng, masked):
    gt = rng.random((4000, 3)) * 100
    pred = np.concatenate([gt + 0.4 * rng.standard_normal(gt.shape), gt[:50] + 300.0])
    kw = {}
    if masked:
        obs = rng.random((25, 25, 25)) > 0.3
        kw = dict(obs_mask=obs, bb=np.array([[0.0, 0, 0], [100.0, 100, 100]]), res=4.0,
                  plane=np.array([0.0, 0.0, 1.0, -20.0]))
    got = dtu_eval.evaluate_scan(pred, gt, dst=0.2, **kw)
    assert got == jdtu.evaluate_scan(pred, gt, dst=0.2, **kw)
    assert np.isfinite(got["overall"])


def test_evaluate_scan_hand_computed():
    """tests/test_eval_dtu.py:69: a 10 mm grid, the prediction 1 mm above it,
    one outlier past 20 mm and one point outside the mask volume."""
    xs, ys = np.meshgrid(np.arange(11) * 10.0, np.arange(11) * 10.0)
    stl = np.stack([xs.ravel(), ys.ravel(), np.zeros(121)], 1)
    pred = np.concatenate([stl + np.array([0.0, 0.0, 1.0]), [[50.0, 50.0, 30.0]],
                           [[500.0, 500.0, 0.0]]])
    r = dtu_eval.evaluate_scan(pred, stl, obs_mask=np.ones((23, 23, 3), bool),
                               bb=np.array([[0.0, 0.0, -5.0], [110.0, 110.0, 5.0]]),
                               res=5.0, plane=np.array([0.0, 0.0, 1.0, 1.0]), dst=0.5)
    for key in ("acc", "comp", "overall"):
        np.testing.assert_allclose(r[key], 1.0, atol=1e-6)


def test_obsmask_rounding_matches_matlab():
    """tests/test_eval_dtu.py:95: (q - bb) / res = 0.5 rounds up into the
    masked voxel, as MATLAB's round() does."""
    obs = np.zeros((2, 1, 1), bool)
    obs[1, 0, 0] = True
    r = dtu_eval.evaluate_scan(np.array([[0.5, 0.0, 0.0]]), np.zeros((1, 3)), obs_mask=obs,
                               bb=np.array([[0.0, 0.0, 0.0], [2.0, 1.0, 1.0]]), res=1.0,
                               dst=0.01)
    assert r["n_data"] == 1
    np.testing.assert_allclose(r["acc"], 0.5, atol=1e-9)


def test_cli_scores_a_scan(tmp_path, rng):
    """cli/eval_dtu.py over a DTU-layout tree: the PLY, the STL cloud and
    the ObsMask/Plane .mat files, as the JAX package's evaluate_scans reads
    them."""
    from scipy.io import savemat
    stl = rng.random((2000, 3)) * 50
    write_ply(tmp_path / "mvsnet001_l3.ply", stl + 0.3)
    (tmp_path / "Points" / "stl").mkdir(parents=True)
    (tmp_path / "ObsMask").mkdir()
    write_ply(tmp_path / "Points" / "stl" / "stl001_total.ply", stl)
    savemat(tmp_path / "ObsMask" / "ObsMask1_10.mat",
            {"ObsMask": np.ones((12, 12, 12), np.uint8),
             "BB": np.array([[0.0, 0, 0], [50.0, 50, 50]]), "Res": 5.0})
    savemat(tmp_path / "ObsMask" / "Plane1.mat", {"P": np.array([0.0, 0.0, 1.0, 1.0])})
    out = tmp_path / "scores.json"
    cli_eval_dtu.main(["--ply_dir", str(tmp_path), "--data_path", str(tmp_path),
                       "--scans", "1", "--out_json", str(out)])
    summary = json.loads(out.read_text())["summary"]
    _, want = jdtu.evaluate_scans(str(tmp_path), str(tmp_path), [1], log_fn=lambda *a: None)
    assert summary == want
    assert 0 < summary["overall"] < 1.0
