"""The port's host IO and training loaders against the JAX package's, on
the same files: pfm, pair and cam-file round trips across the two
packages, the Sobel edges and BlendedMVS's augmentations under one seed,
and the DTU and BlendedMVS samples on the fake trees the JAX data tests
write (tests/test_data.py), equal array for array. Without cv2 or PIL a
loader raises the ImportError that names the package."""
import sys

import numpy as np
import pytest

from damvsnet_tpu.core import cameras as jcameras
from damvsnet_tpu.core import pairs as jpairs
from damvsnet_tpu.core import pfm as jpfm
from damvsnet_tpu.data import find_dataset_def as jfind
from damvsnet_tpu.data.common import color_jitter as jjitter
from damvsnet_tpu.data.common import motion_blur as jblur
from damvsnet_tpu.data.edges import sobel_edges as jsobel
from damvsnet_tpu_torch.core import cameras, pairs, pfm
from damvsnet_tpu_torch.data import (BlendedMVSDataset, DTUTrainDataset, GeneralEvalDataset,
                                     SyntheticDataset, TnTEvalDataset, find_dataset_def)
from damvsnet_tpu_torch.data.common import color_jitter, motion_blur
from damvsnet_tpu_torch.data.edges import sobel_edges
from test_data import fake_blendedmvs, fake_dtu  # noqa: F401  (the JAX tests' trees)


def assert_samples_equal(got, want, path="sample"):
    assert set(got) == set(want), path
    for k, v in want.items():
        if isinstance(v, dict):
            assert_samples_equal(got[k], v, f"{path}/{k}")
        else:
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, f"{path}/{k}"
            np.testing.assert_array_equal(got[k], v, err_msg=f"{path}/{k}")


def test_registry():
    assert find_dataset_def("dtu_yao") is DTUTrainDataset
    assert find_dataset_def("dtu") is DTUTrainDataset
    assert find_dataset_def("blendedmvs") is BlendedMVSDataset
    assert find_dataset_def("synthetic") is SyntheticDataset
    assert find_dataset_def("general_eval") is GeneralEvalDataset
    assert find_dataset_def("tnt_eval_trans") is TnTEvalDataset


@pytest.mark.parametrize("shape", [(7, 9), (7, 9, 3)])
def test_pfm_round_trips_across_packages(tmp_path, rng, shape):
    img = rng.standard_normal(shape).astype(np.float32)
    for write, read in ((pfm.write_pfm, jpfm.read_pfm), (jpfm.write_pfm, pfm.read_pfm),
                        (pfm.write_pfm, pfm.read_pfm)):
        path = tmp_path / "x.pfm"
        write(path, img, scale=2.0)
        data, scale = read(path)
        np.testing.assert_array_equal(data, img)
        assert scale == 2.0
    with pytest.raises(ValueError):
        pfm.write_pfm(tmp_path / "y.pfm", img.astype(np.float64))


def test_pair_and_cam_files_round_trip_across_packages(tmp_path, rng):
    pair_list = [(0, [1, 2]), (1, [0]), (2, [])]
    pairs.write_pair_file(tmp_path / "a.txt", pair_list, scores=[[9.5, 3.25], [1.0], []])
    jpairs.write_pair_file(tmp_path / "b.txt", pair_list, scores=[[9.5, 3.25], [1.0], []])
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    want = [(0, [1, 2]), (1, [0])]  # a reference with no sources is skipped
    assert pairs.read_pair_file(tmp_path / "b.txt") == jpairs.read_pair_file(
        tmp_path / "a.txt") == want

    intr = rng.random((3, 3)).astype(np.float32)
    ext = rng.random((4, 4)).astype(np.float32)
    cameras.write_cam_file(tmp_path / "c.txt", intr, ext, 425.0, 2.5, 192, 906.0)
    jcameras.write_cam_file(tmp_path / "d.txt", intr, ext, 425.0, 2.5, 192, 906.0)
    assert (tmp_path / "c.txt").read_text() == (tmp_path / "d.txt").read_text()
    for kw in ({}, {"interval_scale": 1.06}, {"interval_scale": 1.06, "ndepths": 128}):
        got = cameras.read_cam_file(tmp_path / "d.txt", **kw)
        want = jcameras.read_cam_file(tmp_path / "c.txt", **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_edges_and_augmentations_match(rng):
    img = (255 * rng.random((24, 32, 3))).astype(np.float32)
    np.testing.assert_array_equal(sobel_edges(img / 255.0), jsobel(img / 255.0))
    np.testing.assert_array_equal(sobel_edges(img[..., 0] / 255.0), jsobel(img[..., 0] / 255.0))
    for seed in range(6):  # several draws of the blur's direction and size
        ours, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(motion_blur(color_jitter(img, ours), ours),
                                      jblur(jjitter(img, theirs), theirs))


def test_dtu_samples_equal_jax(fake_dtu):  # noqa: F811
    root, listfile = fake_dtu
    args = (str(root), str(listfile), "train", 3)
    ours = find_dataset_def("dtu_yao")(*args, ndepths=192, interval_scale=1.06)
    theirs = jfind("dtu_yao")(*args, ndepths=192, interval_scale=1.06)
    assert ours.metas == theirs.metas and len(ours) == 21
    for idx in (0, 9, 20):  # other references, source orders and lights
        assert_samples_equal(ours[idx], theirs[idx], f"dtu[{idx}]")


@pytest.mark.parametrize("mode", ["train", "val"])
def test_blendedmvs_samples_equal_jax(fake_blendedmvs, mode):  # noqa: F811
    """In training the jitter and the blur draw from the dataset's own
    generator, seeded alike in both: equal samples, read in the same order."""
    root, listfile = fake_blendedmvs
    args = (str(root), str(listfile), mode, 3)
    ours = find_dataset_def("blendedmvs")(*args, ndepths=128, interval_scale=1.06, seed=4)
    theirs = jfind("blendedmvs")(*args, ndepths=128, interval_scale=1.06, seed=4)
    assert ours.metas == theirs.metas and len(ours) == 3
    for idx in range(len(ours)):
        assert_samples_equal(ours[idx], theirs[idx], f"blendedmvs[{idx}]")


@pytest.mark.parametrize("missing", ["cv2", "PIL"])
@pytest.mark.parametrize("tree,cls", [("fake_dtu", DTUTrainDataset),
                                      ("fake_blendedmvs", BlendedMVSDataset)])
def test_loaders_name_a_missing_package(request, monkeypatch, tree, cls, missing):
    """The dataset builds (its list needs neither package); a sample raises
    the ImportError that names the missing one, and gives nothing without
    the read or the resize."""
    root, listfile = request.getfixturevalue(tree)
    ds = cls(str(root), str(listfile), "train", 3)
    monkeypatch.setitem(sys.modules, missing, None)
    with pytest.raises(ImportError, match=missing):
        ds[0]
