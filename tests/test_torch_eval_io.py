"""The port's eval-side host IO against the JAX package's, on the same
files: the eval loaders' samples on the fake trees of tests/test_data.py
(exactly equal: numpy, cv2 and PIL on both sides), PLY files across the two
packages, the image codec module's bytes, the nearest upsample of the
lower-stage confidences, the loader's last partial batch, and the exported
synthetic scene file for file."""
import filecmp
import os

import numpy as np
import pytest

from damvsnet_tpu.core import ply as jply
from damvsnet_tpu.data import find_dataset_def as jfind
from damvsnet_tpu.data import general_eval as jgeneral_eval
from damvsnet_tpu.data.synthetic import export_synthetic_scene as jexport
from damvsnet_tpu_torch.core import imageio, ply
from damvsnet_tpu_torch.data import find_dataset_def, general_eval
from damvsnet_tpu_torch.data.common import DataLoader
from damvsnet_tpu_torch.data.synthetic import export_synthetic_scene
from damvsnet_tpu_torch.infer.runner import upsample_nearest
from test_data import fake_eval_scene, fake_tnt_scene  # noqa: F401  (the JAX tests' trees)
from test_torch_data import assert_samples_equal

cv2 = pytest.importorskip("cv2")


@pytest.mark.parametrize("name", ["general_eval", "tnt_eval_trans"])
def test_eval_samples_match_jax(request, name):
    """Every sample of the scene, filename template included (tolerance 0)."""
    if name == "general_eval":
        root, scan = request.getfixturevalue("fake_eval_scene")
        kw = dict(max_h=864, max_w=1152)
        args = (str(root), [scan], "test", 3, 192, 1.06)
    else:
        root, scan = request.getfixturevalue("fake_tnt_scene")
        kw = {}
        args = (str(root), [scan], "test", 3, 192, 1.0)
    got_ds, want_ds = find_dataset_def(name)(*args, **kw), jfind(name)(*args, **kw)
    assert len(got_ds) == len(want_ds) == 3
    for i in range(len(want_ds)):
        assert_samples_equal(got_ds[i], want_ds[i])


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_scale_mvs_input_skips_resize_at_equal_size(monkeypatch, dtype):
    """At equal size cv2.resize returns its input unchanged, so the port's
    skip (which needs no cv2) gives the JAX package's result."""
    rs = np.random.default_rng(0)
    img = (rs.random((864, 1152, 3)) * 255).astype(dtype)
    k = np.array([[1000.0, 0, 576], [0, 1000.0, 432], [0, 0, 1]], np.float32)
    assert np.array_equal(cv2.resize(img, (1152, 864)), img)
    want_img, want_k = jgeneral_eval.scale_mvs_input(img, k, 1152, 864)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    got_img, got_k = general_eval.scale_mvs_input(img, k, 1152, 864)
    np.testing.assert_array_equal(got_img, want_img)
    np.testing.assert_array_equal(got_k, want_k)
    assert got_img.dtype == want_img.dtype


def test_ply_round_trips_across_packages(tmp_path):
    rs = np.random.default_rng(1)
    xyz = rs.standard_normal((257, 3)).astype(np.float32)
    rgb = rs.integers(0, 256, (257, 3)).astype(np.uint8)
    ply.write_ply(tmp_path / "a.ply", xyz, rgb)
    jply.write_ply(tmp_path / "b.ply", xyz, rgb)
    assert filecmp.cmp(tmp_path / "a.ply", tmp_path / "b.ply", shallow=False)
    for read, path in ((jply.read_ply, "a.ply"), (ply.read_ply, "b.ply")):
        got_xyz, got_rgb = read(tmp_path / path)
        np.testing.assert_array_equal(got_xyz, xyz)
        np.testing.assert_array_equal(got_rgb, rgb)


def test_write_rgb_bytes_match_the_jax_calls(tmp_path):
    """The depth writer's call (damvsnet_tpu/infer/runner.py:170-172) and the
    synthetic exporter's (q100, 4:4:4; data/synthetic.py:177-181), and
    read_rgb against PIL as the JAX loaders read."""
    from PIL import Image
    rs = np.random.default_rng(2)
    img = (rs.random((48, 64, 3)) * 255).astype(np.uint8)
    bgr = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    cv2.imwrite(str(tmp_path / "jax.jpg"), bgr)
    imageio.write_rgb(tmp_path / "port.jpg", img)
    assert filecmp.cmp(tmp_path / "jax.jpg", tmp_path / "port.jpg", shallow=False)
    cv2.imwrite(str(tmp_path / "jax_q.jpg"), bgr,
                [cv2.IMWRITE_JPEG_QUALITY, 100, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    imageio.write_rgb(tmp_path / "port_q.jpg", img, quality=100, chroma_444=True)
    assert filecmp.cmp(tmp_path / "jax_q.jpg", tmp_path / "port_q.jpg", shallow=False)
    np.testing.assert_array_equal(imageio.read_rgb(tmp_path / "port_q.jpg"),
                                  np.asarray(Image.open(tmp_path / "jax_q.jpg")))


def test_codecs_missing_raise_naming_the_package(monkeypatch, tmp_path):
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ImportError, match="cv2"):
        imageio.write_rgb(tmp_path / "x.jpg", np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ImportError, match="PIL"):
        imageio.read_rgb(tmp_path / "x.jpg")


@pytest.mark.parametrize("src_hw,dst_hw", [((216, 288), (432, 576)), ((216, 288), (864, 1152)),
                                           ((37, 53), (128, 160))],
                         ids=["x2", "x4", "non-integer"])
def test_upsample_nearest_matches_cv2(src_hw, dst_hw):
    img = np.random.default_rng(3).random(src_hw).astype(np.float32)
    want = cv2.resize(img, (dst_hw[1], dst_hw[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(upsample_nearest(img, dst_hw), want)


def test_loader_keeps_the_last_partial_batch():
    data = [{"x": np.full(2, i, np.float32)} for i in range(5)]
    kept = DataLoader(data, batch_size=2, num_workers=0, drop_last=False)
    assert len(kept) == 3
    assert [b["x"].shape[0] for b in kept.iter_epoch(0)] == [2, 2, 1]
    assert len(DataLoader(data, batch_size=2)) == 2


def test_exported_scene_matches_jax(tmp_path):
    """The same files: pfm and gt_points.npy bit for bit, cams and pair.txt
    text equal, JPEG bytes equal."""
    kw = dict(scan="scan3", height=64, width=80, nviews=3, seed=7, num_depth=48)
    got = export_synthetic_scene(str(tmp_path / "port"), **kw)
    want = jexport(str(tmp_path / "jax"), **kw)
    names = sorted(os.path.relpath(os.path.join(d, f), want)
                   for d, _, files in os.walk(want) for f in files)
    assert len(names) == 3 * 3 + 2
    assert names == sorted(os.path.relpath(os.path.join(d, f), got)
                           for d, _, files in os.walk(got) for f in files)
    for name in names:
        assert filecmp.cmp(os.path.join(got, name), os.path.join(want, name),
                           shallow=False), name
