"""The port's COLMAP converter (a copy of damvsnet_tpu/cli/colmap2mvsnet.py)
against the JAX package's on the text model of tests/test_colmap.py: the
same files, byte for byte, with a fixed and with a derived hypothesis
count."""
import filecmp
import os

import pytest

from damvsnet_tpu.cli.colmap2mvsnet import convert_scene as jconvert
from damvsnet_tpu_torch.cli import colmap2mvsnet
from test_colmap import colmap_scene  # noqa: F401  (the JAX tests' model)


@pytest.mark.parametrize("max_d", [192, 0])
def test_convert_scene_matches_jax(colmap_scene, tmp_path, max_d):  # noqa: F811
    dense, _ = colmap_scene
    quiet = dict(max_d=max_d, model_ext=".txt", log_fn=lambda *a: None)
    assert colmap2mvsnet.convert_scene(str(dense), str(tmp_path / "port"), **quiet) == 3
    jconvert(str(dense), str(tmp_path / "jax"), **quiet)
    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, files in os.walk(tmp_path / "jax") for f in files)
    assert len(names) == 3 + 1 + 3  # cams, pair.txt, images_post
    for name in names:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name,
                           shallow=False), name


def test_cli_main(colmap_scene, tmp_path):  # noqa: F811
    dense, _ = colmap_scene
    colmap2mvsnet.main(["--dense_folder", str(dense), "--save_folder", str(tmp_path / "mvs"),
                        "--model_ext", ".txt"])
    assert (tmp_path / "mvs" / "pair.txt").exists()
