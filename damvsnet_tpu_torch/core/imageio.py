"""Image files: every image read and write of the port's eval loaders,
depth writer and fusion goes through ``read_rgb`` and ``write_rgb``.

The JAX package reads JPEGs with PIL and writes them with cv2 inline
(damvsnet_tpu/data/general_eval.py:91-93, infer/runner.py:170-172,
data/synthetic.py:177-181). Here the two codecs sit behind one module, each
imported where it runs, so that a machine without them still imports the
package and can swap this module's two functions for its own:
``numpy_codec`` does so with raw arrays.
"""
from __future__ import annotations

import contextlib
import importlib.util

import numpy as np


def _import(name: str):
    try:
        return __import__(name)
    except ImportError as e:
        raise ImportError(f"image files need the {name!r} package "
                          f"({'Pillow' if name == 'PIL' else 'opencv-python'}), "
                          "which is not installed") from e


def read_rgb(path) -> np.ndarray:
    """The image file at ``path`` as a uint8 [H, W, 3] RGB array (PIL, as
    damvsnet_tpu/data/general_eval.py:91-93 reads it)."""
    _import("PIL")
    from PIL import Image
    return np.asarray(Image.open(path))


def write_rgb(path, rgb: np.ndarray, quality: int | None = None,
              chroma_444: bool = False) -> None:
    """Write a uint8 [H, W, 3] RGB array with cv2.imwrite: with no options
    as damvsnet_tpu/infer/runner.py:170-172 does, with ``quality`` and
    ``chroma_444`` (4:4:4 sampling) as data/synthetic.py:177-181 does, so
    the bytes equal the JAX package's."""
    cv2 = _import("cv2")
    params = []
    if quality is not None:
        params += [cv2.IMWRITE_JPEG_QUALITY, quality]
    if chroma_444:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
    bgr = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
    if not (cv2.imwrite(str(path), bgr, params) if params else cv2.imwrite(str(path), bgr)):
        raise OSError(f"cv2.imwrite could not write {path}")


def codecs_missing() -> list[str]:
    """The codec packages (PIL to read, cv2 to write) that do not import here."""
    return [name for name in ("PIL", "cv2") if importlib.util.find_spec(name) is None]


@contextlib.contextmanager
def numpy_codec():
    """Within the block, ``read_rgb`` and ``write_rgb`` read and write raw
    uint8 arrays (``np.save``) under the same file names, for a machine
    without PIL or cv2. The files are lossless where the JPEG writer
    compresses; nothing else changes."""
    global read_rgb, write_rgb

    def read_raw(path) -> np.ndarray:
        return np.load(path)

    def write_raw(path, rgb: np.ndarray, quality: int | None = None,
                  chroma_444: bool = False) -> None:
        with open(path, "wb") as f:
            np.save(f, np.asarray(rgb, np.uint8))

    saved = read_rgb, write_rgb
    read_rgb, write_rgb = read_raw, write_raw
    try:
        yield
    finally:
        read_rgb, write_rgb = saved
