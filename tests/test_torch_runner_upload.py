"""DepthRunner's upload: the staging layout on a plain CPU buffer, the CPU
runner's per-tensor path, and, marked ``cuda`` (they skip elsewhere), the
staged path on the card against ``torch.as_tensor``'s, bitwise.

The file imports no JAX, so on a machine without it run the card's tests as
``DAMVSNET_TEST_TPU=1 python -m pytest tests/test_torch_runner_upload.py -m cuda``.
A tiny cascade: ndepths (8, 8, 8), synthetic scenes at 64x64 (64x96 for
the larger request), N=3.
"""
import numpy as np
import pytest
import torch

from damvsnet_tpu_torch.data import DataLoader, SyntheticDataset
from damvsnet_tpu_torch.infer import DepthRunner
from damvsnet_tpu_torch.infer.runner import STAGING_ALIGN, staging_layout, staging_views
from damvsnet_tpu_torch.model import CascadeMVSNet

torch.set_num_threads(1)

_RNG = np.random.default_rng(20)
LAYOUTS = {
    "request": [_RNG.random((1, 3, 64, 64, 3), dtype=np.float32),
                _RNG.random((1, 3, 2, 4, 4), dtype=np.float32),
                _RNG.random((1, 16), dtype=np.float32)],
    "mixed": [_RNG.random((5, 7)),  # float64, 280 bytes
              _RNG.integers(-9, 9, (3,), dtype=np.int64),
              np.float32(2.5) * np.ones((), np.float32),  # 0-d
              _RNG.random((2, 3)) > 0.5,
              _RNG.random((4, 1, 3)).astype(np.float16),
              np.zeros((0, 4), np.float32),
              _RNG.integers(0, 255, (257,), dtype=np.uint8)],
    "strided": [_RNG.random((6, 5), dtype=np.float32)[::-1, ::2],
                _RNG.random((4, 6), dtype=np.float32).T],
}


@pytest.fixture(autouse=True)
def no_onednn():
    """Torch's own CPU convolutions (tests/test_torch_train_loop.py)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_staging_layout_round_trips(case):
    """Every array starts at a multiple of 256 bytes, no two overlap, and
    each view of the filled buffer gives back its array's values, dtype and
    shape, as ``torch.as_tensor`` gives them."""
    host = [torch.from_numpy(np.asarray(a, order="C")) for a in LAYOUTS[case]]
    offsets, nbytes = staging_layout(host)
    ends = [o + t.numel() * t.element_size() for t, o in zip(host, offsets)]
    assert all(o % STAGING_ALIGN == 0 for o in offsets)
    assert all(e <= o for e, o in zip(ends, offsets[1:])) and ends[-1] <= nbytes
    assert nbytes - ends[-1] < STAGING_ALIGN
    buf = torch.full((nbytes + 64,), 0xAB, dtype=torch.uint8)
    for slot, t in zip(staging_views(buf, host, offsets), host):
        slot.copy_(t)
    for view, a in zip(staging_views(buf, host, offsets), LAYOUTS[case]):
        want = torch.as_tensor(a.copy())  # it refuses negative strides
        assert view.dtype == want.dtype and view.shape == want.shape
        assert torch.equal(view, want)


def _request(size=1, height=64, width=64, index=0):
    ds = SyntheticDataset(height=height, width=width, nviews=3, ndepths=16,
                          length=size * (index + 1))
    batch = list(DataLoader(ds, batch_size=size, num_workers=0).iter_epoch(0))[index]
    return {k: batch[k] for k in ("imgs", "proj_matrices", "depth_values")}


def _model(device, **kwargs):
    torch.manual_seed(0)
    return CascadeMVSNet(ndepths=(8, 8, 8), device=device, **kwargs)


@pytest.mark.parametrize("agg_mode, geo_fusion", [("adaptive", True), ("variance", False)])
def test_cpu_runner_uploads_each_input_alone(agg_mode, geo_fusion):
    """On the CPU the runner keeps one tensor an input: nothing is staged
    and no buffer is held."""
    runner = DepthRunner(_model("cpu", agg_mode=agg_mode, use_geo_fusion=geo_fusion), "cpu")
    request = _request()
    for _ in range(2):
        runner(request)
    assert runner.staged_uploads == 0 and runner.staging_grows == 0
    assert runner._pinned is None and runner._staged is None


# --- on the card -------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _runners(dev, **kwargs):
    """(the staged runner, a runner on the same model that uploads through
    ``torch.as_tensor`` as the CPU path does)."""
    model = _model(dev, compute_dtype=torch.bfloat16, **kwargs)
    staged, pageable = DepthRunner(model, dev), DepthRunner(model, dev)
    pageable._upload = lambda arrays: [pageable._tensor(a) for a in arrays]
    return staged, pageable


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], dict):
            _assert_same(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("agg_mode, geo_fusion", [("adaptive", True), ("variance", False)])
def test_staged_answers_equal_pageable(dev, agg_mode, geo_fusion):
    """(a) The staged path's answers are bitwise the pageable path's, and
    every input the model reads is a 256-byte-aligned view of the device
    buffer with ``torch.as_tensor``'s dtype and shape."""
    staged, pageable = _runners(dev, agg_mode=agg_mode, use_geo_fusion=geo_fusion)
    request = _request()
    seen = []
    hook = staged.model.register_forward_pre_hook(lambda m, args: seen.append(args))
    got = staged(request)
    hook.remove()
    _assert_same(got, pageable(request))
    assert staged.staged_uploads == 1 and staged.staging_grows == 1
    assert pageable.staged_uploads == 0
    imgs, proj, depth_values = seen[0]
    base = staged._staged.untyped_storage().data_ptr()
    for t, a in [(imgs, request["imgs"]), (depth_values, request["depth_values"])] + [
            (proj[k], request["proj_matrices"][k]) for k in request["proj_matrices"]]:
        want = torch.as_tensor(a, device=dev)
        assert t.untyped_storage().data_ptr() == base
        assert t.data_ptr() % STAGING_ALIGN == 0
        assert t.dtype == want.dtype and t.shape == want.shape and torch.equal(t, want)


@pytest.mark.cuda
def test_requests_in_a_row_get_their_own_answers(dev):
    """(b) Two different requests in a row, then the first again, each get
    their own answer, with no growth after the first; the upload stays a
    part of the dispatch."""
    staged, pageable = _runners(dev)
    first, second = _request(index=0), _request(index=1)
    want = [pageable(first), pageable(second)]
    assert not np.array_equal(want[0]["depth"], want[1]["depth"])
    for i in (0, 1, 0):
        _assert_same(staged((first, second)[i]), want[i])
    assert staged.staged_uploads == 3 and staged.staging_grows == 1
    assert 0 < staged.time_upload <= staged.time_dispatch


@pytest.mark.cuda
@pytest.mark.parametrize("larger", ["batch", "size"])
def test_larger_request_grows_the_buffers_once(dev, larger):
    """(c) A larger request after a smaller one grows the buffers once
    (``staging_grows`` 1 -> 2), a smaller one after it reuses them, and
    every answer stays the pageable path's."""
    staged, pageable = _runners(dev)
    small = _request()
    big = _request(size=2) if larger == "batch" else _request(width=96)
    _assert_same(staged(small), pageable(small))
    assert staged.staging_grows == 1
    held = staged._staged.numel()
    _assert_same(staged(big), pageable(big))
    assert staged.staging_grows == 2 and staged._staged.numel() > held
    _assert_same(staged(small), pageable(small))
    assert staged.staging_grows == 2 and staged.staged_uploads == 3


@pytest.mark.cuda
@pytest.mark.parametrize("agg_mode, geo_fusion", [("adaptive", True), ("variance", False)])
def test_answers_share_no_storage_with_the_device_buffer(dev, agg_mode, geo_fusion):
    """(d) No tensor the runner fetches (each stage's depth and confidence)
    lies in the device staging buffer, which the next request overwrites."""
    staged, _ = _runners(dev, agg_mode=agg_mode, use_geo_fusion=geo_fusion)
    outs = []
    staged.model.register_forward_hook(lambda m, args, out: outs.append(out))
    staged(_request())
    buf = staged._staged
    lo, hi = buf.data_ptr(), buf.data_ptr() + buf.numel()
    kept = [outs[0]] + [outs[0][f"stage{i}"] for i in (1, 2)]
    for part in kept:
        for key in ("depth", "photometric_confidence"):
            t = part[key]
            start = t.untyped_storage().data_ptr()
            assert start + t.untyped_storage().nbytes() <= lo or start >= hi, key
