"""The kernels' launch seam on the CPU (``ops/kernels/_common.py`` ``Entry``
and ``counts``, ``build.sources``, ``csrc/common.cuh``): every source has a
counted wrapper, every entry's declared argument types match its C
signature, ``MAX_VIEWS`` is the header's ``kMaxViews``, and an entry is
bound once however often it launches (a stub library stands in for the
card's)."""
import ctypes
import re
import types

import pytest
import torch

from damvsnet_tpu_torch.ops import kernels
from damvsnet_tpu_torch.ops.kernels import _common, build

COUNTED = {fn.__name__: fn for fn in kernels.COUNTED}


@pytest.mark.parametrize("source", build.sources())
def test_every_source_has_a_counted_wrapper(source):
    assert source in {fn.entry.library for fn in kernels.COUNTED}


@pytest.mark.parametrize("name", COUNTED)
def test_counted_wrapper_has_a_counter(name):
    fn = COUNTED[name]
    assert isinstance(fn.launches, int) and fn.entry.wrapper is fn


def _ctype(param: str):
    """The ctypes type a C parameter ("const void* const* src_ptrs") is
    passed as."""
    decl = param.rsplit(None, 1)[0]
    if "*" in decl:
        return ctypes.POINTER(ctypes.c_void_p) if decl.count("*") == 2 else ctypes.c_void_p
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}[decl]


@pytest.mark.parametrize("name", COUNTED)
def test_argtypes_match_the_c_signature(name):
    """What ``Entry`` sets as ``argtypes``, the stream included, against
    the entry point's declaration in its source."""
    entry = COUNTED[name].entry
    text = (build.CSRC / f"{entry.library}.cu").read_text()
    found = re.search(rf'extern "C" int {entry.symbol}\(([^)]*)\)', text)
    assert found, f"no entry point {entry.symbol} in {entry.library}.cu"
    params = [" ".join(p.split()) for p in found.group(1).split(",")]
    assert params[-1] == "void* stream"
    assert entry.argtypes == [_ctype(p) for p in params]


def test_max_views_is_the_headers():
    text = (build.CSRC / "common.cuh").read_text()
    assert re.findall(r"constexpr int kMaxViews = (\d+);", text) == [str(_common.MAX_VIEWS)]
    assert not any(re.search(r"\bkMaxViews\s*=", p.read_text())
                   for p in build.CSRC.glob("*.cu"))


class _StubFunction:
    """A foreign function that counts how often its argument types are set
    and returns ``err``."""

    def __init__(self, err=0):
        self.typed, self.calls, self.err = 0, [], err

    def __setattr__(self, key, value):
        if key == "argtypes":
            object.__setattr__(self, "typed", self.typed + 1)
        object.__setattr__(self, key, value)

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


def _stub_entry(monkeypatch, err=0):
    fn, loads = _StubFunction(err), []
    monkeypatch.setattr(build, "load", lambda name: loads.append(name)
                        or types.SimpleNamespace(stub_launch=fn))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=1234))
    entry = _common.Entry("stub", "stub_launch", _common.VP, _common.INT)

    @_common.counts(entry)
    def stub_wrapper():
        pass
    return entry, stub_wrapper, fn, loads


def test_entry_binds_once(monkeypatch):
    entry, wrapper, fn, loads = _stub_entry(monkeypatch)
    entry.launch("cuda", 17, 3)
    entry.launch("cuda", 19, 4)
    assert loads == ["stub"] and fn.typed == 1
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    assert fn.calls == [(17, 3, 1234), (19, 4, 1234)] and wrapper.launches == 2


def test_entry_raises_on_a_cuda_error(monkeypatch):
    entry, wrapper, _, _ = _stub_entry(monkeypatch, err=700)
    with pytest.raises(RuntimeError, match="stub_wrapper: kernel launch failed .* error 700"):
        entry.launch("cuda", 17, 3)
    assert wrapper.launches == 1
